"""The work a cell asks of the chip, counted from shapes, and the chip's peaks.

Model FLOPs are counted once, from the reference model's convolutions and
matrix products at the cell's shapes, by ``torch.utils.flop_counter`` on
the meta device: a forward, and for training the backward of the loss
(input gradients of every layer but the first, weight gradients of all;
nothing recomputed). The count is the same whatever computes the model.
The stem kernel's bytes are its inputs read once and its output written
once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from segbench import reference
from segbench.reference.train import loss_of

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the chip could take: bytes or operations over its
    peak rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def _keep_all(name, shape, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def model_flops(config: dict, batch: int, height: int, width: int, train: bool) -> int:
    """FLOPs of one forward (and with ``train`` its backward) of the
    reference model of ``config`` on a (batch, 3, height, width) input."""
    with torch.device("meta"):
        model = reference.build(config, masks=_keep_all)
        model.train(train)
        x = torch.empty(batch, 3, height, width)
        with FlopCounterMode(display=False) as counter:
            if train:
                labels = torch.zeros(batch, height, width, dtype=torch.long)
                loss_of(model(x), labels, aux_weight=0.4).backward()
            else:
                with torch.no_grad():
                    model(x)
    return counter.get_total_flops()


def stem_wgrad_bytes(n: int, h: int, w: int, c: int, co: int, k: int,
                     in_bytes: int = 2) -> int:
    """HBM bytes of the stride-2 stem conv's weight gradient: x (n, h, w, c)
    and dy (n, ho, wo, co) read once in bf16, dW (k, k, c, co) written once
    in float32."""
    ho, wo = (h + 2 * (k // 2) - k) // 2 + 1, (w + 2 * (k // 2) - k) // 2 + 1
    return in_bytes * (n * h * w * c + n * ho * wo * co) + 4 * k * k * c * co

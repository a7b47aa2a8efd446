"""Weights and batch-norm statistics from the seed, made on the device.

One generator on the device draws, in two calls, every value of a model's
state: convolution weights from He's normal (variance 2 / fan-in),
convolution biases uniform in +-1/sqrt(fan-in), batch-norm shifts 0 and
scales 1 (or the configuration's ``bn_scale`` for the batch norms whose
name ends in one of its keys: the last of each residual branch, so that
the blocks' sums do not grow the activations in eval mode), running means
normal with deviation 0.05 and running variances uniform in [0.82, 1.22]
(their reciprocal square roots average 1). The same seed, template and
scales give the same tensors, which the benchmark hands to the program and
to the reference alike.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_SALT = 0x5EB0


def make_state(template: Dict[str, torch.Tensor], seed: int, device: torch.device,
               bn_scale: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """A state dict with ``template``'s keys, shapes and dtypes (any device,
    ``meta`` included), its values drawn from ``seed`` on ``device``;
    ``bn_scale`` maps a batch norm's name suffix to its scale."""
    bn_scale = bn_scale or {}
    bn = {k[:-len("running_mean")] for k in template if k.endswith("running_mean")}
    normal, uniform = [], []  # (key, shape, scale, offset)
    out = {}
    for key, t in template.items():
        prefix, _, leaf = key.rpartition(".")
        prefix += "."
        if prefix in bn:
            if leaf == "running_mean":
                normal.append((key, t.shape, 0.05, 0.0))
            elif leaf == "running_var":
                uniform.append((key, t.shape, 0.4, 0.82))
            else:
                module = prefix[:-1]
                fill = 0.0
                if leaf == "weight":
                    fill = next((v for k, v in bn_scale.items() if module.endswith(k)), 1.0)
                out[key] = torch.full(t.shape, fill, dtype=t.dtype, device=device)
        elif leaf == "weight":
            normal.append((key, t.shape, math.sqrt(2.0 / (t[0].numel())), 0.0))
        elif leaf == "bias":
            bound = 1.0 / math.sqrt(template[prefix + "weight"][0].numel())
            uniform.append((key, t.shape, 2 * bound, -bound))
        else:
            raise ValueError(f"make_state: no rule for {key}")
    gen = torch.Generator(device=device).manual_seed(_SALT ^ int(seed))
    for draw, items in ((torch.randn, normal), (torch.rand, uniform)):
        sizes = [math.prod(shape) for _, shape, _, _ in items]
        flat = draw(sum(sizes), generator=gen, device=device)
        scale = torch.tensor([s for _, _, s, _ in items], device=device)
        offset = torch.tensor([o for _, _, _, o in items], device=device)
        counts = torch.tensor(sizes, device=device)
        flat = flat * scale.repeat_interleave(counts) + offset.repeat_interleave(counts)
        for (key, shape, _, _), part in zip(items, flat.split(sizes)):
            out[key] = part.view(shape).to(template[key].dtype)
    return {key: out[key] for key in template}

"""Serving export: a trained checkpoint as a program that reloads without the
model's code.

Counterpart of ``segtpu/serving.py``, with ``torch.export`` in place of
``jax.export``. The exported program is the whole serving computation:
a uint8 NHWC batch in, (int32 predictions NHW, float32 max-probability NHW)
out; the normalization, the forward (bf16 by default), the softmax,
the argmax and the confidence are one graph with the weights inside.
``serving.json`` beside it carries the input signature, the classes, the
palette and the normalization.

Reloading needs only torch: :func:`load_serving_artifact` imports no model
code of this package.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Tuple

import torch
from torch import nn

from segtpu_torch.ops.reductions import fast_argmax

_PROGRAM = "model.pt2"
_META = "serving.json"


class ServeModule(nn.Module):
    """uint8 NHWC batch -> (predictions int32 NHW, confidence float32 NHW).
    Counterpart of segtpu's ``build_serve_fn``.

    With a 16-bit ``compute_dtype`` (``torch.bfloat16`` or ``torch.float16``)
    the input and every weight but BatchNorm's are in it (a copy of
    ``model``), as in segtpu, whose layers ride the input's dtype while BN
    computes in fp32. The dtypes are the tensors' own, not autocast's, so
    the exported graph carries them.
    """

    def __init__(self, model: nn.Module, mean, std,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"compute_dtype must be float32, bfloat16 or float16, not "
                             f"{compute_dtype}")
        if compute_dtype != torch.float32:
            model = copy.deepcopy(model)
            for m in model.modules():
                if not isinstance(m, nn.modules.batchnorm._BatchNorm):
                    for p in m.parameters(recurse=False):
                        p.data = p.data.to(compute_dtype)
        self.model = model
        self.compute_dtype = compute_dtype
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32).view(1, -1, 1, 1))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32).view(1, -1, 1, 1))

    def logits(self, images_u8: torch.Tensor) -> torch.Tensor:
        """float32 NCHW logits of a uint8 NHWC batch."""
        x = images_u8.permute(0, 3, 1, 2).float() / 255.0
        x = ((x - self.mean) / self.std).to(self.compute_dtype)
        return self.model(x)["out"].float()

    def forward(self, images_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = torch.softmax(self.logits(images_u8), dim=1)
        return fast_argmax(probs, dim=1).to(torch.int32), probs.amax(dim=1)


def export_checkpoint(checkpoint_dir: str, output_dir: str, batch: int = 1,
                      hw: Tuple[int, int] = (513, 513), device="cuda",
                      compute_dtype: torch.dtype = torch.bfloat16) -> str:
    """Export a training checkpoint as a serving artifact for ``device``.

    Writes ``<output_dir>/model.pt2`` (``torch.export`` with the weights
    inside) and ``<output_dir>/serving.json``; returns ``output_dir``.
    """
    from segtpu_torch import resolve_device
    from segtpu_torch.checkpoint import (load_config_from_checkpoint,
                                         load_model_weights)
    from segtpu_torch.data import dataset_meta
    from segtpu_torch.models import get_model

    device = resolve_device(device)
    config = load_config_from_checkpoint(checkpoint_dir)
    if config is None:
        raise FileNotFoundError(f"{checkpoint_dir}: no meta.json, not a "
                                f"segtpu_torch checkpoint")
    mean, std, palette, num_classes = dataset_meta(config)
    model = get_model(config["arch"]["type"], device=device,
                      num_classes=num_classes, **config["arch"].get("args", {}))
    load_model_weights(checkpoint_dir, model)
    serve = ServeModule(model, mean, std, compute_dtype).to(device).eval()
    example = torch.zeros((batch, hw[0], hw[1], len(mean)), dtype=torch.uint8,
                          device=device)
    with torch.no_grad():
        program = torch.export.export(serve, (example,))
    os.makedirs(output_dir, exist_ok=True)
    torch.export.save(program, os.path.join(output_dir, _PROGRAM))
    with open(os.path.join(output_dir, _META), "w") as f:
        json.dump({
            "input": {"shape": [batch, hw[0], hw[1], len(mean)],
                      "dtype": "uint8", "layout": "NHWC"},
            "outputs": ["predictions int32 NHW", "confidence float32 NHW"],
            "num_classes": int(num_classes),
            "palette": [int(v) for v in palette],
            "mean": [float(m) for m in mean],
            "std": [float(s) for s in std],
            "arch": config["arch"],
            "platforms": [device.type],
        }, f, indent=2)
    return output_dir


def load_serving_artifact(artifact_dir: str):
    """Reload an exported artifact: returns ``(call, meta)``. ``call`` takes
    a uint8 NHWC batch of serving.json's input shape, moves it to the device
    the program was exported for and returns (predictions, confidence)."""
    program = torch.export.load(os.path.join(artifact_dir, _PROGRAM))
    with open(os.path.join(artifact_dir, _META)) as f:
        meta = json.load(f)
    module = program.module()
    device = torch.device(meta["platforms"][0])

    def call(images_u8):
        with torch.no_grad():
            return module(torch.as_tensor(images_u8, dtype=torch.uint8, device=device))

    return call, meta

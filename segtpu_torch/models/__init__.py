"""Model registry. Counterpart of ``segtpu/models/__init__.py``; PSPNet and
UperNet are the models ported so far."""

from __future__ import annotations

import torch

from segtpu_torch import resolve_device
from segtpu_torch.models.pspnet import PSPNet
from segtpu_torch.models.upernet import UperNet

MODELS = {"PSPNet": PSPNet, "UperNet": UperNet}


def get_model(name: str, *, device="cuda", seed: int = 0, **kwargs):
    """Build model ``name`` with weights drawn from ``seed`` and move it to
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``). On cuda
    the model is channels_last."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = MODELS[name](generator=gen, **kwargs).to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model

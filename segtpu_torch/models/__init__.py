"""Model registry. Counterpart of ``segtpu/models/__init__.py``, with all
twelve of its names: PSPNet, PSPDenseNet, UperNet, DeepLab (DeepLabV3+,
Xception or ResNet), DeepLab_DUC_HDC, UNet, UNetResnet, SegNet, SegResNet,
ENet, GCN and FCN8."""

from __future__ import annotations

import torch

from segtpu_torch import resolve_device
from segtpu_torch.models.deeplabv3_plus import DeepLab
from segtpu_torch.models.duc_hdc import DeepLab_DUC_HDC
from segtpu_torch.models.enet import ENet
from segtpu_torch.models.fcn import FCN8
from segtpu_torch.models.gcn import GCN
from segtpu_torch.models.pspnet import PSPDenseNet, PSPNet
from segtpu_torch.models.segnet import SegNet, SegResNet
from segtpu_torch.models.unet import UNet, UNetResnet
from segtpu_torch.models.upernet import UperNet

MODELS = {"PSPNet": PSPNet, "UperNet": UperNet, "DeepLab": DeepLab,
          "DeepLab_DUC_HDC": DeepLab_DUC_HDC, "UNet": UNet, "UNetResnet": UNetResnet,
          "SegNet": SegNet, "SegResNet": SegResNet, "ENet": ENet, "GCN": GCN,
          "FCN8": FCN8, "PSPDenseNet": PSPDenseNet}


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

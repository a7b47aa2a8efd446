"""The reference's building blocks: a convolution whose arithmetic is a
:class:`~segbench.reference.precision.Precision`, and a dropout whose masks
the benchmark hands in.

Parameter names are ``nn.Conv2d``'s (``weight``, ``bias``), so the
reference's state dict has the keys of the original repo's models.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from segbench.reference.precision import FP32, Precision

#: ``masks(name, shape, device) -> bool tensor``: the keep mask of the
#: dropout called ``name`` for an input of ``shape``
MaskSource = Callable[[str, tuple, torch.device], torch.Tensor]


class Conv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False,
                 precision: Precision = FP32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.precision = precision
        bound = 1.0 / math.sqrt(in_ch * k * k)
        nn.init.uniform_(self.weight, -bound, bound)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x):
        return self.precision.conv2d(x, self.weight, self.bias, self.stride,
                                     self.padding, self.dilation)


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """Elementwise dropout with rate ``p`` in train mode: ``x * keep / (1 -
    p)``, ``keep`` from the model's mask source under this module's name.
    The identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.name = ""
        self.masks: Optional[MaskSource] = None

    def forward(self, x):
        if not self.training:
            return x
        keep = self.masks(self.name, tuple(x.shape), x.device)
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_mask_source(model: nn.Module, masks: Optional[MaskSource]) -> None:
    """Give every :class:`Dropout` of ``model`` its qualified name and
    ``masks``."""
    for name, m in model.named_modules():
        if isinstance(m, Dropout):
            m.name, m.masks = name, masks

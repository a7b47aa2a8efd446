"""Aligned Xception backbone for DeepLabV3+ (NCHW).

Counterpart of ``segtpu/backbones/xception.py``: the entry flow (conv 32
stride 2, conv 64, blocks of 128, 256 and 728 channels with strided
residuals), a middle flow of 16 blocks at 728 channels, and the exit flow
(block20 and three separable convs to 1536, 1536 and 2048), with the
stride and dilation plan of output stride 8 or 16. The low-level features
are block1's output (128 channels).

Module names follow the original DeepLabV3+ ``Xception`` (``conv1``,
``bn1``, ``conv2``, ``bn2``, ``block{1..20}.rep.{i}``, ``.skip``,
``.skipbn``, ``conv{3,4,5}``, ``bn{3,4,5}``), so its state dicts load as they
are.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.nn.blocks import SeparableConv
from segtpu_torch.nn.layers import batch_norm, conv2d, kaiming_normal_init


def _sep(in_ch, out_ch, stride=1, dilation=1):
    return SeparableConv(in_ch, out_ch, 3, stride, dilation,
                         weight_init=kaiming_normal_init)


class XceptionBlock(nn.Module):
    """Residual stack of three separable convs, each followed by BN.

    ``exit_flow`` orders the widths (in->in, in->out, out->out), else
    (in->out, out->out, out->out); the stride is on the last conv.
    ``rep`` holds the original's layout: [ReLU, sep, BN] three times, the
    first ReLU left out when ``use_first_relu`` is False (block1).

    The original's first ReLU is in place, so it rewrites the block input
    before the skip branch reads it: whenever the block has that ReLU, the
    skip conv (or the identity) takes ``relu(x)``, not ``x``. That is kept,
    and written as ``h = relu(x)`` feeding both branches.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dilation: int = 1,
                 exit_flow: bool = False, use_first_relu: bool = True):
        super().__init__()
        if exit_flow:
            plan = [(in_ch, in_ch, 1), (in_ch, out_ch, 1), (out_ch, out_ch, stride)]
        else:
            plan = [(in_ch, out_ch, 1), (out_ch, out_ch, 1), (out_ch, out_ch, stride)]
        layers = []
        for i, (ci, co, s) in enumerate(plan):
            if i > 0 or use_first_relu:
                # the first ReLU only keeps the original's indices: forward
                # applies it to x itself
                layers.append(nn.ReLU(inplace=i > 0))
            layers += [_sep(ci, co, s, dilation), batch_norm(co)]
        self.use_first_relu = use_first_relu
        self.rep = nn.Sequential(*layers)
        self.skip = self.skipbn = None
        if in_ch != out_ch or stride != 1:
            self.skip = conv2d(in_ch, out_ch, 1, stride, weight_init=kaiming_normal_init)
            self.skipbn = batch_norm(out_ch)

    def forward(self, x):
        h = F.relu(x) if self.use_first_relu else x
        y = self.rep[1:](h) if self.use_first_relu else self.rep(h)
        skip = h if self.skip is None else self.skipbn(self.skip(h))
        return y + skip


class XceptionFeatures(nn.Module):
    """Returns ``(features, low_level)``: the 2048-channel output at
    ``output_stride`` 8 or 16, and block1's 128-channel map at stride 4."""

    def __init__(self, output_stride: int = 16, in_channels: int = 3):
        super().__init__()
        if output_stride == 16:
            b3_s, mf_d, ef_d = 2, 1, (1, 2)
        elif output_stride == 8:
            b3_s, mf_d, ef_d = 1, 2, (2, 4)
        else:
            raise ValueError(f"unsupported output_stride {output_stride}")
        self.conv1 = conv2d(in_channels, 32, 3, 2, 1, weight_init=kaiming_normal_init)
        self.bn1 = batch_norm(32)
        self.conv2 = conv2d(32, 64, 3, 1, 1, weight_init=kaiming_normal_init)
        self.bn2 = batch_norm(64)
        self.block1 = XceptionBlock(64, 128, stride=2, use_first_relu=False)
        self.block2 = XceptionBlock(128, 256, stride=2)
        self.block3 = XceptionBlock(256, 728, stride=b3_s)
        for i in range(4, 20):
            setattr(self, f"block{i}", XceptionBlock(728, 728, dilation=mf_d))
        self.block20 = XceptionBlock(728, 1024, dilation=ef_d[0], exit_flow=True)
        for i, (ci, co) in zip((3, 4, 5), ((1024, 1536), (1536, 1536), (1536, 2048))):
            setattr(self, f"conv{i}", _sep(ci, co, dilation=ef_d[1]))
            setattr(self, f"bn{i}", batch_norm(co))
        self.out_channels, self.low_level_channels = 2048, 128

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        low_level = y = self.block1(y)
        y = torch.relu(y)
        for i in range(2, 21):
            y = getattr(self, f"block{i}")(y)
        y = torch.relu(y)
        for i in (3, 4, 5):
            y = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y)))
        return y, low_level

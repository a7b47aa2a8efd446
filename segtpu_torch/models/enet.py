"""ENet, the zoo's real-time network, built from scratch.

Counterpart of ``segtpu/models/enet.py``. The initial block concatenates a
2x2 ceil-mode max pool of the input with a 3x3/2 conv to ``16 - in``
channels, then BN and a 16-slope PReLU. Each bottleneck adds a main branch
(1x1 projection to ``in // 4``, or a 2x2/2 conv where it downsamples; then
a dilated 3x3, the asymmetric 1x5 and 5x1 pair with bias, or a 3x3/2
transposed conv where it upsamples; a 1x1 expansion; BN and PReLU, or ReLU
in stages 4 and 5, after each; channel dropout) to an identity branch: the
argmax max pool where it downsamples, a 1x1 conv, BN and the unpool to the
saved size where it upsamples, zero-padded in channels where the block
widens. Where the branches' sizes differ (odd inputs), the main branch is
padded or cropped at the top and left, as the original's ``F.pad``. The
last transposed conv is cropped back to the input size.

ENet can be sharded over H (``core/spatial.py``; total stride 8): its
pools, its transposed convs (3x3/2, whose windows overlap in H), the
pad-or-crop onto the identity and the last crop then work in global rows.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``.
Parameter names follow the original (``initial.{conv,bn,prelu}``,
``bottleneckNM.*`` with its ``spatil_conv`` and the asymmetric pair at
``conv2.0``-``conv2.3``, ``prelu_out``, ``fullconv``), so
``segtpu.utils.weight_convert.convert_enet`` reads this model's
``state_dict()``. ENet has no backbone: every parameter trains at ``lr``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, conv_transpose2d,
                                    init_parameters, kaiming_normal_init)
from segtpu_torch.ops.pooling import max_pool, max_pool_argmax, max_unpool
from segtpu_torch.ops.shape import crop, pad_or_crop_tl


class InitialBlock(nn.Module):
    #: swapped per instance by core/spatial.py's shard_windows
    _max_pool = staticmethod(max_pool)

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.conv = conv2d(in_ch, 16 - in_ch, 3, 2, 1, bias=True,
                           weight_init=kaiming_normal_init)
        self.bn = batch_norm(16)
        self.prelu = nn.PReLU(16, init=0.25)

    def forward(self, x):
        y = torch.cat([self._max_pool(x, 2, 2, ceil_mode=True), self.conv(x)], dim=1)
        return self.prelu(self.bn(y))


def _act(use_prelu: bool) -> nn.Module:
    return nn.PReLU(1, init=0.25) if use_prelu else nn.ReLU(inplace=True)


class Bottleneck(nn.Module):
    #: swapped per instance by core/spatial.py's shard_windows
    _pool_argmax = staticmethod(max_pool_argmax)
    _unpool = staticmethod(max_unpool)
    _pad_or_crop = staticmethod(pad_or_crop_tl)

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, dilation: int = 1,
                 downsample: bool = False, upsample: bool = False,
                 asymmetric: bool = False, p_drop: float = 0.1,
                 use_prelu: bool = True):
        super().__init__()
        out_ch = out_ch or in_ch
        inter = in_ch // 4  # the projection ratio
        self.downsample, self.upsample = downsample, upsample
        self.pad_channels = out_ch - in_ch if out_ch > in_ch and not upsample else 0
        if upsample:
            self.spatil_conv = conv2d(in_ch, out_ch, 1)
            self.bn_up = batch_norm(out_ch)
        self.conv1 = conv2d(in_ch, inter, 2, 2) if downsample else conv2d(in_ch, inter, 1)
        self.bn1, self.prelu1 = batch_norm(inter), _act(use_prelu)
        if asymmetric:
            self.conv2 = nn.Sequential(
                conv2d(inter, inter, (1, 5), padding=(0, 2), bias=True), batch_norm(inter),
                _act(use_prelu), conv2d(inter, inter, (5, 1), padding=(2, 0), bias=True))
        elif upsample:
            self.conv2 = conv_transpose2d(inter, inter, 3, 2, 1, bias=False,
                                          output_padding=1)
        else:
            self.conv2 = conv2d(inter, inter, 3, padding=dilation, dilation=dilation)
        self.bn2, self.prelu2 = batch_norm(inter), _act(use_prelu)
        self.conv3 = conv2d(inter, out_ch, 1)
        self.bn3, self.prelu3 = batch_norm(out_ch), _act(use_prelu)
        self.regularizer = nn.Dropout2d(p_drop)
        self.prelu_out = _act(use_prelu)

    def forward(self, x, indices=None, output_size=None):
        identity, idx = x, None
        if self.upsample:
            identity = self._unpool(self.bn_up(self.spatil_conv(x)), indices, output_size)
        elif self.downsample:
            identity, idx = self._pool_argmax(x)
        if self.pad_channels:
            identity = F.pad(identity, (0, 0, 0, 0, 0, self.pad_channels))
        y = self.prelu1(self.bn1(self.conv1(x)))
        y = self.prelu2(self.bn2(self.conv2(y)))
        y = self.regularizer(self.prelu3(self.bn3(self.conv3(y))))
        y = self._pad_or_crop(y, identity.shape[-2], identity.shape[-1])
        y = self.prelu_out(y + identity)
        return (y, idx) if self.downsample else y


#: the bottlenecks of stages 2 and 3 (stage 2 downsamples first)
_STAGE = (dict(), dict(dilation=2), dict(asymmetric=True), dict(dilation=4), dict(),
          dict(dilation=8), dict(asymmetric=True), dict(dilation=16))


class ENet(FreezableBN):
    #: ENet has no backbone: every parameter is the decoder's
    backbone_modules = ()
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 8
    #: swapped per instance by core/spatial.py's shard_windows
    _crop = staticmethod(crop)

    def __init__(self, num_classes: int, in_channels: int = 3, freeze_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freeze_bn = freeze_bn
        self.initial = InitialBlock(in_channels)
        self.bottleneck10 = Bottleneck(16, 64, downsample=True, p_drop=0.01)
        for i in range(1, 5):
            setattr(self, f"bottleneck1{i}", Bottleneck(64, p_drop=0.01))
        self.bottleneck20 = Bottleneck(64, 128, downsample=True)
        for stage in (2, 3):
            for i, kw in enumerate(_STAGE):
                setattr(self, f"bottleneck{stage}{i + 1}", Bottleneck(128, **kw))
        self.bottleneck40 = Bottleneck(128, 64, upsample=True, use_prelu=False)
        self.bottleneck41 = Bottleneck(64, use_prelu=False)
        self.bottleneck42 = Bottleneck(64, use_prelu=False)
        self.bottleneck50 = Bottleneck(64, 16, upsample=True, use_prelu=False)
        self.bottleneck51 = Bottleneck(16, use_prelu=False)
        self.fullconv = conv_transpose2d(16, num_classes, 3, 2, 1, bias=False,
                                         weight_init=kaiming_normal_init,
                                         output_padding=1)
        init_parameters(self, generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        y = self.initial(x)
        size1 = y.shape[-2:]
        y, idx1 = self.bottleneck10(y)
        for i in range(1, 5):
            y = getattr(self, f"bottleneck1{i}")(y)
        size2 = y.shape[-2:]
        y, idx2 = self.bottleneck20(y)
        for stage in (2, 3):
            for i in range(1, len(_STAGE) + 1):
                y = getattr(self, f"bottleneck{stage}{i}")(y)
        y = self.bottleneck40(y, idx2, size2)
        y = self.bottleneck42(self.bottleneck41(y))
        y = self.bottleneck50(y, idx1, size1)
        y = self.bottleneck51(y)
        # the transposed conv gives one row or column too many at odd sizes:
        # segtpu keeps the top-left h x w
        return {"out": self._crop(self.fullconv(y), 0, 0, (h, w))}

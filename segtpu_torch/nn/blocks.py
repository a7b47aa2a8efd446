"""Decoder blocks. Counterpart of ``segtpu/nn/blocks.py``: the PSP pyramid
(PSPNet, UperNet) and UperNet's FPN fusion head."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from segtpu_torch.nn.layers import ConvBNAct, batch_norm, conv2d, kaiming_normal_init
from segtpu_torch.ops.pooling import adaptive_avg_pool_multi
from segtpu_torch.ops.resize import resize_bilinear


class PSPModule(nn.Module):
    """Pyramid Scene Parsing pooling module.

    Adaptive-avg-pool to each bin size, 1x1 conv+BN+ReLU, bilinear upsample
    (``align_corners=True``), concat with the input, 3x3 bottleneck
    conv+BN+ReLU, dropout(0.1). The bottleneck has ``in // len(bins)``
    output channels unless ``out_features`` is given.

    Keys follow the original ``_PSPModule``: ``stages.{i}.{1,2}`` and
    ``bottleneck.{0,1}``. Index 0 of each stage held its pool there; here
    the pools of every bin run first, in :func:`adaptive_avg_pool_multi`.
    """

    def __init__(self, in_ch: int, bin_sizes: Sequence[int] = (1, 2, 3, 6),
                 out_features: Optional[int] = None):
        super().__init__()
        self.bin_sizes = tuple(bin_sizes)
        branch_ch = in_ch // len(self.bin_sizes)
        out_ch = out_features or branch_ch
        self.stages = nn.ModuleList(
            nn.Sequential(nn.Identity(),
                          conv2d(in_ch, branch_ch, 1,
                                 weight_init=kaiming_normal_init),
                          batch_norm(branch_ch), nn.ReLU(inplace=True))
            for _ in self.bin_sizes)
        self.bottleneck = nn.Sequential(
            conv2d(in_ch + branch_ch * len(self.bin_sizes), out_ch, 3,
                   padding=1, weight_init=kaiming_normal_init),
            batch_norm(out_ch), nn.ReLU(inplace=True), nn.Dropout(0.1))

    def forward(self, x):
        size = x.shape[-2:]
        pyramids = [x]
        for stage, pooled in zip(self.stages,
                                 adaptive_avg_pool_multi(x, self.bin_sizes)):
            pyramids.append(resize_bilinear(stage(pooled), size,
                                            align_corners=True))
        return self.bottleneck(torch.cat(pyramids, dim=1))


class FPNFuse(nn.Module):
    """UperNet's FPN fusion head, finest level first, NCHW.

    1x1-project every level but the finest to ``fpn_out``, add each level's
    upsampled coarser neighbour (bilinear, ``align_corners=True``), smooth
    each merged level with its own 3x3 conv, upsample all to the finest
    resolution, concat, 3x3 conv + BN + ReLU. segtpu's two documented
    behaviours are kept:

    * the top-down adds are independent, ``P[j] = up(f[j+1]) + f[j]`` on the
      projected features, not a cascade;
    * each merged level has its own smooth conv (the original shares one),
      and the finest level gets a 1x1 projection ``lateral_p0`` when its
      width is not ``fpn_out`` (the original asserts they are equal).

    Keys follow the original ``FPN_fuse``: ``conv1x1.{i}``,
    ``smooth_conv.{i}`` and ``conv_fusion.{0,1}``; ``lateral_p0`` is outside
    that layout and exists only when the widths differ.
    """

    def __init__(self, feature_channels: Sequence[int], fpn_out: int = 256):
        super().__init__()
        n = len(feature_channels)
        self.lateral_p0 = (conv2d(feature_channels[0], fpn_out, 1, bias=True)
                           if feature_channels[0] != fpn_out else None)
        self.conv1x1 = nn.ModuleList(conv2d(ch, fpn_out, 1, bias=True)
                                     for ch in feature_channels[1:])
        self.smooth_conv = nn.ModuleList(conv2d(fpn_out, fpn_out, 3, padding=1, bias=True)
                                         for _ in range(n - 1))
        self.conv_fusion = ConvBNAct(n * fpn_out, fpn_out, 3, padding=1)

    def forward(self, features):
        feats = list(features)
        if self.lateral_p0 is not None:
            feats[0] = self.lateral_p0(feats[0])
        for i, conv in enumerate(self.conv1x1, start=1):
            feats[i] = conv(feats[i])
        merged = [resize_bilinear(feats[j + 1], feats[j].shape[-2:], align_corners=True)
                  + feats[j] for j in range(len(feats) - 1)]
        pyramid = [conv(m) for conv, m in zip(self.smooth_conv, merged)] + [feats[-1]]
        size = pyramid[0].shape[-2:]
        pyramid = [pyramid[0]] + [resize_bilinear(p, size, align_corners=True)
                                  for p in pyramid[1:]]
        return self.conv_fusion(torch.cat(pyramid, dim=1))

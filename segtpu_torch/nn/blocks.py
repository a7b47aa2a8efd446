"""Decoder blocks. Counterpart of ``segtpu/nn/blocks.py``: the separable
conv (Xception), the PSP pyramid (PSPNet, UperNet), ASPP (DeepLabV3+ and
DeepLab_DUC_HDC), UperNet's FPN fusion head and the Dense Upsampling
Convolution (DeepLab_DUC_HDC)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.nn.layers import (ConvBNAct, batch_norm, conv2d, kaiming_normal_init,
                                    torch_conv_kernel_init)
from segtpu_torch.ops.pooling import adaptive_avg_pool_multi, image_mean
from segtpu_torch.ops.resize import resize_bilinear


class SeparableConv(nn.Module):
    """Depthwise k x k conv, BN, then pointwise 1x1 conv: the Xception
    building block. The padding is ``d if d > k//2 else k//2``, and the BN
    sits between the two convs, as in the original ``SeparableConv2d``,
    whose keys these are (``conv1``, ``bn``, ``pointwise``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, bias: bool = False,
                 weight_init=torch_conv_kernel_init):
        super().__init__()
        k, d = kernel_size, dilation
        padding = d if d > k // 2 else k // 2
        self.conv1 = conv2d(in_ch, in_ch, k, stride, padding, d, bias=bias,
                            weight_init=weight_init, groups=in_ch)
        self.bn = batch_norm(in_ch)
        self.pointwise = conv2d(in_ch, out_ch, 1, bias=bias, weight_init=weight_init)

    def forward(self, x):
        return self.pointwise(self.bn(self.conv1(x)))


class PSPModule(nn.Module):
    """Pyramid Scene Parsing pooling module.

    Adaptive-avg-pool to each bin size, 1x1 conv+BN+ReLU, bilinear upsample
    (``align_corners=True``), concat with the input, 3x3 bottleneck
    conv+BN+ReLU, dropout(0.1). The bottleneck has ``in // len(bins)``
    output channels unless ``out_features`` is given.

    Keys follow the original ``_PSPModule``: ``stages.{i}.{1,2}`` and
    ``bottleneck.{0,1}``. Index 0 of each stage held its pool there; here
    the pools of every bin run first, in :func:`adaptive_avg_pool_multi`.
    Under spatial sharding the bins are the whole image's on every rank of a
    model group, so the stages' BNs are marked ``replicated_maps``.
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
        for stage in self.stages:
            stage[2].replicated_maps = True
        self.bottleneck = nn.Sequential(
            conv2d(in_ch + branch_ch * len(self.bin_sizes), out_ch, 3,
                   padding=1, weight_init=kaiming_normal_init),
            batch_norm(out_ch), nn.ReLU(inplace=True), nn.Dropout(0.1))

    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _pool_bins = staticmethod(adaptive_avg_pool_multi)
    _resize = staticmethod(resize_bilinear)

    def forward(self, x):
        size = x.shape[-2:]
        pyramids = [x]
        for stage, pooled in zip(self.stages, self._pool_bins(x, self.bin_sizes)):
            pyramids.append(self._resize(stage(pooled), size, align_corners=True))
        return self.bottleneck(torch.cat(pyramids, dim=1))


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling.

    A 1x1 branch and ``num_branches - 1`` dilated 3x3 branches (each
    conv + BN + ReLU), an image-pool branch (the spatial mean in at least
    fp32, 1x1 conv,
    BN, ReLU, then resized back with ``align_corners=True``), concat, and a
    1x1 projection + BN + ReLU + dropout(0.5). Dilations (1, 6, 12, 18) at
    output stride 16 and (1, 12, 24, 36) at 8 for 4 branches; (1, 6, 12, 18,
    24, 36)[:num_branches] otherwise.

    Keys follow the original ``ASSP``: ``aspp{i}.{0,1}``, ``avg_pool.{1,2}``
    (index 0 held its adaptive pool; here the mean is taken in ``forward``),
    ``conv1`` and ``bn1``. The image pool's BN normalizes a 1x1 map, so in
    train mode it needs a batch of 2 or more. Under spatial sharding the
    image pool is the whole image's on every rank of a model group, so its
    BN is marked ``replicated_maps``.
    """

    def __init__(self, in_ch: int, output_stride: int = 16, num_branches: int = 4,
                 features: int = 256):
        super().__init__()
        if num_branches == 4:
            dilations = [1, 6, 12, 18] if output_stride == 16 else [1, 12, 24, 36]
        else:
            dilations = [1, 6, 12, 18, 24, 36][:num_branches]
        self.num_branches = len(dilations)
        for i, d in enumerate(dilations):
            k = 1 if i == 0 else 3
            setattr(self, f"aspp{i + 1}", ConvBNAct(
                in_ch, features, k, padding=0 if k == 1 else d, dilation=d,
                weight_init=kaiming_normal_init))
        self.avg_pool = nn.Sequential(
            nn.Identity(), conv2d(in_ch, features, 1, weight_init=kaiming_normal_init),
            batch_norm(features), nn.ReLU(inplace=True))
        # under spatial sharding the image pool is the whole image's on every
        # model rank
        self.avg_pool[2].replicated_maps = True
        self.conv1 = conv2d(features * (self.num_branches + 1), features, 1,
                            weight_init=kaiming_normal_init)
        self.bn1 = batch_norm(features)
        self.relu = nn.ReLU(inplace=True)
        self.dropout = nn.Dropout(0.5)

    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _image_pool = staticmethod(image_mean)
    _resize = staticmethod(resize_bilinear)

    def forward(self, x):
        outs = [getattr(self, f"aspp{i + 1}")(x) for i in range(self.num_branches)]
        img = self.avg_pool[1:](self._image_pool(x))
        outs.append(self._resize(img, x.shape[-2:], align_corners=True))
        y = self.relu(self.bn1(self.conv1(torch.cat(outs, dim=1))))
        return self.dropout(y)


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

    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _resize = staticmethod(resize_bilinear)

    def forward(self, features):
        feats = list(features)
        if self.lateral_p0 is not None:
            feats[0] = self.lateral_p0(feats[0])
        for i, conv in enumerate(self.conv1x1, start=1):
            feats[i] = conv(feats[i])
        merged = [self._resize(feats[j + 1], feats[j].shape[-2:], align_corners=True)
                  + feats[j] for j in range(len(feats) - 1)]
        pyramid = [conv(m) for conv, m in zip(self.smooth_conv, merged)] + [feats[-1]]
        size = pyramid[0].shape[-2:]
        pyramid = [pyramid[0]] + [self._resize(p, size, align_corners=True)
                                  for p in pyramid[1:]]
        return self.conv_fusion(torch.cat(pyramid, dim=1))


def icnr_init(upscale: int):
    """ICNR init of the DUC's 1x1 conv: each group of ``upscale**2``
    consecutive output channels shares one kaiming-normal subkernel (fan-in
    ``in``), so the pixel shuffle starts free of checkerboards. segtpu
    repeats along HWIO's O axis; in OIHW that is ``repeat_interleave`` on
    dim 0."""
    r2 = upscale * upscale

    def init(weight, generator=None):
        sub = torch.empty((weight.shape[0] // r2, *weight.shape[1:]),
                          dtype=weight.dtype, device=weight.device)
        kaiming_normal_init(sub, generator)
        weight.copy_(sub.repeat_interleave(r2, dim=0))

    return init


class DUC(nn.Module):
    """Dense Upsampling Convolution: a bias-free 1x1 conv to
    ``features * upscale**2`` channels (ICNR init), BN, ReLU, then the pixel
    shuffle by ``upscale``. segtpu's NHWC shuffle unpacks the channels in
    the order (c, rh, rw), which is the NCHW order of ``F.pixel_shuffle``.
    Keys follow the original ``DUC``: ``conv``, ``bn``."""

    def __init__(self, in_ch: int, features: int, upscale: int = 2):
        super().__init__()
        self.upscale = upscale
        self.conv = conv2d(in_ch, features * upscale * upscale, 1,
                           weight_init=icnr_init(upscale))
        self.bn = batch_norm(features * upscale * upscale)
        self.relu = nn.ReLU(inplace=True)

    #: the shuffle, which core/spatial.py's shard_windows swaps per instance
    _shuffle = staticmethod(F.pixel_shuffle)

    def forward(self, x):
        return self._shuffle(self.relu(self.bn(self.conv(x))), self.upscale)

"""Configurable ResNet feature extractor (NCHW).

Counterpart of ``segtpu/backbones/resnet.py``: one implementation for the
encoding-style dilated ResNet (deep-base 3x3 stem, output stride 8), the
torchvision ResNet with output-stride surgery, and the Hybrid Dilated Conv
plans. The dilation plan is computed up front by :func:`_layer_plan`.

Module names follow the original torch repo (``initial``, ``layerX.{i}.
conv1/bn1/.../downsample.{0,1}``), so its state dicts load as they are.
segtpu's memory and stem knobs: ``multi_grid`` (layer4's dilations 4, 8,
16), ``remat_blocks`` (each residual block recomputed in the backward) and
``s2d_stem`` (the first stem conv as a stride-1 conv over the 2x2
space-to-depth view, ``ops/s2d.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from segtpu_torch.nn.layers import batch_norm, conv2d, remat
from segtpu_torch.ops.conv_wgrad import StemConv2d
from segtpu_torch.ops.pooling import max_pool
from segtpu_torch.ops.s2d import S2DStemConv2d

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _he_fanout_init(weight, generator=None):
    """N(0, sqrt(2/(k*k*out))), the original resnet's conv init."""
    fan_out = weight.shape[0] * weight.shape[2] * weight.shape[3]
    nn.init.normal_(weight, 0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _conv(in_ch, out_ch, k, stride=1, padding=0, dilation=1):
    return conv2d(in_ch, out_ch, k, stride, padding, dilation,
                  weight_init=_he_fanout_init)


def _downsample(in_ch, out_ch, stride):
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride), batch_norm(out_ch))


class _Block(nn.Module):
    """A residual block; with ``remat`` set its forward runs under
    :func:`~segtpu_torch.nn.layers.remat` (segtpu's ``nn.remat`` of the
    block): the backward recomputes it, and the recompute leaves the
    running statistics as the forward left them."""

    remat = False

    def forward(self, x):
        if self.remat:
            return remat(self.block, self, x)
        return self.block(x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, dilation1=1, dilation2=1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, dilation1, dilation1)
        self.bn1 = batch_norm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation2, dilation2)
        self.bn2 = batch_norm(planes)
        self.downsample = downsample

    def block(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_planes, planes, stride=1, dilation=1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = batch_norm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = downsample

    def block(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


def _layer_plan(
    arch: str,
    style: str,
    output_stride: int,
    multi_grid: bool,
    hdc: Optional[str],
) -> Tuple[Tuple[int, ...], list]:
    """(per-layer first-block stride, per-layer per-block dilation lists)."""
    _, counts = RESNET_LAYERS[arch]
    strides = [1, 2, 2, 2]
    dil = [[1] * c for c in counts]

    if hdc is not None:
        strides[2] = strides[3] = 1
        if hdc == "bigger":
            d3 = ([1, 2, 5, 9] * 5 + [1, 2, 5])[: counts[2]]
            d4 = [5, 9, 17][: counts[3]]
        else:
            d3 = ([1, 2, 3] * 7 + [2, 2])[: counts[2]]
            d4 = [3, 4, 5][: counts[3]]
        dil[2], dil[3] = list(d3), list(d4)
    elif style == "encoding":
        # stride 8; the first block of layer3 keeps dilation 1, multi-grid
        # [4, 8, 16] on layer4
        strides[2] = strides[3] = 1
        dil[2] = [1] + [2] * (counts[2] - 1)
        if multi_grid:
            md = [4, 8, 16]
            dil[3] = [md[min(i, 2)] for i in range(counts[3])]
        else:
            dil[3] = [2] + [4] * (counts[3] - 1)
    else:  # torchvision with output-stride surgery
        if output_stride == 32:
            s3, s4, d3, d4 = 2, 2, 1, 1
        elif output_stride == 16:
            s3, s4, d3, d4 = 2, 1, 1, 2
        elif output_stride == 8:
            s3, s4, d3, d4 = 1, 1, 2, 4
        else:
            raise ValueError(f"unsupported output_stride {output_stride}")
        strides[2], strides[3] = s3, s4
        dil[2] = [d3] * counts[2]
        dil[3] = [d4] * counts[3]
    return tuple(strides), dil


def run_features(initial: nn.Module, layers: Sequence[nn.Module],
                 x: torch.Tensor, pool=max_pool) -> List[torch.Tensor]:
    """Stem, 3x3/2 max pool (``pool``), then the four stages; the stage
    outputs."""
    y = pool(initial(x), 3, 2, padding=1)
    feats = []
    for layer in layers:
        y = layer(y)
        feats.append(y)
    return feats


class ResNetFeatures(nn.Module):
    """ResNet encoder returning the four stage feature maps.

    ``style``: ``'encoding'`` (deep-base 3x3 stem with 128 channels for the
    bottleneck variants, stride-8 dilated layer3/4) or ``'torchvision'``
    (7x7 stem, ``output_stride`` 8/16/32). ``hdc`` (``None``, ``'rf'`` or
    ``'bigger'``) selects a Hybrid Dilated Conv plan of :func:`_layer_plan`
    instead, and ``stem_stride`` is the first stem conv's stride (1 for
    DeepLab_DUC_HDC at output stride 4). ``multi_grid`` gives the encoding
    style's layer4 the dilations 4, 8, 16.

    ``pallas_stem_wgrad`` routes the first stem conv's weight gradient
    through the CUDA kernel of ``ops/conv_wgrad.py`` (the name is segtpu's
    flag). Only valid where the backbone reads the model input: the kernel's
    input gradient is zero. The kernel computes a stride-2 conv, so the flag
    with ``stem_stride != 2`` raises (segtpu falls back to the plain conv
    there without a word). ``s2d_stem`` computes that conv through
    ``ops/s2d.py`` instead; ``pallas_stem_wgrad`` wins over it, and at a
    stem stride other than 2 it is ignored, as in segtpu. ``remat_blocks``
    recomputes each residual block in the backward. None of the three
    changes a parameter's name or shape.
    """

    def __init__(self, arch: str = "resnet50", style: str = "torchvision",
                 output_stride: int = 32, in_channels: int = 3,
                 pallas_stem_wgrad: bool = False, hdc: Optional[str] = None,
                 stem_stride: int = 2, multi_grid: bool = False,
                 remat_blocks: bool = False, s2d_stem: bool = False):
        super().__init__()
        if pallas_stem_wgrad and stem_stride != 2:
            raise ValueError(f"pallas_stem_wgrad needs stem_stride 2, got "
                             f"{stem_stride}: the kernel computes a stride-2 conv")
        block_kind, counts = RESNET_LAYERS[arch]
        deep_base = style == "encoding" and block_kind == "bottleneck"
        strides, dils = _layer_plan(arch, style, output_stride,
                                    multi_grid=multi_grid, hdc=hdc)

        k = 3 if deep_base else 7
        if pallas_stem_wgrad:
            first = StemConv2d(in_channels, 64, k, _he_fanout_init)
        elif s2d_stem and stem_stride == 2:
            first = S2DStemConv2d(in_channels, 64, k, _he_fanout_init)
        else:
            first = _conv(in_channels, 64, k, stem_stride, k // 2)
        if deep_base:
            conv1 = nn.Sequential(
                first, batch_norm(64), nn.ReLU(inplace=True),
                _conv(64, 64, 3, 1, 1), batch_norm(64), nn.ReLU(inplace=True),
                _conv(64, 128, 3, 1, 1))
        else:
            conv1 = first
        in_planes = 128 if deep_base else 64
        self.initial = nn.Sequential(conv1, batch_norm(in_planes),
                                     nn.ReLU(inplace=True))

        widths = (64, 128, 256, 512)
        expansion = 4 if block_kind == "bottleneck" else 1
        #: widths of the four stage outputs
        self.feature_channels = tuple(wd * expansion for wd in widths)
        for li in range(4):
            planes = widths[li]
            out_planes = planes * expansion
            blocks = []
            for bi in range(counts[li]):
                stride = strides[li] if bi == 0 else 1
                ds = None
                if bi == 0 and (stride != 1 or in_planes != out_planes):
                    ds = _downsample(in_planes, out_planes, stride)
                if block_kind == "bottleneck":
                    blocks.append(Bottleneck(in_planes, planes, stride,
                                             dils[li][bi], ds))
                else:
                    # conv1 carries the block's dilation, conv2 the layer's
                    # nominal (largest) one in the encoding style; torchvision
                    # surgery gives both convs the same dilation
                    d1 = dils[li][bi]
                    d2 = max(dils[li]) if style == "encoding" else d1
                    blocks.append(BasicBlock(in_planes, planes, stride, d1, d2, ds))
                blocks[-1].remat = remat_blocks
                in_planes = out_planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_channels = in_planes

    #: the stem pool, which core/spatial.py's shard_windows swaps per instance
    _max_pool = staticmethod(max_pool)

    @property
    def layers(self):
        return [self.layer1, self.layer2, self.layer3, self.layer4]

    def forward(self, x):
        return run_features(self.initial, self.layers, x, self._max_pool)

"""VGG-16 feature stacks for FCN8 and SegNet.

Counterpart of ``segtpu/backbones/vgg.py``. SegNet's: the five stages of
torchvision's VGG-16-BN (3x3/pad-1 convs with bias, each followed by BN and
ReLU), each ended by a 2x2 max pool that keeps its argmax indices and the
size it pooled, for its unpooling decoder. FCN8's: torchvision's plain
VGG-16 ``features`` (conv and ReLU per width, a 2x2 max pool after each
stage), with the first conv padded by 100 and ceil-mode pools.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from segtpu_torch.nn.layers import batch_norm, conv2d
from segtpu_torch.ops.pooling import max_pool_argmax

VGG16_STAGES: Tuple[Tuple[int, ...], ...] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


class VGG16Stage(nn.Sequential):
    """One pre-pool stage, (3x3 conv + BN + ReLU) per width: the convs at
    indices ``3k`` and the BNs at ``3k + 1``, as the original SegNet's
    ``stageN_encoder``."""

    def __init__(self, in_ch: int, widths: Tuple[int, ...]):
        layers = []
        for w in widths:
            layers += [conv2d(in_ch, w, 3, padding=1, bias=True), batch_norm(w),
                       nn.ReLU(inplace=True)]
            in_ch = w
        super().__init__(*layers)


class VGG16Features(nn.Sequential):
    """FCN8's torchvision plain VGG-16 ``features``, indices and all (convs
    at 0, 2, 5, 7, 10, ...; a ``MaxPool2d`` ending each stage): the original
    FCN8 slices it after the third and fourth pools. The first conv is
    padded by 100 and the pools are ceil-mode, keeping their last partial
    windows."""

    def __init__(self, in_ch: int = 3):
        layers = []
        for widths in VGG16_STAGES:
            for w in widths:
                layers += [conv2d(in_ch, w, 3, padding=1 if layers else 100, bias=True),
                           nn.ReLU(inplace=True)]
                in_ch = w
            layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        super().__init__(*layers)


def run_with_indices(stages, x, pool=max_pool_argmax) -> Tuple[torch.Tensor, List]:
    """Each stage, then ``pool`` (:func:`max_pool_argmax`); returns
    ``(bottom, [(indices, pre-pool size), ...])``."""
    saved = []
    for stage in stages:
        x = stage(x)
        size = x.shape[-2:]
        x, idx = pool(x)
        saved.append((idx, size))
    return x, saved

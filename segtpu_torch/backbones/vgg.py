"""VGG-16-BN stages with argmax indices for SegNet.

Counterpart of ``segtpu/backbones/vgg.py``: the five stages of torchvision's
VGG-16-BN (3x3/pad-1 convs with bias, each followed by BN and ReLU), each
ended by a 2x2 max pool that keeps its argmax indices and the size it
pooled, for SegNet's unpooling decoder. The plain ``VGG16Features`` (FCN8's:
ceil-mode pools, the first conv padded by 100) is not ported yet (ROADMAP).
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


def run_with_indices(stages, x) -> Tuple[torch.Tensor, List]:
    """Each stage, then :func:`max_pool_argmax`; returns ``(bottom,
    [(indices, pre-pool size), ...])``."""
    saved = []
    for stage in stages:
        x = stage(x)
        size = x.shape[-2:]
        x, idx = max_pool_argmax(x)
        saved.append((idx, size))
    return x, saved

"""UperNet, plain PyTorch: the original repo's ``models/upernet.py``
(yassouali/pytorch-segmentation) on torchvision's ResNet at output stride
16.

The pyramid (bins 1, 2, 4, 6) keeps layer4's width: each bin through a 1x1
conv to a quarter of it, BN and ReLU, upsampled with ``align_corners=True``,
concatenated with the map, then a 3x3 conv back to the full width, BN,
ReLU and dropout 0.1. The FPN projects layers 2-4 (the pyramid's output in
place of layer4's) to ``fpn_out`` with biased 1x1 convs, adds each level's
upsampled coarser neighbour to it (``align_corners=True``), smooths each
sum with a biased 3x3 conv, upsamples every level to the finest, and fuses
the concatenation with a 3x3 conv, BN and ReLU. A biased 3x3 head gives
the classes, upsampled to the input (``align_corners=False``).

Departures from the original, which are segtpu's and the port's: each
merged level has a 3x3 smooth conv of its own (the original's list holds
one conv three times), ``smooth_conv.0`` at the finest level; the
pyramid's dropout takes elementwise keep masks where the original's is
``nn.Dropout2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.layers import Conv2d, batch_norm
from segbench.reference.precision import Precision
from segbench.reference.pspnet import PSPModule
from segbench.reference.resnet import ResNet


def _up(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class FPNFuse(nn.Module):
    def __init__(self, widths, fpn_out: int, precision: Precision):
        super().__init__()
        self.conv1x1 = nn.ModuleList(Conv2d(w, fpn_out, 1, bias=True, precision=precision)
                                     for w in widths[1:])
        self.smooth_conv = nn.ModuleList(
            Conv2d(fpn_out, fpn_out, 3, padding=1, bias=True, precision=precision)
            for _ in widths[1:])
        self.conv_fusion = nn.Sequential(
            Conv2d(len(widths) * fpn_out, fpn_out, 3, padding=1, precision=precision),
            batch_norm(fpn_out), nn.ReLU())

    def forward(self, feats):
        f = [feats[0]] + [conv(x) for conv, x in zip(self.conv1x1, feats[1:])]
        levels = [smooth(_up(f[j + 1], f[j].shape[-2:]) + f[j])
                  for j, smooth in enumerate(self.smooth_conv)] + [f[-1]]
        size = levels[0].shape[-2:]
        return self.conv_fusion(torch.cat([levels[0]] + [_up(p, size) for p in levels[1:]], 1))


class UperNet(nn.Module):
    backbone_modules = ("backbone",)

    def __init__(self, num_classes: int, backbone: str, fpn_out: int, output_stride: int,
                 precision: Precision):
        super().__init__()
        self.backbone = ResNet(backbone, "torchvision", precision, output_stride)
        widths = (256, 512, 1024, 2048)
        self.PPN = PSPModule(2048, (1, 2, 4, 6), 2048, precision)
        self.FPN = FPNFuse(widths, fpn_out, precision)
        self.head = Conv2d(fpn_out, num_classes, 3, padding=1, bias=True, precision=precision)

    def forward(self, x):
        feats = self.backbone(x)
        feats[-1] = self.PPN(feats[-1])
        y = self.head(self.FPN(feats))
        return {"out": F.interpolate(y, size=x.shape[-2:], mode="bilinear", align_corners=False)}


def build(config: dict, precision: Precision) -> UperNet:
    args = config["arch"]["args"]
    return UperNet(config["num_classes"], args["backbone"], args["fpn_out"],
                   args["output_stride"], precision)

"""PSPNet, plain PyTorch: the original repo's ``models/pspnet.py``
(yassouali/pytorch-segmentation) on the deep-base dilated ResNet.

The pyramid pools the last stage's map to bins (1, 2, 3, 6), each through a
1x1 conv (a quarter of the width), BN and ReLU, upsampled bilinearly with
``align_corners=True``; the map and the four bins are concatenated and go
through a 3x3 conv to a quarter of the width, BN, ReLU and dropout 0.1,
then a 1x1 classifier. The aux head reads layer3: 3x3 conv to a quarter of
layer4's width, BN, ReLU, dropout 0.1, 1x1 classifier. Both outputs are
upsampled to the input bilinearly (``align_corners=False``); the aux output
exists in train mode only.

One departure from the original: its dropouts are ``nn.Dropout2d`` (a
channel at a time); these take elementwise keep masks, as the port and
segtpu draw them (:class:`~segbench.reference.layers.Dropout`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from segbench.reference.layers import Conv2d, Dropout, batch_norm
from segbench.reference.precision import Precision
from segbench.reference.resnet import ResNet, features


class PSPModule(nn.Module):
    def __init__(self, cin: int, bins, out_ch: int, precision: Precision):
        super().__init__()
        branch = cin // len(bins)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), Conv2d(cin, branch, 1, precision=precision),
                          batch_norm(branch), nn.ReLU())
            for b in bins)
        self.bottleneck = nn.Sequential(
            Conv2d(cin + branch * len(bins), out_ch, 3, padding=1, precision=precision),
            batch_norm(out_ch), nn.ReLU(), Dropout(0.1))

    def forward(self, x):
        size = x.shape[-2:]
        pyramid = [x] + [F.interpolate(stage(x), size=size, mode="bilinear", align_corners=True)
                         for stage in self.stages]
        return self.bottleneck(torch.cat(pyramid, dim=1))


class PSPNet(nn.Module):
    backbone_modules = ("initial", "layer1", "layer2", "layer3", "layer4")

    def __init__(self, num_classes: int, backbone: str, precision: Precision):
        super().__init__()
        net = ResNet(backbone, "deep_base", precision)
        self.initial = net.initial
        self.layer1, self.layer2, self.layer3, self.layer4 = (
            net.layer1, net.layer2, net.layer3, net.layer4)
        self.master_branch = nn.Sequential(
            PSPModule(2048, (1, 2, 3, 6), 512, precision),
            Conv2d(512, num_classes, 1, bias=True, precision=precision))
        self.auxiliary_branch = nn.Sequential(
            Conv2d(1024, 512, 3, padding=1, precision=precision), batch_norm(512), nn.ReLU(),
            Dropout(0.1), Conv2d(512, num_classes, 1, bias=True, precision=precision))

    def forward(self, x):
        size = x.shape[-2:]
        feats = features(self, x)
        out = {"out": F.interpolate(self.master_branch(feats[3]), size=size, mode="bilinear",
                                    align_corners=False)}
        if self.training:
            out["aux"] = F.interpolate(self.auxiliary_branch(feats[2]), size=size,
                                       mode="bilinear", align_corners=False)
        return out


def build(config: dict, precision: Precision) -> PSPNet:
    args = config["arch"]["args"]
    return PSPNet(config["num_classes"], args["backbone"], precision)

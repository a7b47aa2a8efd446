"""ResNet-50 and ResNet-101 feature extractors, plain PyTorch.

Two stems and stride plans, as the original repo
(yassouali/pytorch-segmentation) builds them:

* ``deep_base``: the encoding zoo's ``resnet50s``/``resnet101s`` that
  PSPNet uses: a 3x3 deep stem (3->64 stride 2, 64->64, 64->128, each with
  BN and ReLU), output stride 8: layer3 and layer4 at stride 1, layer3's
  first block at dilation 1 and the rest at 2, layer4's first block at 2
  and the rest at 4.
* ``torchvision``: torchvision's ResNet (7x7 stride-2 stem) with the
  original UperNet's surgery for output stride 16: layer4 at stride 1 and
  dilation 2 in every block's 3x3 conv.

Bottleneck blocks stride in their 3x3 conv. The stem's 3x3/2 max pool
(padding 1) follows ``initial``; the four stage outputs are returned.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from segbench.reference.layers import Conv2d, batch_norm
from segbench.reference.precision import Precision

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dilation, downsample, precision):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, precision=precision)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation, dilation, precision=precision)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, precision=precision)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, depth: str, stem: str, precision: Precision, output_stride: int = 8):
        super().__init__()
        if stem == "deep_base":
            self.initial = nn.Sequential(
                nn.Sequential(Conv2d(3, 64, 3, 2, 1, precision=precision), batch_norm(64),
                              nn.ReLU(), Conv2d(64, 64, 3, 1, 1, precision=precision),
                              batch_norm(64), nn.ReLU(),
                              Conv2d(64, 128, 3, 1, 1, precision=precision)),
                batch_norm(128), nn.ReLU())
            cin = 128
            strides = (1, 2, 1, 1)
            first = (1, 1, 1, 2)
            rest = (1, 1, 2, 4)
        elif stem == "torchvision" and output_stride == 16:
            self.initial = nn.Sequential(Conv2d(3, 64, 7, 2, 3, precision=precision),
                                         batch_norm(64), nn.ReLU())
            cin = 64
            strides = (1, 2, 2, 1)
            first = (1, 1, 1, 2)
            rest = (1, 1, 1, 2)
        else:
            raise ValueError(f"no such ResNet: stem {stem!r}, output stride {output_stride}")
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), BLOCKS[depth])):
            blocks = []
            for j in range(n):
                stride = strides[i] if j == 0 else 1
                down = None
                if j == 0 and (stride != 1 or cin != planes * 4):
                    down = nn.Sequential(Conv2d(cin, planes * 4, 1, stride, precision=precision),
                                         batch_norm(planes * 4))
                blocks.append(Bottleneck(cin, planes, stride, first[i] if j == 0 else rest[i],
                                         down, precision))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        return features(self, x)


def features(net: nn.Module, x):
    """The four stage outputs of ``net``'s ``initial`` and ``layer1``-``layer4``."""
    x = F.max_pool2d(net.initial(x), 3, 2, 1)
    feats = []
    for layer in (net.layer1, net.layer2, net.layer3, net.layer4):
        x = layer(x)
        feats.append(x)
    return feats

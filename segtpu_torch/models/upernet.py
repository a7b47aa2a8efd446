"""UperNet: FPN fusion over the four ResNet stages, with a PSP pyramid on
the last.

Counterpart of ``segtpu/models/upernet.py::UperNet``: the torchvision-style
ResNet at output stride 16 by default, a PSP pyramid with bins (1, 2, 4, 6)
whose bottleneck keeps the input width, :class:`FPNFuse` to ``fpn_out``, a
3x3 classifier ``head`` with bias, and a final bilinear upsample without
``align_corners``.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}`` in
train and eval mode. It can be sharded over H (``core/spatial.py``; total
stride ``output_stride``), which swaps the stem pool and every resize. Parameter names follow the original torch repo
(``backbone.initial.{0,1}``, ``backbone.layerX.*``, ``PPN.*``, ``FPN.*``,
``head``), so ``segtpu.utils.weight_convert.convert_upernet`` reads this
model's ``state_dict()`` wherever the layout is the original's (see
:class:`FPNFuse` for ``FPN.lateral_p0``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones.resnet import ResNetFeatures
from segtpu_torch.nn.blocks import FPNFuse, PSPModule
from segtpu_torch.nn.layers import (FreezableBN, conv2d, init_parameters,
                                    kaiming_normal_init)
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.pretrained import Layout, resnet_rules


class UperNet(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("backbone",)
    #: the final upsample, which core/spatial.py's shard_windows swaps per instance
    _resize = staticmethod(resize_bilinear)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 backbone: str = "resnet101", pretrained: Union[bool, str] = False,
                 use_aux: bool = True, fpn_out: int = 256,
                 freeze_bn: bool = False, freeze_backbone: bool = False,
                 output_stride: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        # use_aux is accepted as segtpu accepts it, and has no effect
        self.backbone = ResNetFeatures(arch=backbone, style="torchvision",
                                       output_stride=output_stride,
                                       in_channels=in_channels)
        #: the stride of the smallest map, for sharding H (core/spatial.py)
        self.spatial_stride = output_stride
        widths = self.backbone.feature_channels
        self.PPN = PSPModule(widths[-1], (1, 2, 4, 6), out_features=widths[-1])
        self.FPN = FPNFuse(widths, fpn_out)
        self.head = conv2d(fpn_out, num_classes, 3, padding=1, bias=True,
                           weight_init=kaiming_normal_init)
        init_parameters(self, generator)

    def forward(self, x):
        feats = self.backbone(x)
        feats[-1] = self.PPN(feats[-1])
        y = self.head(self.FPN(feats))
        return {"out": self._resize(y, x.shape[-2:], align_corners=False)}

    def pretrained_layout(self) -> Layout:
        """torchvision's ResNet."""
        return Layout(self.backbone_name, resnet_rules("backbone.initial", "backbone."))

"""DeepLabV3+ with an Aligned-Xception or a ResNet backbone.

Counterpart of ``segtpu/models/deeplabv3_plus.py::DeepLab``: ASPP over the
backbone's 2048-channel output, a decoder that projects the low-level
features to 48 channels, concatenates the upsampled ASPP output, and runs
two 3x3 convs, dropout 0.1 and a biased 1x1 classifier, then a x4 bilinear
upsample with ``align_corners=True``. The ResNet variant is torchvision's
with output-stride surgery, its low-level tap layer1; Xception's is block1.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``.
Parameter names follow the original (``backbone.*``, ``ASSP.*``,
``decoder.*``; the ResNet stem is ``backbone.layer0.{0,1}``), so
``segtpu.utils.weight_convert.convert_deeplab_xception`` and
``convert_deeplab_resnet`` read this model's ``state_dict()``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones.resnet import ResNetFeatures, run_features
from segtpu_torch.backbones.xception import XceptionFeatures
from segtpu_torch.nn.blocks import ASPP
from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, init_parameters,
                                    kaiming_normal_init, zeros_init)
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.pretrained import Layout, resnet_rules


class _ResNetBackbone(nn.Module):
    """A torchvision-style ResNet under the original DeepLab's names:
    ``layer0`` (stem conv, BN, ReLU; the max pool has no parameters) and
    ``layer1..4``. Returns ``(layer4 output, layer1 output)``. ``kwargs``
    go to :class:`ResNetFeatures` (DeepLab_DUC_HDC's ``hdc`` and
    ``stem_stride``)."""

    def __init__(self, arch: str, output_stride: int, in_channels: int, **kwargs):
        super().__init__()
        feats = ResNetFeatures(arch=arch, style="torchvision",
                               output_stride=output_stride, in_channels=in_channels,
                               **kwargs)
        self.layer0 = feats.initial
        self.layer1, self.layer2 = feats.layer1, feats.layer2
        self.layer3, self.layer4 = feats.layer3, feats.layer4
        self.out_channels = feats.out_channels
        self.low_level_channels = feats.feature_channels[0]

    def forward(self, x):
        feats = run_features(self.layer0, [self.layer1, self.layer2,
                                           self.layer3, self.layer4], x)
        return feats[3], feats[0]


class DeepLabDecoder(nn.Module):
    """48-channel low-level projection (``conv1``, ``bn1``), concat with the
    upsampled ASPP output, then ``output``: two 3x3 conv + BN + ReLU,
    dropout 0.1 and the biased classifier (original indices 0-7)."""

    def __init__(self, low_level_channels: int, num_classes: int, features: int = 256):
        super().__init__()
        self.conv1 = conv2d(low_level_channels, 48, 1, weight_init=kaiming_normal_init)
        self.bn1 = batch_norm(48)
        self.relu = nn.ReLU(inplace=True)
        self.output = nn.Sequential(
            conv2d(48 + features, 256, 3, padding=1, weight_init=kaiming_normal_init),
            batch_norm(256), nn.ReLU(inplace=True),
            conv2d(256, 256, 3, padding=1, weight_init=kaiming_normal_init),
            batch_norm(256), nn.ReLU(inplace=True),
            nn.Dropout(0.1),
            conv2d(256, num_classes, 1, bias=True, weight_init=kaiming_normal_init,
                   bias_init=zeros_init))

    def forward(self, x, low_level):
        ll = self.relu(self.bn1(self.conv1(low_level)))
        x = resize_bilinear(x, ll.shape[-2:], align_corners=True)
        return self.output(torch.cat([ll, x], dim=1))


class DeepLab(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("backbone",)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 backbone: str = "xception", pretrained: Union[bool, str] = False,
                 output_stride: int = 16, freeze_bn: bool = False,
                 freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        if "resnet" in backbone:
            self.backbone = _ResNetBackbone(backbone, output_stride, in_channels)
        else:
            self.backbone = XceptionFeatures(output_stride, in_channels)
        self.ASSP = ASPP(self.backbone.out_channels, output_stride=output_stride,
                         num_branches=4)
        self.decoder = DeepLabDecoder(self.backbone.low_level_channels, num_classes)
        init_parameters(self, generator)

    def forward(self, x):
        y, low_level = self.backbone(x)
        y = self.decoder(self.ASSP(y), low_level)
        return {"out": resize_bilinear(y, x.shape[-2:], align_corners=True)}

    def pretrained_layout(self) -> Layout:
        """torchvision's ResNet, or DeepLab's aligned Xception, 2-D pointwise
        weights read as 1x1 convs, with ``convert_xception``'s fallbacks for
        the blocks and exit convs that the file lacks."""
        if "resnet" in self.backbone_name:
            return Layout(self.backbone_name, resnet_rules("backbone.layer0", "backbone."))
        fallbacks = tuple((f"backbone.block{i}.", (f"block{i}.", "block11."))
                          for i in range(12, 20)) + (
            ("backbone.block20.", ("block20.", "block12.")),
            ("backbone.bn4.", ("bn4.", "bn3.")),
            ("backbone.conv5.", ("conv5.", "conv4.")),
            ("backbone.bn5.", ("bn5.", "bn4.", "bn3.")))
        return Layout("xception", [("backbone.", "")], fallbacks=fallbacks, reshape=True)

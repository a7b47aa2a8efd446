"""UNet (from scratch) and UNetResnet (dilated-ResNet encoder).

Counterpart of ``segtpu/models/unet.py``. UNet: ``x2conv`` blocks, ceil-mode
2x2 max pools whose pooled map is both the next stage's input and the
decoder's skip, and decoders that upsample by a transposed conv (k 2, s 2),
resize onto the skip with ``align_corners=True`` where the sizes differ (odd
inputs: at 769 every stage overshoots by one), concat and ``x2conv``.
UNetResnet: an encoding-style ResNet (ResNet-50 by default), then biased 3x3
``convN`` and bias-free transposed ``upconvN`` (k 4, s 2, p 1) with three
align-corners resizes onto the skips, a last one onto the input where
needed, and a bias-free 1x1 ``conv7``; no activation in its decoder, as the
original.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``. Both
can be sharded over H (``core/spatial.py``; total stride 16 for UNet, 8 for
UNetResnet, whose encoder is dilated past stride 8): their pools, up-convs
(UNetResnet's overlap in H) and resizes then work in global coordinates,
and a resize onto a skip compares the maps' global sizes.
Parameter names follow the original (UNet: ``start_conv``,
``down{i}.down_conv``, ``middle_conv``, ``up{i}.{up,up_conv}``,
``final_conv``; UNetResnet: ``initial``, ``layerX``, ``conv{1..7}``,
``upconv{1..5}``), so ``segtpu.utils.weight_convert.convert_unet`` and
``convert_unet_resnet`` read these models' ``state_dict()``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones.resnet import ResNetFeatures, run_features
from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, conv_transpose2d,
                                    init_parameters, kaiming_normal_init, zeros_init)
from segtpu_torch.ops.pooling import max_pool
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.pretrained import Layout, resnet_rules


class X2Conv(nn.Sequential):
    """(3x3 conv -> BN -> ReLU) x2, the inner width ``features // 2``
    (original indices 0-5)."""

    def __init__(self, in_ch: int, features: int):
        inner = features // 2
        super().__init__(
            conv2d(in_ch, inner, 3, padding=1, weight_init=kaiming_normal_init),
            batch_norm(inner), nn.ReLU(inplace=True),
            conv2d(inner, features, 3, padding=1, weight_init=kaiming_normal_init),
            batch_norm(features), nn.ReLU(inplace=True))


class _Encoder(nn.Module):
    """``x2conv`` then a ceil-mode 2x2 max pool (the original ``encoder``)."""

    #: swapped per instance by core/spatial.py's shard_windows
    _max_pool = staticmethod(max_pool)

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.down_conv = X2Conv(in_ch, features)

    def forward(self, x):
        return self._max_pool(self.down_conv(x), 2, ceil_mode=True)


class _Decoder(nn.Module):
    """Transposed conv (k 2, s 2) halving the width, resize onto the skip
    where the sizes differ, concat ``[skip, y]``, ``x2conv`` (the original
    ``decoder``)."""

    #: swapped per instance by core/spatial.py's shard_windows
    _resize = staticmethod(resize_bilinear)

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.up = conv_transpose2d(in_ch, in_ch // 2, 2, 2,
                                   weight_init=kaiming_normal_init, bias_init=zeros_init)
        self.up_conv = X2Conv(in_ch // 2 + features, features)

    def forward(self, skip, y):
        y = self._resize(self.up(y), skip.shape[-2:], align_corners=True)
        return self.up_conv(torch.cat([skip, y], dim=1))


class UNet(FreezableBN):
    #: no backbone: every parameter trains at lr
    backbone_modules = ()
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 16

    def __init__(self, num_classes: int, in_channels: int = 3, freeze_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freeze_bn = freeze_bn
        self.start_conv = X2Conv(in_channels, 64)
        self.down1 = _Encoder(64, 128)
        self.down2 = _Encoder(128, 256)
        self.down3 = _Encoder(256, 512)
        self.down4 = _Encoder(512, 1024)
        self.middle_conv = X2Conv(1024, 1024)
        self.up1 = _Decoder(1024, 512)
        self.up2 = _Decoder(512, 256)
        self.up3 = _Decoder(256, 128)
        self.up4 = _Decoder(128, 64)
        self.final_conv = conv2d(64, num_classes, 1, bias=True,
                                 weight_init=kaiming_normal_init, bias_init=zeros_init)
        init_parameters(self, generator)

    def forward(self, x):
        x1 = self.start_conv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.middle_conv(self.down4(x4))
        y = self.up1(x4, y)
        y = self.up2(x3, y)
        y = self.up3(x2, y)
        y = self.up4(x1, y)
        return {"out": self.final_conv(y)}


class UNetResnet(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("initial", "layer1", "layer2", "layer3", "layer4")
    #: the stride of the smallest map (the encoding-style encoder's), for
    #: sharding H (core/spatial.py)
    spatial_stride = 8
    #: swapped per instance by core/spatial.py's shard_windows
    _max_pool = staticmethod(max_pool)
    _resize = staticmethod(resize_bilinear)

    def __init__(self, num_classes: int, in_channels: int = 3, backbone: str = "resnet50",
                 pretrained: Union[bool, str] = False, freeze_bn: bool = False,
                 freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        feats = ResNetFeatures(arch=backbone, style="encoding", in_channels=in_channels)
        self.initial = feats.initial
        self.layer1, self.layer2 = feats.layer1, feats.layer2
        self.layer3, self.layer4 = feats.layer3, feats.layer4
        c1, c2, c3, c4 = feats.feature_channels

        def conv(i, o, k=3):
            return conv2d(i, o, k, padding=k // 2, bias=True,
                          weight_init=kaiming_normal_init, bias_init=zeros_init)

        def upconv(i, o):
            return conv_transpose2d(i, o, 4, 2, 1, bias=False,
                                    weight_init=kaiming_normal_init)

        self.conv1, self.upconv1 = conv(c4, 192), upconv(192, 128)
        self.conv2, self.upconv2 = conv(128 + c3, 128), upconv(128, 96)
        self.conv3, self.upconv3 = conv(96 + c2, 96), upconv(96, 64)
        self.conv4, self.upconv4 = conv(64 + c1, 64), upconv(64, 48)
        self.conv5, self.upconv5 = conv(48, 48), upconv(48, 32)
        self.conv6 = conv(32, 32)
        self.conv7 = conv2d(32, num_classes, 1, weight_init=kaiming_normal_init)
        init_parameters(self, generator)

    def forward(self, x):
        x1, x2, x3, x4 = run_features(self.initial, [self.layer1, self.layer2,
                                                     self.layer3, self.layer4], x,
                                      self._max_pool)
        y = self.upconv1(self.conv1(x4))
        for conv, upconv, skip in ((self.conv2, self.upconv2, x3),
                                   (self.conv3, self.upconv3, x2),
                                   (self.conv4, self.upconv4, x1)):
            y = self._resize(y, skip.shape[-2:], align_corners=True)
            y = upconv(conv(torch.cat([y, skip], dim=1)))
        y = self.upconv5(self.conv5(y))
        y = self._resize(y, x.shape[-2:], align_corners=True)
        return {"out": self.conv7(self.conv6(y))}

    def pretrained_layout(self) -> Layout:
        """The encoding zoo's deep-base ResNet (``<backbone>s``)."""
        return Layout(f"{self.backbone_name}s", resnet_rules("initial"))

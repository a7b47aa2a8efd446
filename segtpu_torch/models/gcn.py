"""GCN, the Global Convolutional Network (large separable kernels).

Counterpart of ``segtpu/models/gcn.py``. Each of the backbone's four
feature maps goes through a GCN block (the sum of a k x 1 then 1 x k path
and a 1 x k then k x 1 path, biased, to ``num_classes`` channels; k is
``num_filters``, 11) and a boundary refinement (``x + conv(relu(conv(x)))``
with 3x3 convs); the maps are fused top-down, each sum refined again, by
align-corners bilinear resizes or, with ``use_deconv``, by 3x3/2 transposed
convs whose outputs are padded or cropped at the top and left onto the
next map (segtpu adds the last of these alignments, onto the layer1 map,
which the original lacks). A biased 1x1 ``final_conv`` gives the logits.

The backbone is torchvision's ResNet at output stride 32 (``backbone.
initial.{0,1}``, ``backbone.layerX``), or with ``use_resnet_gcn`` its stem
and layer1-2 followed by six GCN bottlenecks at 1024 channels in layer3 and
six at 2048 in layer4. segtpu's divergence from the original is kept: the
original's layer4 repeats one shared 1024-wide block over a 2048-channel
input, which cannot run; here layer4's blocks are independent and 2048
wide.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``.
Parameter names follow the original (``gcnN.conv{11,12,21,22}``,
``brN.conv{1,2}``, ``deconN``, ``final_conv``), so
``segtpu.utils.weight_convert.convert_gcn`` reads the torchvision-backbone
model's ``state_dict()``. segtpu has no converter for ``use_resnet_gcn``;
its GCN layers follow the original's module names as segtpu's docstrings
cite them (``layerN.M.gcn.{conv,bn}{11,12,21,22}``, ``conv1x1``,
``bn1x1``, ``downsample.{0,1}``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones.resnet import ResNetFeatures, run_features
from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, conv_transpose2d,
                                    init_parameters, kaiming_normal_init,
                                    torch_conv_bias_init, zeros_init)
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.ops.shape import pad_or_crop_tl
from segtpu_torch.pretrained import Layout, resnet_rules


def _conv(in_ch, out_ch, k, padding=0, stride=1, bias=True,
          bias_init=torch_conv_bias_init):
    """A conv with segtpu's GCN init: kaiming normal weights."""
    return conv2d(in_ch, out_ch, k, stride, padding, bias=bias,
                  weight_init=kaiming_normal_init, bias_init=bias_init)


class GCNBlock(nn.Module):
    """(k x 1 -> 1 x k) + (1 x k -> k x 1), biased convs."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        p = k // 2
        self.conv11 = _conv(in_ch, out_ch, (k, 1), (p, 0))
        self.conv12 = _conv(out_ch, out_ch, (1, k), (0, p))
        self.conv21 = _conv(in_ch, out_ch, (1, k), (0, p))
        self.conv22 = _conv(out_ch, out_ch, (k, 1), (p, 0))

    def forward(self, x):
        return self.conv12(self.conv11(x)) + self.conv22(self.conv21(x))


class BRBlock(nn.Module):
    """Boundary refinement: ``x + conv2(relu(conv1(x)))``, biased 3x3 convs."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = _conv(ch, ch, 3, 1)
        self.conv2 = _conv(ch, ch, 3, 1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


class BlockResnetGCN(nn.Module):
    """The two separable paths with BN and ReLU after each conv."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        p = k // 2
        for tag, shapes in (("1", (((k, 1), (p, 0)), ((1, k), (0, p)))),
                            ("2", (((1, k), (0, p)), ((k, 1), (p, 0))))):
            ch = in_ch
            for i, (kernel, pad) in enumerate(shapes):
                setattr(self, f"conv{tag}{i + 1}", _conv(ch, out_ch, kernel, pad, bias=False))
                setattr(self, f"bn{tag}{i + 1}", batch_norm(out_ch))
                ch = out_ch

    def _path(self, x, tag):
        for i in (1, 2):
            x = torch.relu(getattr(self, f"bn{tag}{i}")(getattr(self, f"conv{tag}{i}")(x)))
        return x

    def forward(self, x):
        return self._path(x, "1") + self._path(x, "2")


class BottleneckGCN(nn.Module):
    """``bn1x1(conv1x1(gcn(x)))`` (the 1x1 conv carries the stride) plus the
    input, or a biased strided 1x1 conv and BN of it where the width or
    size changes; no activation after the sum."""

    def __init__(self, in_ch: int, out_ch: int, k: int, gcn_ch: int, stride: int = 1):
        super().__init__()
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(_conv(in_ch, out_ch, 1, stride=stride),
                                            batch_norm(out_ch))
        self.gcn = BlockResnetGCN(in_ch, gcn_ch, k)
        self.conv1x1 = _conv(gcn_ch, out_ch, 1, stride=stride, bias=False)
        self.bn1x1 = batch_norm(out_ch)

    def forward(self, x):
        y = self.bn1x1(self.conv1x1(self.gcn(x)))
        return y + (x if self.downsample is None else self.downsample(x))


class ResnetGCN(nn.Module):
    """torchvision ResNet stem and layer1-2, then GCN bottlenecks: six at
    1024 channels (k 5, 85 wide) in layer3 and six at 2048 (k 7, 128 wide)
    in layer4, each layer's first at stride 2."""

    def __init__(self, arch: str = "resnet50", in_channels: int = 3):
        super().__init__()
        feats = ResNetFeatures(arch=arch, style="torchvision", in_channels=in_channels)
        self.initial, self.layer1, self.layer2 = feats.initial, feats.layer1, feats.layer2
        in_ch = feats.feature_channels[1]
        for li, out_ch, k, gcn_ch in ((3, 1024, 5, 85), (4, 2048, 7, 128)):
            blocks = [BottleneckGCN(in_ch, out_ch, k, gcn_ch, stride=2)]
            blocks += [BottleneckGCN(out_ch, out_ch, k, gcn_ch) for _ in range(5)]
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
            in_ch = out_ch
        self.feature_channels = (*feats.feature_channels[:2], 1024, 2048)

    def forward(self, x):
        return run_features(self.initial, [self.layer1, self.layer2, self.layer3,
                                           self.layer4], x)


class GCN(FreezableBN):
    #: segtpu's ``backbone`` scope: lr/10
    backbone_modules = ("backbone",)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 pretrained: Union[bool, str] = False,
                 use_resnet_gcn: bool = False, backbone: str = "resnet50",
                 use_deconv: bool = False, num_filters: int = 11, freeze_bn: bool = False,
                 freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.use_deconv = use_deconv
        self.pretrained, self.backbone_name = pretrained, backbone
        self.use_resnet_gcn = use_resnet_gcn
        if use_resnet_gcn:
            self.backbone = ResnetGCN(backbone, in_channels)
        else:
            self.backbone = ResNetFeatures(arch=backbone, style="torchvision",
                                           output_stride=32, in_channels=in_channels)
        nc = num_classes
        for i, ch in enumerate(self.backbone.feature_channels):
            setattr(self, f"gcn{i + 1}", GCNBlock(ch, nc, num_filters))
        for i in range(1, 10):
            setattr(self, f"br{i}", BRBlock(nc))
        if use_deconv:
            for i in range(1, 6):
                setattr(self, f"decon{i}", conv_transpose2d(
                    nc, nc, 3, 2, 1, bias=False, weight_init=kaiming_normal_init,
                    output_padding=1))
        self.final_conv = _conv(nc, nc, 1, bias_init=zeros_init)
        init_parameters(self, generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        x1, x2, x3, x4 = (getattr(self, f"br{i + 1}")(getattr(self, f"gcn{i + 1}")(f))
                          for i, f in enumerate(self.backbone(x)))
        if self.use_deconv:
            x4 = pad_or_crop_tl(self.decon4(x4), *x3.shape[-2:])
            x3 = pad_or_crop_tl(self.decon3(self.br5(x3 + x4)), *x2.shape[-2:])
            x2 = pad_or_crop_tl(self.decon2(self.br6(x2 + x3)), *x1.shape[-2:])
            x1 = self.decon1(self.br7(x1 + x2))
            y = pad_or_crop_tl(self.br9(self.decon5(self.br8(x1))), h, w)
        else:
            x4 = resize_bilinear(x4, x3.shape[-2:], align_corners=True)
            x3 = resize_bilinear(self.br5(x3 + x4), x2.shape[-2:], align_corners=True)
            x2 = resize_bilinear(self.br6(x2 + x3), x1.shape[-2:], align_corners=True)
            # segtpu resizes this sum to the stem pool's size, which is
            # layer1's own: the identity
            x1 = self.br7(x1 + x2)
            y = self.br9(resize_bilinear(self.br8(x1), (h, w), align_corners=True))
        return {"out": self.final_conv(y)}

    def pretrained_layout(self) -> Layout:
        """torchvision's ResNet; with ``use_resnet_gcn`` a partial load of the
        stem and layer1-2, whose layer3/4 are GCN blocks."""
        if self.use_resnet_gcn:
            return Layout(self.backbone_name,
                          resnet_rules("backbone.initial", "backbone.", (1, 2)), partial=True)
        return Layout(self.backbone_name, resnet_rules("backbone.initial", "backbone."))

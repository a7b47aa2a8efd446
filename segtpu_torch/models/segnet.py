"""SegNet (VGG-16-BN encoder, unpooling decoder) and SegResNet (ResNet-50
encoder, transposed-conv decoder).

Counterpart of ``segtpu/models/segnet.py``. SegNet: the VGG-16-BN stages
pooled with their argmax indices, and a mirrored decoder that unpools with
them before each stage of (3x3 conv + BN + ReLU), the channel step on each
stage's last conv, then a biased 3x3 classifier. SegResNet: a plain
ResNet-50 whose stem pool (3x3/2/pad 1) keeps its flat indices; a decoder of
the reversed stages, each ended by a bottleneck whose 3x3 conv and shortcut
are 2x2/2 transposed convs, and a last 256 -> 64 bottleneck; then segtpu's
epilogue: the ceil-crop to the pooled grid (its odd and even branches), the
unpool to twice that grid with the stem pool's indices, a transposed conv,
the classifier and the centre crop with its odd-size trims.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``. Both
models can be sharded over H (``core/spatial.py``; total stride 32), which
swaps their argmax pools and unpools and SegResNet's crops.
Parameter names follow the original (SegNet: ``stage{1..5}_encoder.{3k,
3k+1}``, ``stage{1..5}_decoder.*`` with the classifier at
``stage5_decoder.6``; SegResNet: ``first_conv.{0,1}``,
``encoder.{li}.{bi}.*``, ``decoder.{si}.{bi}.*``, ``last_conv.{0,1}``), so
``segtpu.utils.weight_convert.convert_segnet`` and ``convert_segresnet``
read these models' ``state_dict()``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones.vgg import VGG16_STAGES, VGG16Stage, run_with_indices
from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, conv_transpose2d,
                                    init_parameters, kaiming_normal_init, zeros_init)
from segtpu_torch.ops.pooling import (max_pool_argmax, max_pool_argmax_flat, max_unpool,
                                      max_unpool_flat)
from segtpu_torch.ops.shape import crop, hw
from segtpu_torch.pretrained import Layout

#: SegNet's decoder stages, the reversed VGG stages with the channel step on
#: each stage's last conv
DECODER_WIDTHS = ((512, 512, 512), (512, 512, 256), (256, 256, 128), (128, 64), (64, 64))


class SegNet(FreezableBN):
    #: segtpu's VGG encoder is its ``backbone`` scope: lr/10
    backbone_modules = tuple(f"stage{i}_encoder" for i in range(1, 6))
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 32
    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _pool_argmax = staticmethod(max_pool_argmax)
    _unpool = staticmethod(max_unpool)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 pretrained: Union[bool, str] = False,
                 freeze_bn: bool = False, freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained = pretrained
        in_ch = in_channels
        for name, widths in zip(self.backbone_modules, VGG16_STAGES):
            setattr(self, name, VGG16Stage(in_ch, widths))
            in_ch = widths[-1]
        for si, widths in enumerate(DECODER_WIDTHS):
            layers = []
            for w in widths:
                layers += [conv2d(in_ch, w, 3, padding=1, bias=True,
                                  weight_init=kaiming_normal_init, bias_init=zeros_init),
                           batch_norm(w), nn.ReLU(inplace=True)]
                in_ch = w
            if si == len(DECODER_WIDTHS) - 1:
                layers.append(conv2d(in_ch, num_classes, 3, padding=1, bias=True,
                                     weight_init=kaiming_normal_init,
                                     bias_init=zeros_init))
            setattr(self, f"stage{si + 1}_decoder", nn.Sequential(*layers))
        init_parameters(self, generator)

    def forward(self, x):
        y, saved = run_with_indices(
            [getattr(self, name) for name in self.backbone_modules], x, self._pool_argmax)
        for si in range(len(DECODER_WIDTHS)):
            idx, size = saved[len(saved) - 1 - si]
            y = getattr(self, f"stage{si + 1}_decoder")(self._unpool(y, idx, size))
        return {"out": y}

    def pretrained_layout(self) -> Layout:
        """torchvision's VGG-16-BN ``features``: each stage's modules in
        order, then the pool that the stage leaves out."""
        rules, offset = [], 0
        for name in self.backbone_modules:
            stage = getattr(self, name)
            rules += [(f"{name}.{j}.", f"features.{offset + j}.") for j in range(len(stage))]
            offset += len(stage) + 1
        return Layout("vgg16_bn", rules, skip=("classifier.",))


class _Residual(nn.Module):
    """relu(bn1(conv1) -> relu -> bn2(conv2) -> relu -> bn3(conv3) +
    shortcut), the shortcut ``downsample`` or, where it is None, the
    identity."""

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class _Bottleneck(_Residual):
    """torchvision's bottleneck, the stride on the 3x3 conv, without
    dilation: the encoder's and the decoder's plain blocks."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = conv2d(in_ch, planes, 1), batch_norm(planes)
        self.conv2, self.bn2 = conv2d(planes, planes, 3, stride, 1), batch_norm(planes)
        self.conv3, self.bn3 = conv2d(planes, planes * 4, 1), batch_norm(planes * 4)
        self.downsample = (nn.Sequential(conv2d(in_ch, planes * 4, 1, stride),
                                         batch_norm(planes * 4)) if downsample else None)


class _DecoderBottleneck(_Residual):
    """1x1 reduce to ``in // 4``, a 2x2/2 transposed conv, 1x1 expand to
    ``in // 2``, with a 2x2/2 transposed-conv shortcut: doubles the size
    and halves the width."""

    def __init__(self, in_ch: int):
        super().__init__()
        mid, out = in_ch // 4, in_ch // 2
        self.conv1, self.bn1 = conv2d(in_ch, mid, 1), batch_norm(mid)
        self.conv2 = conv_transpose2d(mid, mid, 2, 2, bias=False)
        self.bn2 = batch_norm(mid)
        self.conv3, self.bn3 = conv2d(mid, out, 1), batch_norm(out)
        self.downsample = nn.Sequential(conv_transpose2d(in_ch, out, 2, 2, bias=False),
                                        batch_norm(out))


class _LastBottleneck(_Residual):
    """The last 256 -> 64 bottleneck: 1x1, 3x3 and 1x1 convs at 64, with a
    1x1 shortcut."""

    def __init__(self, in_ch: int = 256):
        super().__init__()
        mid = in_ch // 4
        self.conv1, self.bn1 = conv2d(in_ch, mid, 1), batch_norm(mid)
        self.conv2, self.bn2 = conv2d(mid, mid, 3, 1, 1), batch_norm(mid)
        self.conv3, self.bn3 = conv2d(mid, mid, 1), batch_norm(mid)
        self.downsample = nn.Sequential(conv2d(in_ch, mid, 1), batch_norm(mid))


class SegResNet(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("first_conv", "encoder")
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 32
    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _pool_argmax_flat = staticmethod(max_pool_argmax_flat)
    _unpool_flat = staticmethod(max_unpool_flat)
    _crop = staticmethod(crop)
    _hw = staticmethod(hw)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 pretrained: Union[bool, str] = False,
                 freeze_bn: bool = False, freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained = pretrained
        self.first_conv = nn.Sequential(conv2d(in_channels, 64, 7, 2, 3), batch_norm(64),
                                        nn.ReLU(inplace=True))
        layers, in_ch = [], 64
        for li, (planes, count) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            blocks = []
            for bi in range(count):
                blocks.append(_Bottleneck(in_ch, planes, 2 if li > 0 and bi == 0 else 1,
                                          downsample=bi == 0))
                in_ch = planes * 4
            layers.append(nn.Sequential(*blocks))
        self.encoder = nn.Sequential(*layers)
        # the reversed stages without their first (downsampling) block, each
        # ended by a decoder bottleneck; then two plain blocks and the last
        stages = []
        for planes, reps in ((512, 2), (256, 5), (128, 3)):
            stages.append(nn.Sequential(*[_Bottleneck(planes * 4, planes)
                                          for _ in range(reps)],
                                        _DecoderBottleneck(planes * 4)))
        stages.append(nn.Sequential(_Bottleneck(256, 64), _Bottleneck(256, 64),
                                    _LastBottleneck(256)))
        self.decoder = nn.Sequential(*stages)
        self.last_conv = nn.Sequential(conv_transpose2d(64, 64, 2, 2, bias=False),
                                       conv2d(64, num_classes, 3, padding=1, bias=True))
        init_parameters(self, generator)

    def forward(self, x):
        h, w = self._hw(x)
        y = self.first_conv(x)
        y, idx = self._pool_argmax_flat(y)
        y = self.decoder(self.encoder(y))
        # segtpu's epilogue: ceil-crop to the pooled grid, unpool to twice
        # it (the indices are flat in the stem pool's input plane),
        # transposed conv, classifier, centre crop with the odd-size trims
        # (the ceil-crop's follow ih's parity on both axes), all in global
        # sizes
        ih, iw = self._hw(idx)
        yh, yw = self._hw(y)
        if (yh, yw) != (ih, iw):
            hd, wd, odd = -(-(yh - ih) // 2), -(-(yw - iw) // 2), ih % 2
            rows, cols = min(yh - 2 * hd + odd, yh - hd), min(yw - 2 * wd + odd, yw - wd)
            if (rows, cols) == (ih, iw):
                y = self._crop(y, hd, wd, idx.shape[-2:])
            else:  # the unpool below raises, as segtpu's
                y = y[..., hd:hd + rows, wd:wd + cols]
        y = self._unpool_flat(y, idx, (2 * idx.shape[-2], 2 * iw))
        out = self.last_conv(y)
        oh, ow = self._hw(out)
        if (oh, ow) != (h, w):
            hd, wd = (oh - h) // 2, (ow - w) // 2
            rows = oh - 2 * hd - hd % 2
            cols = ow - 2 * wd - wd % 2
            if (rows, cols) == (h, w):
                out = self._crop(out, hd, wd, x.shape[-2:])
            else:  # the odd trims miss the input's size, as segtpu's
                out = out[..., hd:hd + rows, wd:wd + cols]
        return {"out": out}

    def pretrained_layout(self) -> Layout:
        """torchvision's ResNet-50."""
        return Layout("resnet50", [("first_conv.0.", "conv1."), ("first_conv.1.", "bn1.")]
                      + [(f"encoder.{i}.", f"layer{i + 1}.") for i in range(4)])


"""FCN-8s on a plain VGG-16.

Counterpart of ``segtpu/models/fcn.py``. The VGG-16 features with the
first conv padded by 100 and ceil-mode pools, sliced after pool3 and pool4;
FC6 and FC7 as convs (7x7 valid, then 1x1, each 4096 wide, each followed by
ReLU and elementwise dropout 0.5) and a 1x1 score conv; then three fixed
bilinear upsamplers (4/2, 4/2, 16/8 transposed convs whose kernels are
diagonal across classes), between which the 1x1-adjusted ``0.01 * pool4``
and ``1e-4 * pool3`` are added, cropped at offsets 5 and 9; the result is
cropped at offset 31 back to the input size.

FCN8 can be sharded over H (``core/spatial.py``; total stride 32): the
first conv's 100 rows of padding lie at the image's global top and bottom,
so the first rank's output rows read the top padding and the last rank
holds all the 198 rows the padding adds; the upsamplers sum their
overlapping windows over the band boundaries, and the three crops cut
global rows into the layout of the map they are added to (or of the
input).

The upsamplers' kernels are buffers: they are in the ``state_dict`` under
the original's keys (``up_output``, ``up_pool4_out``, ``up_final``), and in
no parameter group, so no step changes them. segtpu applies them as fixed
kernels too, and its ``convert_fcn8`` skips them.

Parameter groups follow segtpu's code: its ``partition_labels`` counts a
name that starts with ``backbone_`` as backbone, and segtpu names FC6, FC7
and the score conv ``backbone_conv6``, ``backbone_conv7`` and
``backbone_score``, so the whole ``output`` head trains at lr/10 beside the
VGG features; ``adj_pool3`` and ``adj_pool4`` are the decoder.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``.
Parameter names follow the original (``pool3.{0,2,5,7,10,12,14}``,
``pool4.{0,2,4}``, ``pool5.{0,2,4}``, ``output.{0,3,6}``, ``adj_pool3``,
``adj_pool4``), so ``segtpu.utils.weight_convert.convert_fcn8`` reads this
model's ``state_dict()``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from segtpu_torch.backbones.vgg import VGG16Features
from segtpu_torch.nn.layers import bilinear_kernel, conv2d, init_parameters
from segtpu_torch.ops.shape import crop
from segtpu_torch.pretrained import Layout

#: FC6's and FC7's width
FC_WIDTH = 4096


class FixedUpsample(nn.Module):
    """A transposed conv (no padding, no bias) whose bilinear kernel is a
    buffer, ``weight``: it moves with the model and is saved, and no
    optimizer sees it."""

    def __init__(self, channels: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.register_buffer("weight", bilinear_kernel(channels, k))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, stride=self.stride)


class FCN8(nn.Module):
    #: VGG, FC6, FC7 and the score conv train at lr/10, as in segtpu's code
    backbone_modules = ("pool3", "pool4", "pool5", "output")
    #: the stride of the smallest map (pool5), for sharding H
    #: (core/spatial.py)
    spatial_stride = 32
    #: swapped per instance by core/spatial.py's shard_windows
    _crop = staticmethod(crop)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 pretrained: Union[bool, str] = False,
                 freeze_bn: bool = False, freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pretrained = pretrained
        # FCN8 has no BN; freeze_backbone is the optimizer's (core/state.py)
        features = list(VGG16Features(in_channels))
        pools = [i for i, m in enumerate(features) if isinstance(m, nn.MaxPool2d)]
        self.pool3 = nn.Sequential(*features[:pools[2] + 1])
        self.pool4 = nn.Sequential(*features[pools[2] + 1:pools[3] + 1])
        self.pool5 = nn.Sequential(*features[pools[3] + 1:])
        pool3_ch, pool4_ch, pool5_ch = (features[i - 2].out_channels for i in pools[2:])
        self.output = nn.Sequential(
            conv2d(pool5_ch, FC_WIDTH, 7, bias=True), nn.ReLU(inplace=True), nn.Dropout(0.5),
            conv2d(FC_WIDTH, FC_WIDTH, 1, bias=True), nn.ReLU(inplace=True), nn.Dropout(0.5),
            conv2d(FC_WIDTH, num_classes, 1, bias=True))
        self.up_output = FixedUpsample(num_classes, 4, 2)
        self.adj_pool4 = conv2d(pool4_ch, num_classes, 1, bias=True)
        self.up_pool4_out = FixedUpsample(num_classes, 4, 2)
        self.adj_pool3 = conv2d(pool3_ch, num_classes, 1, bias=True)
        self.up_final = FixedUpsample(num_classes, 16, 8)
        init_parameters(self, generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        pool3 = self.pool3(x)
        pool4 = self.pool4(pool3)
        up = self.up_output(self.output(self.pool5(pool4)))
        adj4 = self.adj_pool4(0.01 * pool4)
        up = self.up_pool4_out(self._crop(adj4, 5, 5, up.shape[-2:]) + up)
        adj3 = self.adj_pool3(0.0001 * pool3)
        up = self.up_final(self._crop(adj3, 9, 9, up.shape[-2:]) + up)
        return {"out": self._crop(up, 31, 31, (h, w))}

    def pretrained_layout(self) -> Layout:
        """torchvision's VGG-16: ``features`` as the three slices keep it,
        FC6 and FC7 (``classifier.0`` and ``.3``) as conv6 and conv7."""
        rules, offset = [], 0
        for name in ("pool3", "pool4", "pool5"):
            part = getattr(self, name)
            rules += [(f"{name}.{j}.", f"features.{offset + j}.") for j in range(len(part))]
            offset += len(part)
        rules += [("output.0.", "classifier.0."), ("output.3.", "classifier.3.")]
        return Layout("vgg16", rules, skip=("classifier.6.",), reshape=True,
                      required=("classifier.0.weight",),
                      required_why="FC6 and FC7 (classifier.0 and classifier.3) become "
                                   "conv6 and conv7, so FCN8 needs a full torchvision "
                                   "vgg16 state dict")

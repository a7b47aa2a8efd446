"""DeepLab with Dense Upsampling Convolution and Hybrid Dilated Convolution.

Counterpart of ``segtpu/models/duc_hdc.py``: a torchvision-style ResNet
(ResNet-101 by default) whose layer3 and layer4 keep stride 1 under an HDC
dilation plan (``"rf"``, or ``"bigger"`` with ``dilation_bigger``), its stem
conv at stride 1 at output stride 4; a 6-branch ASPP; a decoder that
upsamples the ASPP output by a DUC(x2), fuses the 48-channel low-level
projection and classifies; and a DUC(x4) head over the class scores (its
ReLU included, as the original's). Both of segtpu's crops are kept: the
decoder's DUC output is cropped to the low-level map, and the head's output
to the input.

Inputs and logits are NCHW; ``forward`` returns ``{"out": logits}``. It
can be sharded over H (``core/spatial.py``; total stride 8, or 4 at output
stride 4), which swaps the stem pool, ASPP's image pool, the resizes, the
pixel shuffles and both crops, which then cut global rows.
Parameter names follow the original (``backbone.layer0.*``,
``backbone.layerX.*``, ``ASSP.*``, ``decoder.{conv1,bn1,DUC,output}.*``,
``DUC_out.*``), so ``segtpu.utils.weight_convert.convert_duc_hdc`` reads
this model's ``state_dict()``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from segtpu_torch.models.deeplabv3_plus import DeepLabDecoder, _ResNetBackbone
from segtpu_torch.nn.blocks import ASPP, DUC
from segtpu_torch.nn.layers import FreezableBN, init_parameters
from segtpu_torch.ops.shape import crop
from segtpu_torch.pretrained import Layout, resnet_rules


class DUCDecoder(DeepLabDecoder):
    """DeepLabV3+'s decoder (``conv1``, ``bn1``, ``output``: original indices
    0-7) with a ``DUC`` (x2) in place of the bilinear upsample; its output
    is cropped to the low-level map."""

    def __init__(self, low_level_channels: int, num_classes: int, features: int = 256):
        super().__init__(low_level_channels, num_classes, features)
        self.DUC = DUC(features, features, upscale=2)

    #: the crop, which core/spatial.py's shard_windows swaps per instance
    _crop = staticmethod(crop)

    def forward(self, x, low_level):
        ll = self.relu(self.bn1(self.conv1(low_level)))
        x = self._crop(self.DUC(x), 0, 0, ll.shape[-2:])
        return self.output(torch.cat([ll, x], dim=1))


class DeepLab_DUC_HDC(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("backbone",)
    #: the crop, which core/spatial.py's shard_windows swaps per instance
    _crop = staticmethod(crop)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 backbone: str = "resnet101", pretrained: Union[bool, str] = False,
                 output_stride: int = 8, dilation_bigger: bool = False,
                 freeze_bn: bool = False, freeze_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        # the HDC plan fixes layer3/4's strides; output_stride picks the
        # stem's stride and ASPP's dilations
        stem_stride = 1 if output_stride == 4 else 2
        self.backbone = _ResNetBackbone(
            backbone, 32, in_channels, hdc="bigger" if dilation_bigger else "rf",
            stem_stride=stem_stride)
        #: the stride of the smallest map, for sharding H (core/spatial.py)
        self.spatial_stride = 4 * stem_stride
        self.ASSP = ASPP(self.backbone.out_channels, output_stride=output_stride,
                         num_branches=6)
        self.decoder = DUCDecoder(self.backbone.low_level_channels, num_classes)
        self.DUC_out = DUC(num_classes, num_classes, upscale=4)
        init_parameters(self, generator)

    def forward(self, x):
        y, low_level = self.backbone(x)
        y = self.decoder(self.ASSP(y), low_level)
        return {"out": self._crop(self.DUC_out(y), 0, 0, x.shape[-2:])}

    def pretrained_layout(self) -> Layout:
        """torchvision's ResNet."""
        return Layout(self.backbone_name, resnet_rules("backbone.layer0", "backbone."))

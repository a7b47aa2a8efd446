"""PSPNet with the encoding-style dilated ResNet backbone, and PSPDenseNet.

Counterpart of ``segtpu/models/pspnet.py``. PSPNet: PSP bins (1, 2, 3, 6),
the aux head on layer3, and a final bilinear upsample without
``align_corners``. Both dropouts are elementwise ``p=0.1``, as segtpu's.
PSPDenseNet: the same head on the dilated DenseNet of
``backbones/densenet.py`` (DenseNet-201 by default), its aux head on
transition3's output with a hidden width of a quarter of the backbone's
output (480 for DenseNet-201, whose transition3 gives 896 channels).

Inputs and logits are NCHW. ``forward`` returns ``{"out": logits}`` and, in
train mode with ``use_aux``, ``"aux"`` too. PSPNet takes segtpu's
``remat_backbone`` (each residual block recomputed in the backward) and
``s2d_stem`` (``ops/s2d.py``). Both models can be sharded over H
(``core/spatial.py``; total stride 8), which swaps their pools and resizes.
Parameter names follow the original torch repo (``initial.*``,
``layerX.*``, ``master_branch.*``, ``auxiliary_branch.*``), so
``segtpu.utils.weight_convert.convert_pspnet`` reads this model's
``state_dict()`` and the original ``.pth`` files load.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from segtpu_torch.backbones import densenet
from segtpu_torch.backbones.resnet import ResNetFeatures, run_features
from segtpu_torch.nn.blocks import PSPModule
from segtpu_torch.nn.layers import (FreezableBN, batch_norm, conv2d, init_parameters,
                                    kaiming_normal_init, zeros_init)
from segtpu_torch.ops.pooling import max_pool
from segtpu_torch.ops.resize import resize_bilinear
from segtpu_torch.pretrained import Layout, resnet_rules


def _classifier(in_ch: int, num_classes: int) -> nn.Conv2d:
    return conv2d(in_ch, num_classes, 1, bias=True,
                  weight_init=kaiming_normal_init, bias_init=zeros_init)


class _AuxBranch(nn.Sequential):
    """conv3x3 -> BN -> ReLU -> dropout(0.1) -> 1x1 classifier."""

    def __init__(self, in_ch: int, mid_ch: int, num_classes: int):
        super().__init__(
            conv2d(in_ch, mid_ch, 3, padding=1, weight_init=kaiming_normal_init),
            batch_norm(mid_ch), nn.ReLU(inplace=True), nn.Dropout(0.1),
            _classifier(mid_ch, num_classes))


class PSPNet(FreezableBN):
    #: top-level modules whose parameters train at lr/10
    backbone_modules = ("initial", "layer1", "layer2", "layer3", "layer4")
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 8
    #: the ops over H, which core/spatial.py's shard_windows swaps per instance
    _max_pool = staticmethod(max_pool)
    _resize = staticmethod(resize_bilinear)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 backbone: str = "resnet152", pretrained: Union[bool, str] = False,
                 use_aux: bool = True, freeze_bn: bool = False,
                 freeze_backbone: bool = False, pallas_stem_wgrad: bool = False,
                 remat_backbone: bool = False, s2d_stem: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # freeze_backbone is the optimizer's (core/state.py), as in segtpu
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        feats = ResNetFeatures(arch=backbone, style="encoding",
                               in_channels=in_channels,
                               pallas_stem_wgrad=pallas_stem_wgrad,
                               remat_blocks=remat_backbone, s2d_stem=s2d_stem)
        self.initial = feats.initial
        self.layer1, self.layer2 = feats.layer1, feats.layer2
        self.layer3, self.layer4 = feats.layer3, feats.layer4
        m_out = feats.out_channels
        self.master_branch = nn.Sequential(PSPModule(m_out, (1, 2, 3, 6)),
                                           _classifier(m_out // 4, num_classes))
        self.use_aux = use_aux
        if use_aux:
            self.auxiliary_branch = _AuxBranch(m_out // 2, m_out // 4, num_classes)
        init_parameters(self, generator)

    def forward(self, x):
        size = x.shape[-2:]
        feats = run_features(self.initial, [self.layer1, self.layer2,
                                            self.layer3, self.layer4], x, self._max_pool)
        out = self._resize(self.master_branch(feats[3]), size)
        result = {"out": out}
        if self.use_aux and self.training:
            result["aux"] = self._resize(self.auxiliary_branch(feats[2]), size)
        return result

    def pretrained_layout(self) -> Layout:
        """The encoding zoo's deep-base ResNet (``<backbone>s``)."""
        return Layout(f"{self.backbone_name}s", resnet_rules("initial"))


class PSPDenseNet(FreezableBN):
    """The PSP head on ``backbones/densenet.py``'s dilated DenseNet, with
    the original's top-level names (``block0``-``block4``,
    ``transition1``-``transition3``, ``master_branch``,
    ``auxiliary_branch``), so ``segtpu.utils.weight_convert.
    convert_pspdensenet`` reads this model's ``state_dict()``.
    ``remat_backbone`` checkpoints each dense layer (segtpu's per-dense-layer
    remat); it changes neither the gradients nor the running statistics.
    Sharded over H (total stride 8), the DenseNet's pools take their halo
    classes and the resizes work in global coordinates."""

    backbone_modules = densenet.DenseNetFeatures.module_names
    #: the stride of the smallest map, for sharding H (core/spatial.py)
    spatial_stride = 8
    #: the upsamples, which core/spatial.py's shard_windows swaps per instance
    _resize = staticmethod(resize_bilinear)

    def __init__(self, num_classes: int, in_channels: int = 3,
                 backbone: str = "densenet201", pretrained: Union[bool, str] = False,
                 use_aux: bool = True, freeze_bn: bool = False,
                 remat_backbone: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freeze_bn = freeze_bn
        self.pretrained, self.backbone_name = pretrained, backbone
        # a truthy pretrained selects torchvision's 7x7 stem, as in segtpu
        feats = densenet.DenseNetFeatures(backbone, in_channels, remat_layers=remat_backbone,
                                          pretrained_stem=bool(pretrained))
        for name in self.backbone_modules:
            setattr(self, name, getattr(feats, name))
        m_out = feats.out_channels
        self.master_branch = nn.Sequential(PSPModule(m_out, (1, 2, 3, 6)),
                                           _classifier(m_out // 4, num_classes))
        self.use_aux = use_aux
        if use_aux:
            self.auxiliary_branch = _AuxBranch(feats.aux_channels, m_out // 4, num_classes)
        init_parameters(self, generator)

    def forward(self, x):
        size = x.shape[-2:]
        y, x_aux = densenet.run_features(self, x)
        result = {"out": self._resize(self.master_branch(y), size)}
        if self.use_aux and self.training:
            result["aux"] = self._resize(self.auxiliary_branch(x_aux), size)
        return result

    def pretrained_layout(self) -> Layout:
        """torchvision's DenseNet ``features``; transition2/3 are re-sliced
        (norm at 0, conv at 2) and the final norm is not read."""
        rules = [("block0.0.", "features.conv0."), ("block0.1.", "features.norm0.")]
        rules += [(f"block{i}.", f"features.denseblock{i}.") for i in range(1, 5)]
        rules += [("transition1.", "features.transition1.")]
        for i in (2, 3):
            rules += [(f"transition{i}.0.", f"features.transition{i}.norm."),
                      (f"transition{i}.2.", f"features.transition{i}.conv.")]
        return Layout(self.backbone_name, rules, skip=("classifier.", "features.norm5."))

"""segtpu variables -> the port's ``state_dict``.

The inverses of ``segtpu/utils/weight_convert.py::convert_pspnet``,
``convert_upernet``, ``convert_deeplab_xception`` and
``convert_deeplab_resnet`` (with their ``convert_resnet`` and
``convert_xception``): segtpu's ``params`` and
``batch_stats`` (nested dicts of arrays, HWIO kernels) become a state dict
in the original torch repo's layout (OIHW kernels), which the port's model
loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resnet(sd, params, stats, prefix="", initial="initial"):
    """segtpu ResNetFeatures variables under ``<prefix><initial>.*`` /
    ``<prefix>layerX.*``: the original PSPNet's keys with no prefix,
    UperNet's with ``"backbone."``, DeepLab's with ``"backbone."`` and its
    stem under ``layer0``."""
    init = f"{prefix}{initial}"
    if "stem_conv2" in params:  # deep base: initial.0 is a Sequential
        _conv(sd, f"{init}.0.0", params["stem_conv1"])
        _bn(sd, f"{init}.0.1", params["stem_bn1"], stats["stem_bn1"])
        _conv(sd, f"{init}.0.3", params["stem_conv2"])
        _bn(sd, f"{init}.0.4", params["stem_bn2"], stats["stem_bn2"])
        _conv(sd, f"{init}.0.6", params["stem_conv3"])
    else:
        _conv(sd, f"{init}.0", params["stem_conv1"])
    _bn(sd, f"{init}.1", params["stem_bn"], stats["stem_bn"])
    for li in range(1, 5):
        bi = 0
        while f"layer{li}_{bi}" in params:
            p, s = params[f"layer{li}_{bi}"], stats[f"layer{li}_{bi}"]
            t = f"{prefix}layer{li}.{bi}"
            ci = 1
            while f"conv{ci}" in p:
                _conv(sd, f"{t}.conv{ci}", p[f"conv{ci}"])
                _bn(sd, f"{t}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
                ci += 1
            if "downsample_conv" in p:
                _conv(sd, f"{t}.downsample.0", p["downsample_conv"])
                _bn(sd, f"{t}.downsample.1", p["downsample_bn"], s["downsample_bn"])
            bi += 1


def _psp(sd, prefix, p, s):
    """segtpu PSPModule variables under the original ``_PSPModule`` keys."""
    i = 0
    while f"stage{i}_conv" in p:
        t = f"{prefix}.stages.{i}"
        _conv(sd, f"{t}.1", p[f"stage{i}_conv"])
        _bn(sd, f"{t}.2", p[f"stage{i}_bn"], s[f"stage{i}_bn"])
        i += 1
    _conv(sd, f"{prefix}.bottleneck.0", p["bottleneck_conv"])
    _bn(sd, f"{prefix}.bottleneck.1", p["bottleneck_bn"], s["bottleneck_bn"])


def pspnet_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu PSPNet ``(params, batch_stats)`` -> the port's PSPNet
    ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"])
    _psp(sd, "master_branch.0", params["psp"], batch_stats["psp"])
    _conv(sd, "master_branch.1", params["classifier"])
    if "aux_branch" in params:
        aux_p, aux_s = params["aux_branch"], batch_stats["aux_branch"]
        _conv(sd, "auxiliary_branch.0", aux_p["conv"])
        _bn(sd, "auxiliary_branch.1", aux_p["bn"], aux_s["bn"])
        _conv(sd, "auxiliary_branch.4", aux_p["classifier"])
    return sd


def upernet_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu UperNet ``(params, batch_stats)`` -> the port's UperNet
    ``state_dict``. segtpu's ``fpn/lateral{i}`` and ``smooth{i}`` become the
    original's ``FPN.conv1x1.{i}`` and ``FPN.smooth_conv.{i}``; its
    ``fpn/lateral_p0``, where present, ``FPN.lateral_p0``."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"], prefix="backbone.")
    _psp(sd, "PPN", params["ppn"], batch_stats["ppn"])
    fpn_p, fpn_s = params["fpn"], batch_stats["fpn"]
    if "lateral_p0" in fpn_p:
        _conv(sd, "FPN.lateral_p0", fpn_p["lateral_p0"])
    i = 0
    while f"lateral{i}" in fpn_p:
        _conv(sd, f"FPN.conv1x1.{i}", fpn_p[f"lateral{i}"])
        _conv(sd, f"FPN.smooth_conv.{i}", fpn_p[f"smooth{i}"])
        i += 1
    _conv(sd, "FPN.conv_fusion.0", fpn_p["fusion_conv"])
    _bn(sd, "FPN.conv_fusion.1", fpn_p["fusion_bn"], fpn_s["fusion_bn"])
    _conv(sd, "head", params["head"])
    return sd


def _xception(sd, params, stats, prefix="backbone."):
    """segtpu XceptionFeatures variables under the original DeepLab
    Xception's keys (blocks' ``rep`` with the separable convs at 1/4/7, or
    0/3/6 without the leading ReLU of block1)."""
    def sep(t, p, s):
        _conv(sd, f"{t}.conv1", p["depthwise"])
        _bn(sd, f"{t}.bn", p["bn"], s["bn"])
        _conv(sd, f"{t}.pointwise", p["pointwise"])

    for i in (1, 2):
        _conv(sd, f"{prefix}conv{i}", params[f"conv{i}"])
        _bn(sd, f"{prefix}bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    for b in range(1, 21):
        p, s, t = params[f"block{b}"], stats[f"block{b}"], f"{prefix}block{b}"
        first = 0 if b == 1 else 1
        for si in range(3):
            ri = first + 3 * si
            sep(f"{t}.rep.{ri}", p[f"sep{si + 1}"], s[f"sep{si + 1}"])
            _bn(sd, f"{t}.rep.{ri + 1}", p[f"bn{si + 1}"], s[f"bn{si + 1}"])
        if "skip_conv" in p:
            _conv(sd, f"{t}.skip", p["skip_conv"])
            _bn(sd, f"{t}.skipbn", p["skip_bn"], s["skip_bn"])
    for i in (3, 4, 5):
        sep(f"{prefix}conv{i}", params[f"conv{i}"], stats[f"conv{i}"])
        _bn(sd, f"{prefix}bn{i}", params[f"bn{i}"], stats[f"bn{i}"])


def deeplab_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu DeepLab ``(params, batch_stats)``, Xception or ResNet backbone,
    -> the port's DeepLab ``state_dict``: ``backbone.*``, ``ASSP.*`` and
    ``decoder.*``, the ResNet stem under ``backbone.layer0``."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    if "block1" in bp:
        _xception(sd, bp, bs)
    else:
        _resnet(sd, bp, bs, prefix="backbone.", initial="layer0")
    ap, asr = params["aspp"], batch_stats["aspp"]
    i = 1
    while f"aspp{i}_conv" in ap:
        _conv(sd, f"ASSP.aspp{i}.0", ap[f"aspp{i}_conv"])
        _bn(sd, f"ASSP.aspp{i}.1", ap[f"aspp{i}_bn"], asr[f"aspp{i}_bn"])
        i += 1
    _conv(sd, "ASSP.avg_pool.1", ap["pool_conv"])
    _bn(sd, "ASSP.avg_pool.2", ap["pool_bn"], asr["pool_bn"])
    _conv(sd, "ASSP.conv1", ap["project_conv"])
    _bn(sd, "ASSP.bn1", ap["project_bn"], asr["project_bn"])
    dp, ds = params["decoder"], batch_stats["decoder"]
    _conv(sd, "decoder.conv1", dp["ll_conv"])
    _bn(sd, "decoder.bn1", dp["ll_bn"], ds["ll_bn"])
    _conv(sd, "decoder.output.0", dp["conv1"])
    _bn(sd, "decoder.output.1", dp["bn1"], ds["bn1"])
    _conv(sd, "decoder.output.3", dp["conv2"])
    _bn(sd, "decoder.output.4", dp["bn2"], ds["bn2"])
    _conv(sd, "decoder.output.7", dp["classifier"])
    return sd

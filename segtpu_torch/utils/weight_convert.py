"""segtpu variables -> the port's ``state_dict``.

The inverses of ``segtpu/utils/weight_convert.py::convert_pspnet``,
``convert_upernet``, ``convert_deeplab_xception``,
``convert_deeplab_resnet``, ``convert_duc_hdc``, ``convert_unet``,
``convert_unet_resnet``, ``convert_segnet``, ``convert_segresnet``,
``convert_enet``, ``convert_gcn`` (and the ResnetGCN backbone, which segtpu
does not convert), ``convert_fcn8`` and ``convert_pspdensenet`` (with
their ``convert_resnet`` and ``convert_xception``): segtpu's ``params`` and
``batch_stats`` (nested dicts of arrays, HWIO kernels) become a state dict
in the original torch repo's layout (OIHW kernels), which the port's model
loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from segtpu_torch.backbones import vgg
from segtpu_torch.nn.layers import bilinear_kernel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_t(sd, prefix, p):
    """A transposed conv: HWIO (kh, kw, I, O) -> torch's (I, O, kh, kw), the
    inverse of segtpu's ``_convT``; no flip (segtpu flips at call time)."""
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 3, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resnet(sd, params, stats, prefix="", initial="initial", layers=(1, 2, 3, 4)):
    """segtpu ResNetFeatures variables under ``<prefix><initial>.*`` /
    ``<prefix>layerX.*``: the original PSPNet's keys with no prefix,
    UperNet's with ``"backbone."``, DeepLab's with ``"backbone."`` and its
    stem under ``layer0``; only the ResNet ``layers`` named."""
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
    for li in layers:
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
    _psp_head(sd, params, batch_stats)
    return sd


def _psp_head(sd, params, batch_stats):
    """PSPNet's and PSPDenseNet's ``master_branch`` and, where present,
    ``auxiliary_branch``."""
    _psp(sd, "master_branch.0", params["psp"], batch_stats["psp"])
    _conv(sd, "master_branch.1", params["classifier"])
    if "aux_branch" in params:
        aux_p, aux_s = params["aux_branch"], batch_stats["aux_branch"]
        _conv(sd, "auxiliary_branch.0", aux_p["conv"])
        _bn(sd, "auxiliary_branch.1", aux_p["bn"], aux_s["bn"])
        _conv(sd, "auxiliary_branch.4", aux_p["classifier"])


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


def _aspp(sd, prefix, p, s):
    """segtpu ASPP variables under the original ``ASSP`` keys."""
    i = 1
    while f"aspp{i}_conv" in p:
        _conv(sd, f"{prefix}.aspp{i}.0", p[f"aspp{i}_conv"])
        _bn(sd, f"{prefix}.aspp{i}.1", p[f"aspp{i}_bn"], s[f"aspp{i}_bn"])
        i += 1
    _conv(sd, f"{prefix}.avg_pool.1", p["pool_conv"])
    _bn(sd, f"{prefix}.avg_pool.2", p["pool_bn"], s["pool_bn"])
    _conv(sd, f"{prefix}.conv1", p["project_conv"])
    _bn(sd, f"{prefix}.bn1", p["project_bn"], s["project_bn"])


def _decoder(sd, p, s):
    """A DeepLab decoder's low-level projection and ``output`` convs under
    the original's ``decoder.{conv1,bn1,output.{0,1,3,4,7}}``."""
    _conv(sd, "decoder.conv1", p["ll_conv"])
    _bn(sd, "decoder.bn1", p["ll_bn"], s["ll_bn"])
    _conv(sd, "decoder.output.0", p["conv1"])
    _bn(sd, "decoder.output.1", p["bn1"], s["bn1"])
    _conv(sd, "decoder.output.3", p["conv2"])
    _bn(sd, "decoder.output.4", p["bn2"], s["bn2"])
    _conv(sd, "decoder.output.7", p["classifier"])


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
    _aspp(sd, "ASSP", params["aspp"], batch_stats["aspp"])
    _decoder(sd, params["decoder"], batch_stats["decoder"])
    return sd


def _duc(sd, prefix, p, s):
    _conv(sd, f"{prefix}.conv", p["conv"])
    _bn(sd, f"{prefix}.bn", p["bn"], s["bn"])


def duc_hdc_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu DeepLab_DUC_HDC ``(params, batch_stats)`` -> the port's
    ``state_dict``: ``backbone.layer0/layerX.*``, ``ASSP.*``,
    ``decoder.{conv1,bn1,DUC,output}.*`` and ``DUC_out.*``."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"], prefix="backbone.",
            initial="layer0")
    _aspp(sd, "ASSP", params["aspp"], batch_stats["aspp"])
    _decoder(sd, params["decoder"], batch_stats["decoder"])
    _duc(sd, "decoder.DUC", params["decoder"]["duc"], batch_stats["decoder"]["duc"])
    _duc(sd, "DUC_out", params["duc_out"], batch_stats["duc_out"])
    return sd


def _x2conv(sd, prefix, p, s):
    """segtpu X2Conv under the original ``x2conv`` Sequential's indices."""
    _conv(sd, f"{prefix}.0", p["conv1"])
    _bn(sd, f"{prefix}.1", p["bn1"], s["bn1"])
    _conv(sd, f"{prefix}.3", p["conv2"])
    _bn(sd, f"{prefix}.4", p["bn2"], s["bn2"])


def unet_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu UNet ``(params, batch_stats)`` -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    _x2conv(sd, "start_conv", params["start_conv"], batch_stats["start_conv"])
    for i in range(1, 5):
        _x2conv(sd, f"down{i}.down_conv", params[f"down{i}"], batch_stats[f"down{i}"])
    _x2conv(sd, "middle_conv", params["middle_conv"], batch_stats["middle_conv"])
    for i in range(1, 5):
        _conv_t(sd, f"up{i}.up", params[f"up{i}_up"])
        _x2conv(sd, f"up{i}.up_conv", params[f"up{i}_conv"], batch_stats[f"up{i}_conv"])
    _conv(sd, "final_conv", params["final_conv"])
    return sd


def unet_resnet_state_dict_from_segtpu(params: Dict, batch_stats: Dict
                                       ) -> Dict[str, torch.Tensor]:
    """segtpu UNetResnet ``(params, batch_stats)`` -> the port's
    ``state_dict``: the encoder under ``initial.*``/``layerX.*``."""
    sd: Dict[str, torch.Tensor] = {}
    _resnet(sd, params["backbone"], batch_stats["backbone"])
    for i in range(1, 8):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
    for i in range(1, 6):
        _conv_t(sd, f"upconv{i}", params[f"upconv{i}"])
    return sd


def _stage(sd, prefix, p, s, n):
    """``n`` (conv, BN) pairs under a Sequential's ``3k``/``3k + 1``."""
    for ci in range(n):
        _conv(sd, f"{prefix}.{3 * ci}", p[f"conv{ci}"])
        _bn(sd, f"{prefix}.{3 * ci + 1}", p[f"bn{ci}"], s[f"bn{ci}"])


def segnet_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu SegNet ``(params, batch_stats)`` -> the port's ``state_dict``:
    ``stage{1..5}_encoder`` from segtpu's VGG ``backbone``,
    ``stage{1..5}_decoder`` with the classifier at ``stage5_decoder.6``."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    si = 1
    while f"stage{si}" in bp:
        p = bp[f"stage{si}"]
        _stage(sd, f"stage{si}_encoder", p, bs[f"stage{si}"],
               sum(k.startswith("conv") for k in p))
        si += 1
    si = 1
    while f"decoder{si}" in params:
        p = params[f"decoder{si}"]
        _stage(sd, f"stage{si}_decoder", p, batch_stats[f"decoder{si}"],
               sum(k.startswith("conv") for k in p))
        si += 1
    _conv(sd, "stage5_decoder.6", params["classifier"])
    return sd


def _block(sd, prefix, p, s, transposed=False):
    """A SegResNet bottleneck: ``conv1..3``/``bn1..3`` and its
    ``downsample`` or ``shortcut`` under ``downsample.{0,1}``; with
    ``transposed`` (the decoder's up blocks) ``conv2`` and the shortcut are
    transposed convs."""
    for ci in (1, 2, 3):
        conv = _conv_t if transposed and ci == 2 else _conv
        conv(sd, f"{prefix}.conv{ci}", p[f"conv{ci}"])
        _bn(sd, f"{prefix}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
    for name in ("downsample", "shortcut"):
        if f"{name}_conv" in p:
            conv = _conv_t if transposed else _conv
            conv(sd, f"{prefix}.downsample.0", p[f"{name}_conv"])
            _bn(sd, f"{prefix}.downsample.1", p[f"{name}_bn"], s[f"{name}_bn"])


def segresnet_state_dict_from_segtpu(params: Dict, batch_stats: Dict
                                     ) -> Dict[str, torch.Tensor]:
    """segtpu SegResNet ``(params, batch_stats)`` -> the port's
    ``state_dict``: ``first_conv.{0,1}``, ``encoder.{li}.{bi}``,
    ``decoder.{si}.{bi}`` (each stage's last block the up or last
    bottleneck) and ``last_conv.{0,1}``."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "first_conv.0", params["backbone_stem_conv"])
    _bn(sd, "first_conv.1", params["backbone_stem_bn"], batch_stats["backbone_stem_bn"])
    for li in range(4):
        bi = 0
        while f"backbone_layer{li + 1}_{bi}" in params:
            name = f"backbone_layer{li + 1}_{bi}"
            _block(sd, f"encoder.{li}.{bi}", params[name], batch_stats[name])
            bi += 1
    for si in range(4):
        bi = 0
        while f"decoder{si + 1}_{bi}" in params:
            name = f"decoder{si + 1}_{bi}"
            _block(sd, f"decoder.{si}.{bi}", params[name], batch_stats[name])
            bi += 1
        last = f"decoder{si + 1}_up" if si < 3 else "decoder4_last"
        _block(sd, f"decoder.{si}.{bi}", params[last], batch_stats[last],
               transposed=si < 3)
    _conv_t(sd, "last_conv.0", params["last_up"])
    _conv(sd, "last_conv.1", params["classifier"])
    return sd


def _prelu(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["alpha"])


def enet_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu ENet ``(params, batch_stats)`` -> the port's ``state_dict``:
    ``initial.*``, ``bottleneckNM.*`` (the upsampling blocks' ``spatil_conv``
    and transposed ``conv2``, the asymmetric pair at ``conv2.{0,1,2,3}``, a
    PReLU's slope where the block has one) and the transposed
    ``fullconv``."""
    sd: Dict[str, torch.Tensor] = {}
    p, s = params["initial"], batch_stats["initial"]
    _conv(sd, "initial.conv", p["conv"])
    _bn(sd, "initial.bn", p["bn"], s["bn"])
    _prelu(sd, "initial.prelu", p["prelu"])
    for name in sorted(k for k in params if k.startswith("bottleneck")):
        p, s = params[name], batch_stats[name]
        upsample = "spatial_conv" in p
        if upsample:
            _conv(sd, f"{name}.spatil_conv", p["spatial_conv"])
            _bn(sd, f"{name}.bn_up", p["bn_up"], s["bn_up"])
        if "conv2a" in p:
            _conv(sd, f"{name}.conv2.0", p["conv2a"])
            _bn(sd, f"{name}.conv2.1", p["bn2a"], s["bn2a"])
            if "prelu2a" in p:
                _prelu(sd, f"{name}.conv2.2", p["prelu2a"])
            _conv(sd, f"{name}.conv2.3", p["conv2b"])
        else:
            (_conv_t if upsample else _conv)(sd, f"{name}.conv2", p["conv2"])
        _conv(sd, f"{name}.conv1", p["conv1"])
        _conv(sd, f"{name}.conv3", p["conv3"])
        for bn in ("bn1", "bn2", "bn3"):
            _bn(sd, f"{name}.{bn}", p[bn], s[bn])
        for act in ("prelu1", "prelu2", "prelu3", "prelu_out"):
            if act in p:
                _prelu(sd, f"{name}.{act}", p[act])
    _conv_t(sd, "fullconv", params["fullconv"])
    return sd


def gcn_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu GCN ``(params, batch_stats)``, either backbone, -> the port's
    ``state_dict``: ``backbone.initial``/``backbone.layerX``,
    ``gcnN.conv{11,12,21,22}``, ``brN.conv{1,2}``, the transposed ``deconN``
    where present, ``final_conv``. The ResnetGCN backbone's GCN layers go
    under ``backbone.layer{3,4}.M.{gcn.*,conv1x1,bn1x1,downsample.{0,1}}``."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    resnet_gcn = "gcn" in bp["layer3_0"]
    _resnet(sd, bp, bs, prefix="backbone.", layers=(1, 2) if resnet_gcn else (1, 2, 3, 4))
    for li in (3, 4) if resnet_gcn else ():
        bi = 0
        while f"layer{li}_{bi}" in bp:
            p, s, t = bp[f"layer{li}_{bi}"], bs[f"layer{li}_{bi}"], f"backbone.layer{li}.{bi}"
            for name in ("11", "12", "21", "22"):
                _conv(sd, f"{t}.gcn.conv{name}", p["gcn"][f"conv{name}"])
                _bn(sd, f"{t}.gcn.bn{name}", p["gcn"][f"bn{name}"], s["gcn"][f"bn{name}"])
            _conv(sd, f"{t}.conv1x1", p["conv1x1"])
            _bn(sd, f"{t}.bn1x1", p["bn1x1"], s["bn1x1"])
            if "downsample_conv" in p:
                _conv(sd, f"{t}.downsample.0", p["downsample_conv"])
                _bn(sd, f"{t}.downsample.1", p["downsample_bn"], s["downsample_bn"])
            bi += 1
    for i in range(1, 5):
        for name in ("conv11", "conv12", "conv21", "conv22"):
            _conv(sd, f"gcn{i}.{name}", params[f"gcn{i}"][name])
    for i in range(1, 10):
        for name in ("conv1", "conv2"):
            _conv(sd, f"br{i}.{name}", params[f"br{i}"][name])
    for i in range(1, 6):
        if f"decon{i}" in params:
            _conv_t(sd, f"decon{i}", params[f"decon{i}"])
    _conv(sd, "final_conv", params["final_conv"])
    return sd


def fcn8_state_dict_from_segtpu(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """segtpu FCN8 ``(params, batch_stats)`` -> the port's ``state_dict``:
    segtpu's VGG ``backbone`` stages at their torchvision ``features``
    indices, sliced as the original's ``pool3``/``pool4``/``pool5`` (after
    the third and fourth pools); ``backbone_conv6``, ``backbone_conv7`` and
    ``backbone_score`` at ``output.{0,3,6}``; ``adj_pool3``, ``adj_pool4``;
    and the fixed bilinear kernels, which segtpu does not store."""
    sd: Dict[str, torch.Tensor] = {}
    bp = params["backbone"]
    name, start, index = "pool3", 0, 0
    for si, widths in enumerate(vgg.VGG16_STAGES):
        for ci in range(len(widths)):
            _conv(sd, f"{name}.{index - start}", bp[f"stage{si + 1}"][f"conv{ci}"])
            index += 2  # the conv and its ReLU
        index += 1  # the stage's pool
        if si in (2, 3):  # the original slices after the third and fourth pools
            name, start = f"pool{si + 2}", index
    for key, t in (("backbone_conv6", "output.0"), ("backbone_conv7", "output.3"),
                   ("backbone_score", "output.6"), ("adj_pool3", "adj_pool3"),
                   ("adj_pool4", "adj_pool4")):
        _conv(sd, t, params[key])
    classes = np.asarray(params["backbone_score"]["kernel"]).shape[-1]
    for t, k in (("up_output", 4), ("up_pool4_out", 4), ("up_final", 16)):
        sd[f"{t}.weight"] = _t(bilinear_kernel(classes, k).numpy())
    return sd


def pspdensenet_state_dict_from_segtpu(params: Dict, batch_stats: Dict
                                       ) -> Dict[str, torch.Tensor]:
    """segtpu PSPDenseNet ``(params, batch_stats)`` -> the port's
    ``state_dict``: the from-scratch stem at ``block0.{0,1,3,4,6,7}``,
    ``blockN.denselayerM.{norm1,conv1,norm2,conv2}``,
    ``transition1.{norm,conv}``, ``transition{2,3}.{0,2}``, and the head and
    aux head under PSPNet's keys."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    for i in range(3):
        _conv(sd, f"block0.{3 * i}", bp[f"stem_conv{i}"])
        _bn(sd, f"block0.{3 * i + 1}", bp[f"stem_bn{i}"], bs[f"stem_bn{i}"])
    for bi in range(1, 5):
        p, s = bp[f"denseblock{bi}"], bs[f"denseblock{bi}"]
        li = 1
        while f"denselayer{li}" in p:
            lp, ls, t = p[f"denselayer{li}"], s[f"denselayer{li}"], f"block{bi}.denselayer{li}"
            for norm, conv in (("norm1", "conv1"), ("norm2", "conv2")):
                _bn(sd, f"{t}.{norm}", lp[norm], ls[norm])
                _conv(sd, f"{t}.{conv}", lp[conv])
            li += 1
    for i, (norm, conv) in ((1, ("norm", "conv")), (2, ("0", "2")), (3, ("0", "2"))):
        p, s = bp[f"transition{i}"], bs[f"transition{i}"]
        _bn(sd, f"transition{i}.{norm}", p["norm"], s["norm"])
        _conv(sd, f"transition{i}.{conv}", p["conv"])
    _psp_head(sd, params, batch_stats)
    return sd

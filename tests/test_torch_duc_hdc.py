"""The port's DeepLab_DUC_HDC against segtpu's on the same weights and
inputs, on the CPU: ResNet-18 and -50 under both HDC plans, output stride 8
and 4 (the stem conv at stride 1), 65 px, where both of segtpu's crops fire
(the decoder's DUC(x2) gives 18 rows against the low-level map's 17, the
DUC(x4) head 68 against the input's 65), batch 2, 5 classes. The checks and
their tolerances are those of ``torch_zoo.py``; besides them, the DUC's
ICNR init and the stem kernel's refusal of ``stem_stride`` 1."""

import functools

import pytest
import torch

from segtpu.models.duc_hdc import DeepLab_DUC_HDC as SegtpuDUC
from segtpu.utils.weight_convert import convert_duc_hdc
from segtpu_torch import train as train_cli
from segtpu_torch.backbones.resnet import ResNetFeatures
from segtpu_torch.models import get_model
from segtpu_torch.models.duc_hdc import DeepLab_DUC_HDC
from segtpu_torch.nn.blocks import DUC
from segtpu_torch.utils.weight_convert import duc_hdc_state_dict_from_segtpu
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, HW, BATCH = 5, 65, 2
# (backbone, output_stride, dilation_bigger)
VARIANTS = [("resnet18", 8, False), ("resnet18", 8, True), ("resnet18", 4, False),
            ("resnet50", 8, False)]


@functools.cache
def _weights(backbone):
    """segtpu variables, BN moved off its init; the output stride and the
    HDC plan change no shape, so one draw a backbone."""
    _, params, stats = _init_segtpu(SegtpuDUC(num_classes=CLASSES, backbone=backbone),
                                    HW, 0)
    return params, stats


def _segtpu(backbone, output_stride, bigger, freeze_bn=False):
    return (SegtpuDUC(num_classes=CLASSES, backbone=backbone, output_stride=output_stride,
                      dilation_bigger=bigger, freeze_bn=freeze_bn), *_weights(backbone))


def _port(params, stats, backbone, output_stride, bigger, **kw):
    model = DeepLab_DUC_HDC(CLASSES, backbone=backbone, output_stride=output_stride,
                            dilation_bigger=bigger, **kw)
    model.load_state_dict(duc_hdc_state_dict_from_segtpu(params, stats), strict=True)
    return model


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_logits_match_segtpu(variant):
    model, params, stats = _segtpu(*variant)
    port = _port(params, stats, *variant)
    sizes = {}

    def keep_size(key):
        def hook(module, args, out):
            sizes[key] = tuple(out.shape[-2:])
        return hook

    hooks = [m.register_forward_hook(keep_size(k)) for k, m in (
        ("duc", port.decoder.DUC), ("ll", port.decoder.bn1), ("head", port.DUC_out))]
    zoo.assert_eval_matches(model, params, stats, port, zoo.images(0, HW, BATCH))
    for h in hooks:
        h.remove()
    # both crops fire: the DUC(x2) output overshoots the low-level map, and
    # the head's the input
    assert sizes["duc"][0] == sizes["ll"][0] + 1 and sizes["head"][0] > HW


@pytest.mark.parametrize("variant", [("resnet18", 8, False), ("resnet18", 4, True)])
def test_train_logits_and_running_stats_match_segtpu(variant):
    model, params, stats = _segtpu(*variant)
    zoo.assert_train_matches64(model, params, stats, _port(params, stats, *variant),
                               duc_hdc_state_dict_from_segtpu, zoo.images(1, HW, BATCH))


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_weights_load_strict_and_round_trip_through_segtpus_converter(backbone):
    _, params, stats = _segtpu(backbone, 8, False)
    port = _port(params, stats, backbone, 8, False)
    sd = zoo.assert_round_trip(params, stats, port, convert_duc_hdc, arch=backbone)
    assert {"backbone.layer0.0.weight", "ASSP.aspp6.0.weight", "decoder.DUC.conv.weight",
            "decoder.output.7.bias", "DUC_out.bn.running_var"} <= set(sd)


def test_parameter_groups_are_segtpus():
    _, params, stats = _segtpu("resnet18", 8, False)
    got = zoo.assert_groups_match(params, _port(params, stats, "resnet18", 8, False))
    assert got["backbone"] > 0 and got["decoder"] > 0


@pytest.fixture(scope="module")
def trajectories():
    model, params, stats = _segtpu("resnet18", 8, False)
    return zoo.trajectories(model, params, stats, _port(params, stats, "resnet18", 8, False),
                            duc_hdc_state_dict_from_segtpu, CLASSES,
                            zoo.batches(zoo.STEPS, HW, BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    seg_snaps, port_snaps = trajectories
    zoo.assert_step_matches(seg_snaps, port_snaps, n_steps)


def test_freeze_bn_uses_and_keeps_the_running_stats(monkeypatch):
    model, params, stats = _segtpu("resnet18", 8, False, freeze_bn=True)
    zoo.assert_freeze_bn_matches(model, params, stats,
                                 _port(params, stats, "resnet18", 8, False, freeze_bn=True),
                                 zoo.images(2, HW, BATCH), monkeypatch)


def test_duc_icnr_init_shares_each_subkernel():
    """Each group of r*r consecutive output channels holds one subkernel,
    drawn N(0, 2/in)."""
    duc = DUC(256, 64, upscale=2)
    from segtpu_torch.nn.layers import init_parameters

    init_parameters(duc, torch.Generator().manual_seed(0))
    w = duc.conv.weight.detach()
    assert w.shape == (256, 256, 1, 1)
    groups = w.view(64, 4, 256)
    assert torch.equal(groups, groups[:, :1].expand_as(groups))
    assert not torch.equal(groups[0, 0], groups[1, 0])
    assert abs(groups[:, 0].std().item() / (2 / 256) ** 0.5 - 1) < 0.05


def test_pallas_stem_wgrad_refuses_stem_stride_1():
    with pytest.raises(ValueError, match="stem_stride 2"):
        ResNetFeatures("resnet18", pallas_stem_wgrad=True, stem_stride=1)
    # stride 1 without the flag builds, and its stem keeps the key layout
    feats = ResNetFeatures("resnet18", stem_stride=1, hdc="rf")
    assert feats.initial[0].stride == (1, 1)
    assert [b.conv1.dilation[0] for b in feats.layer3] == [1, 2]


def test_training_cli_trains_duc_hdc_on_cpu(tmp_path):
    config = zoo.cli_config({"type": "DeepLab_DUC_HDC",
                             "args": {"backbone": "resnet18", "freeze_bn": False}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), DeepLab_DUC_HDC)


def test_get_model_builds_duc_hdc_from_a_seed():
    a = get_model("DeepLab_DUC_HDC", device="cpu", seed=3, num_classes=3,
                  backbone="resnet18")
    b = get_model("DeepLab_DUC_HDC", device="cpu", seed=3, num_classes=3,
                  backbone="resnet18")
    assert a.backbone_modules == ("backbone",)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeepLab_DUC_HDC(3, pretrained=True)

"""The port's GCN against segtpu's on the same weights and inputs, on the
CPU, on ResNet-18: the torchvision backbone with the bilinear decoder and
with the deconv decoder, and the ResnetGCN backbone with the deconv
decoder, each built once for the module. At 33 px the deconv decoder takes
every pad-or-crop of segtpu's (its deconvs give 4, 6, 10 and 36 against
maps of 3, 5, 9 and the input's 33); at 32 none. Batch 2, 5 classes, GCN's
default 11-tap separable convs. The checks and their tolerances are those
of ``torch_zoo.py``. segtpu has no converter for the ResnetGCN backbone, so
its variables come in through the port's ``gcn_state_dict_from_segtpu``
alone, with no round trip.

The ResnetGCN variant's train mode is held at 33 px: at 32 its layer4 map
is 1x1, and a BN over the batch's 2 values loses segtpu 8 digits even in
float64 (E[x^2] - mean^2; ROADMAP queue 3)."""

import functools

import numpy as np
import pytest
import torch

from segtpu.models.gcn import GCN as SegtpuGCN
from segtpu.utils.weight_convert import convert_gcn
from segtpu_torch import train as train_cli
from segtpu_torch.models import gcn, get_model
from segtpu_torch.models.gcn import GCN
from segtpu_torch.utils.weight_convert import gcn_state_dict_from_segtpu
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH, HW = 5, 2, 33
VARIANTS = {"interpolate": {}, "deconv": {"use_deconv": True},
            "resnet_gcn-deconv": {"use_resnet_gcn": True, "use_deconv": True}}


def _segtpu_model(variant, **kw):
    return SegtpuGCN(num_classes=CLASSES, backbone="resnet18", **VARIANTS[variant], **kw)


@functools.cache
def _weights(variant):
    """segtpu's variables; the interpolate variant's are the deconv
    variant's without ``decon1``-``decon5`` (one init for both)."""
    if variant == "interpolate":
        params, stats = _weights("deconv")
        return {k: v for k, v in params.items() if not k.startswith("decon")}, stats
    _, params, stats = _init_segtpu(_segtpu_model(variant), HW, 0)
    return params, stats


def _port(variant, **kw):
    model = GCN(CLASSES, backbone="resnet18", **VARIANTS[variant], **kw)
    model.load_state_dict(gcn_state_dict_from_segtpu(*_weights(variant)), strict=True)
    return model


@pytest.fixture(scope="module")
def ports():
    return {variant: _port(variant) for variant in VARIANTS}


@pytest.mark.parametrize("variant,hw", [("interpolate", 33), ("interpolate", 32),
                                        ("deconv", 33), ("deconv", 32),
                                        ("resnet_gcn-deconv", 33)])
def test_eval_logits_match_segtpu(variant, hw, ports):
    zoo.assert_eval_matches(_segtpu_model(variant), *_weights(variant), ports[variant],
                            zoo.images(0, hw, BATCH))


@pytest.mark.parametrize("variant,hw", [("interpolate", 33), ("deconv", 33),
                                        ("deconv", 32), ("resnet_gcn-deconv", 33)])
def test_train_logits_and_running_stats_match_segtpu(variant, hw):
    zoo.assert_train_matches64(_segtpu_model(variant), *_weights(variant), _port(variant),
                               gcn_state_dict_from_segtpu, zoo.images(1, hw, BATCH))


@pytest.mark.parametrize("hw,want", [
    (33, [(3, 3, 4, 4), (5, 5, 6, 6), (9, 9, 10, 10), (33, 33, 36, 36)]), (32, [])])
def test_deconv_decoder_takes_segtpus_pad_or_crop_at_odd_sizes(hw, want, ports,
                                                               monkeypatch):
    """(target h, w, given h, w) of every alignment that changes a size, in
    order."""
    seen = []
    align = gcn.pad_or_crop_tl

    def spy(x, h, w):
        if (h, w) != tuple(x.shape[-2:]):
            seen.append((h, w, *x.shape[-2:]))
        return align(x, h, w)

    # the model calls the alignment through its attribute (core/spatial.py
    # swaps it)
    monkeypatch.setattr(gcn.GCN, "_pad_or_crop", staticmethod(spy))
    with torch.no_grad():
        out = ports["deconv"].eval()(torch.zeros(1, 3, hw, hw))["out"]
    assert out.shape == (1, CLASSES, hw, hw)
    assert seen == want


@pytest.mark.parametrize("variant", ["interpolate", "deconv"])
def test_weights_load_strict_and_round_trip_through_segtpus_converter(variant, ports):
    sd = zoo.assert_round_trip(*_weights(variant), ports[variant], convert_gcn,
                               arch="resnet18")
    assert {"backbone.initial.0.weight", "backbone.initial.1.running_mean",
            "backbone.layer4.1.conv2.weight", "gcn4.conv11.bias", "gcn1.conv22.weight",
            "br9.conv2.bias", "final_conv.bias"} <= set(sd)
    assert sd["gcn1.conv11.weight"].shape == (CLASSES, 64, 11, 1)
    assert sd["gcn1.conv12.weight"].shape == (CLASSES, CLASSES, 1, 11)
    decons = {f"decon{i}.weight" for i in range(1, 6)}
    assert decons <= set(sd) if variant == "deconv" else not decons & set(sd)


def test_resnet_gcn_weights_load_strict_under_the_originals_names(ports):
    """The variables go in through the port's converter (segtpu has none for
    this backbone): every port key is filled, with the original's names, and
    layer4's six blocks are independent and 2048 wide (segtpu's
    divergence)."""
    sd = gcn_state_dict_from_segtpu(*_weights("resnet_gcn-deconv"))
    port_sd = ports["resnet_gcn-deconv"].state_dict()
    assert set(sd) == set(port_sd)
    assert all(torch.equal(sd[k], port_sd[k]) for k in sd)
    assert {"backbone.initial.0.weight", "backbone.layer2.1.conv2.weight",
            "backbone.layer3.0.downsample.0.bias", "backbone.layer3.5.gcn.conv22.weight",
            "backbone.layer3.5.gcn.bn21.running_var", "backbone.layer4.0.conv1x1.weight",
            "backbone.layer4.5.bn1x1.weight", "decon5.weight"} <= set(sd)
    assert not any(k.startswith("backbone.layer4.1.downsample") for k in sd)
    assert sd["backbone.layer3.0.gcn.conv11.weight"].shape == (85, 128, 5, 1)
    assert sd["backbone.layer4.5.gcn.conv11.weight"].shape == (128, 2048, 7, 1)
    assert sd["backbone.layer4.5.conv1x1.weight"].shape == (2048, 128, 1, 1)
    assert not torch.equal(sd["backbone.layer4.1.gcn.conv11.weight"],
                           sd["backbone.layer4.2.gcn.conv11.weight"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_parameter_groups_are_segtpus(variant, ports):
    got = zoo.assert_groups_match(_weights(variant)[0], ports[variant])
    assert got["backbone"] > 0 and got["decoder"] > 0


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def trajectories(request):
    variant = request.param
    return zoo.trajectories(_segtpu_model(variant), *_weights(variant), _port(variant),
                            gcn_state_dict_from_segtpu, CLASSES,
                            zoo.batches(zoo.STEPS, HW, BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    zoo.assert_step_matches(*trajectories, n_steps)


def test_freeze_bn_uses_and_keeps_the_running_stats(monkeypatch):
    zoo.assert_freeze_bn_matches(_segtpu_model("deconv", freeze_bn=True),
                                 *_weights("deconv"), _port("deconv", freeze_bn=True),
                                 zoo.images(2, HW, BATCH), monkeypatch)


@pytest.mark.parametrize("variant", ["interpolate", "resnet_gcn-deconv"])
def test_training_cli_trains_gcn_on_cpu(variant, tmp_path):
    config = zoo.cli_config({"type": "GCN", "args": {"backbone": "resnet18",
                                                     **VARIANTS[variant]}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), GCN)


def test_get_model_builds_gcn_from_a_seed():
    a = get_model("GCN", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    b = get_model("GCN", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone_modules == ("backbone",)
    # segtpu's final_conv bias starts at zero
    assert not a.final_conv.bias.any()
    zoo.assert_pretrained_only_recorded(a, "GCN", seed=3, num_classes=3, backbone="resnet18")
    assert np.isfinite(a.eval()(torch.zeros(1, 3, 33, 33))["out"].detach().numpy()).all()

"""The port's SegNet and SegResNet against segtpu's on the same weights and
inputs, on the CPU, at full width and depth (segtpu has no knob for
either), each built once for the module. SegNet at 33 px, whose
ceil-mode pools and unpools run on odd sizes (33 -> 17 -> 9 -> 5 -> 3 ->
2). SegResNet at 65 px, whose pooled grid is odd (65 -> 33 -> 17: the
ceil-crop's odd branch, the centre crop and both trims), and at 72, whose
grid is even (72 -> 36 -> 18, the decoder giving 24: the even branch).
Batch 2, 5 classes. The checks and their tolerances are those of
``torch_zoo.py``; the stem pool's repeated indices are counted in the
SegResNet step."""

import functools

import numpy as np
import pytest
import torch

from segtpu.models.segnet import SegNet as SegtpuSegNet
from segtpu.models.segnet import SegResNet as SegtpuSegResNet
from segtpu.utils.weight_convert import convert_segnet, convert_segresnet
from segtpu_torch import train as train_cli
from segtpu_torch.models import get_model, segnet
from segtpu_torch.models.segnet import SegNet, SegResNet
from segtpu_torch.utils.weight_convert import (segnet_state_dict_from_segtpu,
                                               segresnet_state_dict_from_segtpu)
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH = 5, 2
FAMILY = {"SegNet": (SegtpuSegNet, SegNet, segnet_state_dict_from_segtpu, convert_segnet),
          "SegResNet": (SegtpuSegResNet, SegResNet, segresnet_state_dict_from_segtpu,
                        convert_segresnet)}
HW = {"SegNet": 33, "SegResNet": 65}


@functools.cache
def _weights(name):
    _, params, stats = _init_segtpu(FAMILY[name][0](num_classes=CLASSES), HW[name], 0)
    return params, stats


def _segtpu(name, freeze_bn=False):
    return (FAMILY[name][0](num_classes=CLASSES, freeze_bn=freeze_bn), *_weights(name))


def _port(name, params, stats, **kw):
    model = FAMILY[name][1](CLASSES, **kw)
    model.load_state_dict(FAMILY[name][2](params, stats), strict=True)
    return model


@pytest.fixture(scope="module")
def ports():
    """One port of each model, loaded with segtpu's weights."""
    return {name: _port(name, *_weights(name)) for name in FAMILY}


@pytest.mark.parametrize("name,hw", [("SegNet", 33), ("SegNet", 32),
                                     ("SegResNet", 65), ("SegResNet", 72)])
def test_eval_logits_match_segtpu(name, hw, ports):
    model, params, stats = _segtpu(name)
    zoo.assert_eval_matches(model, params, stats, ports[name], zoo.images(0, hw, BATCH))


def test_vgg16_bn_encoder_matches_segtpus(ports):
    """SegNet's encoder stages alone: their bottom and pre-pool sizes are
    segtpu's ``VGG16BNEncoderWithIndices``'s on SegNet's encoder weights
    (eval)."""
    import jax.numpy as jnp
    from segtpu.backbones.vgg import VGG16BNEncoderWithIndices as SegtpuEncoder
    from segtpu_torch.backbones.vgg import run_with_indices
    from torch_parity import nchw, nhwc, rel_max

    params, stats = _weights("SegNet")
    x = zoo.images(3, 33, BATCH)
    want, want_saved = SegtpuEncoder().apply(
        {"params": params["backbone"], "batch_stats": stats["backbone"]},
        jnp.asarray(x), train=False)
    port = ports["SegNet"].eval()
    with torch.no_grad():
        got, saved = run_with_indices(
            [getattr(port, name) for name in port.backbone_modules], nchw(x))
    assert rel_max(nhwc(got), want) < zoo.TOL
    assert [tuple(size) for _, size in saved] == [hw for _, hw in want_saved]


def test_segresnet_epilogue_takes_both_crop_branches(ports, monkeypatch):
    """At 65 the decoder's 24 rows are cropped to the odd grid of 17 and
    the 68-row output to 65; at 72 the 24 rows to the even grid of 18."""
    seen = []
    unpool = segnet.max_unpool_flat

    def spy(y, idx, output_hw):
        seen.append((tuple(y.shape[-2:]), tuple(idx.shape[-2:]), tuple(output_hw)))
        return unpool(y, idx, output_hw)

    monkeypatch.setattr(segnet, "max_unpool_flat", spy)
    with torch.no_grad():
        for hw in (65, 72):
            ports["SegResNet"].eval()(torch.zeros(1, 3, hw, hw))
    assert seen == [((17, 17), (17, 17), (34, 34)), ((18, 18), (18, 18), (36, 36))]


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_train_logits_and_running_stats_match_segtpu(name):
    model, params, stats = _segtpu(name)
    zoo.assert_train_matches64(model, params, stats, _port(name, params, stats),
                               FAMILY[name][2], zoo.images(1, HW[name], BATCH))


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_weights_load_strict_and_round_trip_through_segtpus_converter(name, ports):
    params, stats = _weights(name)
    sd = zoo.assert_round_trip(params, stats, ports[name], FAMILY[name][3])
    if name == "SegNet":
        assert {"stage1_encoder.0.bias", "stage5_encoder.7.running_var",
                "stage1_decoder.6.weight", "stage5_decoder.6.bias"} <= set(sd)
    else:
        assert {"first_conv.0.weight", "encoder.3.0.downsample.0.weight",
                "decoder.0.2.conv2.weight", "decoder.3.2.downsample.1.weight",
                "last_conv.0.weight", "last_conv.1.bias"} <= set(sd)
        # the up blocks' conv2 and shortcut are transposed: (in, out, 2, 2)
        assert sd["decoder.0.2.downsample.0.weight"].shape == (2048, 1024, 2, 2)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_parameter_groups_are_segtpus(name, ports):
    """segtpu labels SegNet's VGG encoder ``backbone`` (its code; its
    docstring says SegNet lands in the decoder), and SegResNet's
    ``backbone_*`` stem and layers."""
    got = zoo.assert_groups_match(_weights(name)[0], ports[name])
    assert got["backbone"] > 0 and got["decoder"] > 0


@pytest.fixture(scope="module", params=sorted(FAMILY))
def trajectories(request):
    name = request.param
    model, params, stats = _segtpu(name)
    return zoo.trajectories(model, params, stats, _port(name, params, stats),
                            FAMILY[name][2], CLASSES,
                            zoo.batches(zoo.STEPS, HW[name], BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    seg_snaps, port_snaps = trajectories
    zoo.assert_step_matches(seg_snaps, port_snaps, n_steps)


def test_segresnet_stem_pool_repeats_indices_on_the_step_batches(ports):
    """The steps' inputs give the stem pool repeated indices, so the
    unpool's winner rule is exercised by the step test."""
    x = torch.from_numpy(zoo.batches(1, HW["SegResNet"], BATCH, CLASSES)[0][0]).float()
    from segtpu_torch.ops.pooling import max_pool_argmax_flat

    port = ports["SegResNet"].train()
    with torch.no_grad():
        _, idx = max_pool_argmax_flat(port.first_conv(x.permute(0, 3, 1, 2)))
    flat = idx.flatten(2)
    repeats = sum(flat.shape[2] - len(torch.unique(row)) for row in flat.flatten(0, 1))
    assert repeats > 0


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_freeze_bn_uses_and_keeps_the_running_stats(name, monkeypatch):
    model, params, stats = _segtpu(name, freeze_bn=True)
    zoo.assert_freeze_bn_matches(model, params, stats,
                                 _port(name, params, stats, freeze_bn=True),
                                 zoo.images(2, HW[name], BATCH), monkeypatch)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_training_cli_trains_segnet_on_cpu(name, tmp_path):
    config = zoo.cli_config({"type": name, "args": {"freeze_bn": False}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), FAMILY[name][1])


def test_get_model_builds_segnet_from_a_seed():
    a = get_model("SegResNet", device="cpu", seed=3, num_classes=3)
    b = get_model("SegResNet", device="cpu", seed=3, num_classes=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone_modules == ("first_conv", "encoder")
    assert SegNet.backbone_modules == tuple(f"stage{i}_encoder" for i in range(1, 6))
    zoo.assert_pretrained_only_recorded(a, "SegResNet", seed=3, num_classes=3)
    assert SegNet(3, pretrained=True).pretrained is True
    assert np.isfinite(a.eval()(torch.zeros(1, 3, 33, 33))["out"].detach().numpy()).all()

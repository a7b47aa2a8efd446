"""The port's ENet against segtpu's on the same weights and inputs, on the
CPU, at full width and depth (segtpu has no knob for either), built once
for the module. At 33 px every alignment of segtpu's is taken: the stage-1
and stage-2 downsamples pad the 2x2/2 conv's output at the top and left
onto the ceil-mode pool's (8 onto 9, 4 onto 5), the two upsamples crop
the transposed convs' 10 and 18 onto the unpooled 9 and 17, and the last
transposed conv's 34 is cropped to 33; at 32 none is. Batch 2, 5 classes. The checks and
their tolerances are those of ``torch_zoo.py``."""

import functools

import numpy as np
import pytest
import torch

from segtpu.models.enet import ENet as SegtpuENet
from segtpu.utils.weight_convert import convert_enet
from segtpu_torch import train as train_cli
from segtpu_torch.models import enet, get_model
from segtpu_torch.models.enet import ENet
from segtpu_torch.utils.weight_convert import enet_state_dict_from_segtpu
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH, HW = 5, 2, 33


@functools.cache
def _weights():
    _, params, stats = _init_segtpu(SegtpuENet(num_classes=CLASSES), HW, 0)
    return params, stats


def _port(params, stats, **kw):
    model = ENet(CLASSES, **kw)
    model.load_state_dict(enet_state_dict_from_segtpu(params, stats), strict=True)
    return model


@pytest.fixture(scope="module")
def port():
    return _port(*_weights())


@pytest.mark.parametrize("hw", [33, 32])
def test_eval_logits_match_segtpu(hw, port):
    zoo.assert_eval_matches(SegtpuENet(num_classes=CLASSES), *_weights(), port,
                            zoo.images(0, hw, BATCH))


@pytest.mark.parametrize("hw", [33, 32])
def test_train_logits_and_running_stats_match_segtpu(hw):
    params, stats = _weights()
    zoo.assert_train_matches64(SegtpuENet(num_classes=CLASSES), params, stats,
                               _port(params, stats), enet_state_dict_from_segtpu,
                               zoo.images(1, hw, BATCH))


@pytest.mark.parametrize("hw,want", [
    (33, [(9, 9, 8, 8), (5, 5, 4, 4), (9, 9, 10, 10), (17, 17, 18, 18)]), (32, [])])
def test_odd_sizes_take_segtpus_pad_and_crop_branches(hw, want, port, monkeypatch):
    """(target h, w, given h, w) of every alignment that changes a size, in
    order: the two downsamples pad, the two upsamples crop."""
    seen = []
    align = enet.pad_or_crop_tl

    def spy(x, h, w):
        if (h, w) != tuple(x.shape[-2:]):
            seen.append((h, w, *x.shape[-2:]))
        return align(x, h, w)

    # the model calls the alignment through its attribute (core/spatial.py
    # swaps it)
    monkeypatch.setattr(enet.Bottleneck, "_pad_or_crop", staticmethod(spy))
    with torch.no_grad():
        out = port.eval()(torch.zeros(1, 3, hw, hw))["out"]
    assert out.shape == (1, CLASSES, hw, hw)
    assert seen == want


def test_weights_load_strict_and_round_trip_through_segtpus_converter(port):
    params, stats = _weights()
    sd = zoo.assert_round_trip(params, stats, port, convert_enet)
    assert {"initial.conv.bias", "initial.prelu.weight", "bottleneck10.conv1.weight",
            "bottleneck23.conv2.0.bias", "bottleneck23.conv2.2.weight",
            "bottleneck23.conv2.3.weight", "bottleneck40.spatil_conv.weight",
            "bottleneck40.bn_up.running_var", "bottleneck38.prelu_out.weight",
            "fullconv.weight"} <= set(sd)
    # PReLU: 16 slopes in the initial block, one per slope of a stage 1-3
    # block, none in stages 4 and 5 (ReLU)
    assert sd["initial.prelu.weight"].shape == (16,)
    assert sd["bottleneck11.prelu1.weight"].shape == (1,)
    assert not any(k.startswith(("bottleneck4", "bottleneck5")) and "prelu" in k
                   for k in sd)
    # the transposed convs are (in, out, 3, 3)
    assert sd["bottleneck50.conv2.weight"].shape == (16, 16, 3, 3)
    assert sd["fullconv.weight"].shape == (16, CLASSES, 3, 3)


def test_parameter_groups_are_segtpus(port):
    """ENet has no ``backbone``: every parameter is the decoder's."""
    got = zoo.assert_groups_match(_weights()[0], port)
    assert got["backbone"] == 0 and got["decoder"] > 0


@pytest.fixture(scope="module")
def trajectories():
    params, stats = _weights()
    return zoo.trajectories(SegtpuENet(num_classes=CLASSES), params, stats,
                            _port(params, stats), enet_state_dict_from_segtpu, CLASSES,
                            zoo.batches(zoo.STEPS, HW, BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    zoo.assert_step_matches(*trajectories, n_steps)


def test_freeze_bn_uses_and_keeps_the_running_stats(monkeypatch):
    params, stats = _weights()
    zoo.assert_freeze_bn_matches(SegtpuENet(num_classes=CLASSES, freeze_bn=True), params,
                                 stats, _port(params, stats, freeze_bn=True),
                                 zoo.images(2, HW, BATCH), monkeypatch)


def test_training_cli_trains_enet_on_cpu(tmp_path):
    config = zoo.cli_config({"type": "ENet", "args": {"freeze_bn": False}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), ENet)


def test_get_model_builds_enet_from_a_seed():
    a = get_model("ENet", device="cpu", seed=3, num_classes=3)
    b = get_model("ENet", device="cpu", seed=3, num_classes=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone_modules == ()
    # every PReLU starts at 0.25, as torch's and segtpu's
    assert all(bool((m.weight == 0.25).all()) for m in a.modules()
               if isinstance(m, torch.nn.PReLU))
    drops = [m.p for m in a.modules() if isinstance(m, torch.nn.Dropout2d)]
    assert drops == [0.01] * 5 + [0.1] * 22
    with pytest.raises(TypeError):
        ENet(3, pretrained=False)
    assert np.isfinite(a.eval()(torch.zeros(1, 3, 33, 33))["out"].detach().numpy()).all()

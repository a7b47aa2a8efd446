"""The port's FCN8 against segtpu's on the same weights and inputs, on the
CPU. One fp32 eval forward at VGG-16's real widths (and FC6/FC7's 4096);
the other checks on VGG stages narrowed to 8 and 16 channels, set at run
time in ``segtpu.backbones.vgg.VGG16_STAGES`` and in the port's
``segtpu_torch.backbones.vgg.VGG16_STAGES`` alike (nothing in segtpu
changes), which keeps the float64 steps light; FC6 and FC7 stay 4096 wide
on both sides. 33 px (the first conv's 231, pools 116, 58, 29, 15, 8, FC6
2), batch 2, 5 classes; the checks and their tolerances are those of
``torch_zoo.py``. FCN8 has no BN, so there is no running statistic and no
``freeze_bn`` check."""

import functools

import numpy as np
import pytest
import torch

import segtpu.backbones.vgg as segtpu_vgg
from segtpu.models.fcn import FCN8 as SegtpuFCN8
from segtpu.utils.weight_convert import convert_fcn8
import segtpu_torch.backbones.vgg as port_vgg
from segtpu_torch import train as train_cli
from segtpu_torch.core.state import make_optimizer
from segtpu_torch.models import get_model
from segtpu_torch.models.fcn import FCN8
from segtpu_torch.nn.layers import bilinear_kernel
from segtpu_torch.utils.weight_convert import fcn8_state_dict_from_segtpu
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH, HW = 5, 2, 33
NARROW = ((8, 8), (8, 8), (16, 16, 16), (16, 16, 16), (16, 16, 16))
UPSAMPLERS = ("up_output", "up_pool4_out", "up_final")


@pytest.fixture
def narrow(monkeypatch):
    """Both sides' VGG stages narrowed for the test."""
    monkeypatch.setattr(segtpu_vgg, "VGG16_STAGES", NARROW)
    monkeypatch.setattr(port_vgg, "VGG16_STAGES", NARROW)


@functools.cache
def _weights(stages):
    """segtpu's variables at ``stages`` (built while they are in force)."""
    assert segtpu_vgg.VGG16_STAGES == stages == port_vgg.VGG16_STAGES
    _, params, stats = _init_segtpu(SegtpuFCN8(num_classes=CLASSES), HW, 0)
    return params, stats


def _port(params, stats):
    model = FCN8(CLASSES)
    model.load_state_dict(fcn8_state_dict_from_segtpu(params, stats), strict=True)
    return model


def test_eval_logits_match_segtpu_at_full_width():
    _, params, stats = _init_segtpu(SegtpuFCN8(num_classes=CLASSES), HW, 0)
    port = _port(params, stats)
    assert port.pool5[4].weight.shape == (512, 512, 3, 3)
    assert port.output[0].weight.shape == (4096, 512, 7, 7)
    zoo.assert_eval_matches(SegtpuFCN8(num_classes=CLASSES), params, stats, port,
                            zoo.images(0, HW, BATCH))


@pytest.mark.parametrize("hw", [33, 32])
def test_eval_logits_match_segtpu(hw, narrow):
    params, stats = _weights(NARROW)
    zoo.assert_eval_matches(SegtpuFCN8(num_classes=CLASSES), params, stats,
                            _port(params, stats), zoo.images(0, hw, BATCH))


def test_train_logits_match_segtpu(narrow):
    params, stats = _weights(NARROW)
    zoo.assert_train_matches64(SegtpuFCN8(num_classes=CLASSES), params, stats,
                               _port(params, stats), fcn8_state_dict_from_segtpu,
                               zoo.images(1, HW, BATCH), has_bn=False)


def test_sizes_at_769_are_the_originals(narrow):
    """The first conv's 967, pools 484/242/121/61/31, FC6's 25, the
    upsamplers' 52, 106 and 856, the crop to 769."""
    model = FCN8(CLASSES).eval()
    seen = {}
    for name in ("pool3", "pool4", "pool5", "output", *UPSAMPLERS):
        getattr(model, name).register_forward_hook(
            lambda m, a, out, name=name: seen.__setitem__(name, out.shape[-1]))
    first = {}
    model.pool3[0].register_forward_hook(lambda m, a, out: first.__setitem__("conv", out.shape[-1]))
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 769, 769))["out"]
    assert out.shape == (1, CLASSES, 769, 769)
    assert first["conv"] == 967
    assert seen == {"pool3": 121, "pool4": 61, "pool5": 31, "output": 25,
                    "up_output": 52, "up_pool4_out": 106, "up_final": 856}
    pools = [m for m in model.modules() if isinstance(m, torch.nn.MaxPool2d)]
    assert len(pools) == 5 and all(m.ceil_mode for m in pools)


def test_weights_load_strict_and_round_trip_through_segtpus_converter(narrow):
    params, stats = _weights(NARROW)
    sd = zoo.assert_round_trip(params, stats, _port(params, stats), convert_fcn8)
    assert {f"pool3.{i}.weight" for i in (0, 2, 5, 7, 10, 12, 14)} <= set(sd)
    assert {f"{p}.{i}.bias" for p in ("pool4", "pool5") for i in (0, 2, 4)} <= set(sd)
    assert {f"output.{i}.weight" for i in (0, 3, 6)} <= set(sd)
    assert {"adj_pool3.weight", "adj_pool4.bias"} <= set(sd)
    assert {f"{u}.weight" for u in UPSAMPLERS} <= set(sd)
    assert sd["output.3.weight"].shape == (4096, 4096, 1, 1)


def test_fixed_upsamplers_are_in_no_group_and_no_step_changes_them(narrow):
    """The bilinear kernels (diagonal across classes) are buffers: in the
    state dict under the original's keys, in no parameter group, and
    bit-identical after three SGD steps, while every parameter moves."""
    params, stats = _weights(NARROW)
    port = _port(params, stats)
    opt, _ = make_optimizer(port, **zoo.SGD)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    assert len(in_groups) == len(list(port.parameters()))
    for name in UPSAMPLERS:
        weight = getattr(port, name).weight
        assert id(weight) not in in_groups and not weight.requires_grad
        assert f"{name}.weight" not in dict(port.named_parameters())
    assert torch.equal(port.up_final.weight, bilinear_kernel(CLASSES, 16))
    off_diagonal = port.up_output.weight.clone()
    off_diagonal[range(CLASSES), range(CLASSES)] = 0
    assert not off_diagonal.any() and port.up_output.weight[0, 0].sum() == 4.0
    snaps = zoo.port_trajectory(port, zoo.batches(zoo.STEPS, HW, BATCH, CLASSES))
    (_, first), (_, last) = snaps[0], snaps[-1]
    for name in UPSAMPLERS:
        assert torch.equal(first[f"{name}.weight"], last[f"{name}.weight"]), name
    for name, _ in port.named_parameters():
        assert not torch.equal(first[name], last[name]), name


def test_parameter_groups_are_segtpus(narrow):
    """segtpu labels ``backbone`` and every ``backbone_*`` name backbone:
    FC6, FC7 and the score conv train at lr/10 beside VGG; ``adj_pool3`` and
    ``adj_pool4`` are the decoder."""
    params, stats = _weights(NARROW)
    port = _port(params, stats)
    got = zoo.assert_groups_match(params, port)
    adj = sum(p.numel() for n, p in port.named_parameters() if n.startswith("adj_pool"))
    assert got["decoder"] == adj and got["backbone"] > 0


@pytest.fixture
def trajectories(narrow):
    return _trajectories()


@functools.cache
def _trajectories():
    params, stats = _weights(NARROW)
    return zoo.trajectories(SegtpuFCN8(num_classes=CLASSES), params, stats,
                            _port(params, stats), fcn8_state_dict_from_segtpu, CLASSES,
                            zoo.batches(zoo.STEPS, HW, BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    zoo.assert_step_matches(*trajectories, n_steps)


def test_training_cli_trains_fcn8_on_cpu(tmp_path, narrow):
    config = zoo.cli_config({"type": "FCN8", "args": {}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), FCN8)


def test_get_model_builds_fcn8_from_a_seed(narrow):
    a = get_model("FCN8", device="cpu", seed=3, num_classes=3)
    b = get_model("FCN8", device="cpu", seed=3, num_classes=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone_modules == ("pool3", "pool4", "pool5", "output")
    drops = [m for m in a.modules() if isinstance(m, torch.nn.modules.dropout._DropoutNd)]
    assert [type(m) for m in drops] == [torch.nn.Dropout] * 2 and drops[0].p == 0.5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FCN8(3, pretrained=True)
    assert np.isfinite(a.eval()(torch.zeros(1, 3, 33, 33))["out"].detach().numpy()).all()


#: each registry name's smallest configuration (FCN8, UNet, SegNet,
#: SegResNet and ENet have no backbone knob)
ZOO = {"PSPNet": {"backbone": "resnet18"}, "PSPDenseNet": {"backbone": "densenet121"},
       "UperNet": {"backbone": "resnet18"}, "DeepLab": {"backbone": "resnet18"},
       "DeepLab_DUC_HDC": {"backbone": "resnet18"}, "UNet": {},
       "UNetResnet": {"backbone": "resnet18"}, "SegNet": {}, "SegResNet": {},
       "ENet": {}, "GCN": {"backbone": "resnet18"}, "FCN8": {}}


def test_the_registry_holds_segtpus_twelve_names():
    from segtpu.models import MODELS as SEGTPU_MODELS
    from segtpu_torch.models import MODELS

    assert set(MODELS) == set(SEGTPU_MODELS) == set(ZOO)
    with pytest.raises(KeyError, match="available"):
        get_model("FCN32", device="cpu", num_classes=3)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_get_model_builds_every_registry_name(name):
    from segtpu_torch.models import MODELS

    model = get_model(name, device="cpu", seed=1, num_classes=3, **ZOO[name])
    assert type(model) is MODELS[name]
    assert sum(p.numel() for p in model.parameters()) > 0

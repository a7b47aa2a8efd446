"""The port's UNet and UNetResnet against segtpu's on the same weights and
inputs, on the CPU. UNet at full width (segtpu has no width or depth knob)
at 33 px, where every decoder stage's transposed conv overshoots its skip
by one (33 -> 17 -> 9 -> 5 -> 3 pooled, 6 against 5, ...) and takes the
align-corners resize, as at 769; and at 32, where none does. UNetResnet
with ResNet-18 at 65 px (the resizes onto the skips and the last one onto
the input) and with ResNet-50 (deep base) at 33. Batch 2, 5 classes. The
checks and their tolerances are those of ``torch_zoo.py``."""

import functools

import pytest
import torch

from segtpu.models.unet import UNet as SegtpuUNet
from segtpu.models.unet import UNetResnet as SegtpuUNetResnet
from segtpu.utils.weight_convert import convert_unet, convert_unet_resnet
from segtpu_torch import train as train_cli
from segtpu_torch.models import get_model
from segtpu_torch.models.unet import UNet, UNetResnet
from segtpu_torch.utils.weight_convert import (unet_resnet_state_dict_from_segtpu,
                                               unet_state_dict_from_segtpu)
from torch_parity import _init_segtpu
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH = 5, 2


@functools.cache
def _weights(backbone):
    """segtpu variables, BN moved off its init; ``backbone`` None is UNet."""
    if backbone is None:
        model = SegtpuUNet(num_classes=CLASSES)
    else:
        model = SegtpuUNetResnet(num_classes=CLASSES, backbone=backbone)
    _, params, stats = _init_segtpu(model, 33, 0)
    return params, stats


def _segtpu(backbone, freeze_bn=False):
    if backbone is None:
        model = SegtpuUNet(num_classes=CLASSES, freeze_bn=freeze_bn)
    else:
        model = SegtpuUNetResnet(num_classes=CLASSES, backbone=backbone,
                                 freeze_bn=freeze_bn)
    return (model, *_weights(backbone))


def _convert(backbone):
    return unet_state_dict_from_segtpu if backbone is None else \
        unet_resnet_state_dict_from_segtpu


def _port(params, stats, backbone, **kw):
    model = (UNet(CLASSES, **kw) if backbone is None
             else UNetResnet(CLASSES, backbone=backbone, **kw))
    model.load_state_dict(_convert(backbone)(params, stats), strict=True)
    return model


@pytest.mark.parametrize("backbone,hw", [(None, 33), (None, 32), ("resnet18", 65),
                                         ("resnet18", 64), ("resnet50", 33)])
def test_eval_logits_match_segtpu(backbone, hw):
    model, params, stats = _segtpu(backbone)
    port = _port(params, stats, backbone)
    resized = []
    if backbone is None:  # count the decoder stages whose upsample misses the skip
        for dec in (port.up1, port.up2, port.up3, port.up4):
            dec.up.register_forward_hook(lambda m, a, out: resized.append(out.shape[-1]))
    zoo.assert_eval_matches(model, params, stats, port, zoo.images(0, hw, BATCH))
    if backbone is None:
        odd = [6, 10, 18, 34]
        assert resized == (odd if hw == 33 else [4, 8, 16, 32])


@pytest.mark.parametrize("backbone,hw", [(None, 33), ("resnet18", 65)])
def test_train_logits_and_running_stats_match_segtpu(backbone, hw):
    model, params, stats = _segtpu(backbone)
    zoo.assert_train_matches64(model, params, stats, _port(params, stats, backbone),
                               _convert(backbone), zoo.images(1, hw, BATCH))


def test_unet_weights_load_strict_and_round_trip_through_segtpus_converter():
    _, params, stats = _segtpu(None)
    sd = zoo.assert_round_trip(params, stats, _port(params, stats, None), convert_unet)
    assert {"start_conv.0.weight", "down4.down_conv.4.running_var", "up1.up.weight",
            "up4.up.bias", "up4.up_conv.3.weight", "final_conv.bias"} <= set(sd)
    assert sd["up1.up.weight"].shape == (1024, 512, 2, 2)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_unet_resnet_weights_load_strict_and_round_trip_through_segtpus_converter(backbone):
    _, params, stats = _segtpu(backbone)
    sd = zoo.assert_round_trip(params, stats, _port(params, stats, backbone),
                               convert_unet_resnet, arch=backbone)
    assert {"conv1.bias", "upconv5.weight", "conv7.weight", "layer4.1.bn2.weight"} <= set(sd)
    assert "upconv1.bias" not in sd and "conv7.bias" not in sd
    assert ("initial.0.0.weight" in sd) == (backbone == "resnet50")


@pytest.mark.parametrize("backbone", [None, "resnet18"])
def test_parameter_groups_are_segtpus(backbone):
    _, params, stats = _segtpu(backbone)
    got = zoo.assert_groups_match(params, _port(params, stats, backbone))
    assert (got["backbone"] == 0) == (backbone is None)


@pytest.fixture(scope="module", params=[(None, 33), ("resnet18", 65)],
                ids=["UNet", "UNetResnet"])
def trajectories(request):
    backbone, hw = request.param
    model, params, stats = _segtpu(backbone)
    return zoo.trajectories(model, params, stats, _port(params, stats, backbone),
                            _convert(backbone), CLASSES,
                            zoo.batches(zoo.STEPS, hw, BATCH, CLASSES))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    seg_snaps, port_snaps = trajectories
    zoo.assert_step_matches(seg_snaps, port_snaps, n_steps)


@pytest.mark.parametrize("backbone,hw", [(None, 33), ("resnet18", 65)])
def test_freeze_bn_uses_and_keeps_the_running_stats(backbone, hw, monkeypatch):
    model, params, stats = _segtpu(backbone, freeze_bn=True)
    zoo.assert_freeze_bn_matches(model, params, stats,
                                 _port(params, stats, backbone, freeze_bn=True),
                                 zoo.images(2, hw, BATCH), monkeypatch)


@pytest.mark.parametrize("arch,cls", [({"type": "UNet", "args": {}}, UNet),
                                      ({"type": "UNetResnet",
                                        "args": {"backbone": "resnet18"}}, UNetResnet)])
def test_training_cli_trains_unet_on_cpu(arch, cls, tmp_path):
    zoo.assert_cli_trained(train_cli.main(zoo.cli_config(arch, tmp_path), "cpu"), cls)


def test_constructors_take_segtpus_attributes():
    """segtpu's UNet has no backbone, pretrained or freeze_backbone: a
    config that passes them fails in both."""
    for kw in ({"backbone": "resnet50"}, {"pretrained": False}, {"freeze_backbone": True}):
        with pytest.raises(TypeError):
            SegtpuUNet(num_classes=3, **kw)
        with pytest.raises(TypeError):
            get_model("UNet", device="cpu", num_classes=3, **kw)
    a = get_model("UNetResnet", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    b = get_model("UNetResnet", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert get_model("UNet", device="cpu", num_classes=3).backbone_modules == ()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNetResnet(3, pretrained=True)

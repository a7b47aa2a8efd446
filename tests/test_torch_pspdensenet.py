"""The port's PSPDenseNet against segtpu's on the same weights and inputs,
on the CPU, on DenseNet-121 (the PSP head, the aux head on transition3, the
from-scratch stem with its padding-0 convs, dilated blocks 3 and 4), built
once for the module: 33 px, 5 classes, batch 4 (the PSP bin-1 BN
normalizes over the batch's values). The checks and their tolerances are
those of ``torch_zoo.py``, with ``remat_backbone`` off and on; segtpu's
trajectory is run once and held against the port's with remat off and
with remat on.

Beyond parity: remat's replay runs train-mode BN again, and torch would
update the running statistics (and ``num_batches_tracked``) a second time;
``test_remat_changes_neither_gradients_nor_running_stats`` holds the float64
gradients and every buffer with remat equal to those without it."""

import functools

import numpy as np
import pytest
import torch

from segtpu.models.pspnet import PSPDenseNet as SegtpuPSPDenseNet
from segtpu.utils.weight_convert import convert_pspdensenet
from segtpu_torch import losses
from segtpu_torch import train as train_cli
from segtpu_torch.models import get_model
from segtpu_torch.models.pspnet import PSPDenseNet
from segtpu_torch.utils.weight_convert import pspdensenet_state_dict_from_segtpu
from torch_parity import _init_segtpu, nchw, no_dropout
import torch_zoo as zoo

torch.set_num_threads(1)

CLASSES, BATCH, HW, ARCH = 5, 4, 33, "densenet121"
# the remat test's tolerance, relative to each tensor's largest value: the
# replay computes the same float64 operations in the same order
REMAT_TOL = 1e-12


def _segtpu_model(**kw):
    return SegtpuPSPDenseNet(num_classes=CLASSES, backbone=ARCH, **kw)


@functools.cache
def _weights():
    _, params, stats = _init_segtpu(_segtpu_model(), HW, 0)
    return params, stats


def _port(**kw):
    model = PSPDenseNet(CLASSES, backbone=ARCH, **kw)
    model.load_state_dict(pspdensenet_state_dict_from_segtpu(*_weights()), strict=True)
    return model


@pytest.fixture(scope="module")
def port():
    return _port()


def test_eval_logits_match_segtpu(port):
    zoo.assert_eval_matches(_segtpu_model(), *_weights(), port, zoo.images(0, HW, BATCH))


@pytest.mark.parametrize("remat", [False, True])
def test_train_logits_and_running_stats_match_segtpu(remat):
    zoo.assert_train_matches64(_segtpu_model(remat_backbone=remat), *_weights(),
                               _port(remat_backbone=remat),
                               pspdensenet_state_dict_from_segtpu, zoo.images(1, HW, BATCH))


def test_weights_load_strict_and_round_trip_through_segtpus_converter(port):
    sd = zoo.assert_round_trip(*_weights(), port, convert_pspdensenet, arch=ARCH)
    assert {f"block0.{i}.weight" for i in (0, 1, 3, 4, 6, 7)} <= set(sd)
    assert {"block1.denselayer1.norm1.weight", "block4.denselayer16.conv2.weight",
            "transition1.norm.running_var", "transition1.conv.weight",
            "transition2.0.weight", "transition3.2.weight", "master_branch.0.stages.0.1.weight",
            "master_branch.1.bias", "auxiliary_branch.0.weight", "auxiliary_branch.1.bias",
            "auxiliary_branch.4.weight"} <= set(sd)
    # DenseNet-121: block4 gives 1024 channels, transition3 512; the aux
    # head's hidden width is 1024 // 4
    assert sd["auxiliary_branch.0.weight"].shape == (256, 512, 3, 3)
    assert sd["master_branch.1.weight"].shape == (CLASSES, 256, 1, 1)
    assert sd["block0.0.weight"].shape == (64, 3, 3, 3)


def test_densenet201_aux_head_reads_transition3_at_896_with_480_hidden():
    """Not PSPNet's ``m_out // 2`` sizing: DenseNet-201's transition3 gives
    896 channels, block4 1920."""
    model = PSPDenseNet(3, backbone="densenet201")
    assert model.auxiliary_branch[0].weight.shape == (480, 896, 3, 3)
    assert model.master_branch[0].stages[0][1].weight.shape == (480, 1920, 1, 1)
    assert len(list(model.block3.children())) == 48


def test_stem_and_dilations_are_segtpus(port):
    """Padding-0 3x3 stem convs (stride 2, 1, 1) and a 3x3/2/1 pool;
    transitions 2 and 3 without a pool; block3 dilated 2, block4 4."""
    stem = [m for m in port.block0 if isinstance(m, torch.nn.Conv2d)]
    assert [(m.stride[0], m.padding[0]) for m in stem] == [(2, 0), (1, 0), (1, 0)]
    assert not any(isinstance(m, torch.nn.AvgPool2d)
                   for t in (port.transition2, port.transition3) for m in t)
    for block, d in ((port.block2, 1), (port.block3, 2), (port.block4, 4)):
        assert {layer.conv2.dilation[0] for layer in block.children()} == {d}
    with torch.no_grad():
        y = port.eval().block0(torch.zeros(1, 3, 769, 769))
    assert y.shape[-1] == 190  # 769 -> 384 -> 382 -> 380 -> 190


def test_parameter_groups_are_segtpus(port):
    got = zoo.assert_groups_match(_weights()[0], port)
    assert got["backbone"] > 0 and got["decoder"] > 0


@functools.cache
def _data():
    return zoo.batches(zoo.STEPS, HW, BATCH, CLASSES)


@functools.cache
def _segtpu_trajectory():
    return zoo.segtpu_trajectory(_segtpu_model(), *_weights(),
                                 pspdensenet_state_dict_from_segtpu, CLASSES, _data())


@pytest.fixture(scope="module", params=[False, True], ids=["remat_off", "remat_on"])
def trajectories(request):
    return (_segtpu_trajectory(),
            zoo.port_trajectory(_port(remat_backbone=request.param), _data()))


@pytest.mark.parametrize("n_steps", [1, zoo.STEPS])
def test_sgd_steps_match_segtpu(trajectories, n_steps):
    zoo.assert_step_matches(*trajectories, n_steps)


def _grads_and_buffers(model, x, labels):
    model = no_dropout(model).double().train()
    out = model(x)
    loss = (losses.cross_entropy(out["out"], labels)
            + 0.4 * losses.cross_entropy(out["aux"], labels))
    loss.backward()
    return ({n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def test_remat_changes_neither_gradients_nor_running_stats():
    imgs, labels = zoo.batches(1, HW, BATCH, CLASSES)[0]
    x, y = nchw(imgs), torch.from_numpy(labels).long()
    grads, buffers = _grads_and_buffers(_port(), x, y)
    remat_grads, remat_buffers = _grads_and_buffers(_port(remat_backbone=True), x, y)
    assert set(grads) == set(remat_grads) and set(buffers) == set(remat_buffers)
    for name, g in grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((remat_grads[name] - g).abs().max()) <= REMAT_TOL * scale, name
    moved = 0
    for name, b in buffers.items():
        if name.endswith("num_batches_tracked"):
            assert int(remat_buffers[name]) == int(b) == 1, name
        else:
            scale = float(b.abs().max())
            assert float((remat_buffers[name] - b).abs().max()) <= REMAT_TOL * scale, name
            moved += 1
    assert moved == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in _port().modules())


def test_freeze_bn_uses_and_keeps_the_running_stats(monkeypatch):
    zoo.assert_freeze_bn_matches(_segtpu_model(freeze_bn=True), *_weights(),
                                 _port(freeze_bn=True), zoo.images(2, HW, BATCH),
                                 monkeypatch)


@pytest.mark.parametrize("remat", [False, True])
def test_training_cli_trains_pspdensenet_on_cpu(remat, tmp_path):
    config = zoo.cli_config({"type": "PSPDenseNet", "args": {
        "backbone": ARCH, "remat_backbone": remat}}, tmp_path)
    zoo.assert_cli_trained(train_cli.main(config, "cpu"), PSPDenseNet)


def test_get_model_builds_pspdensenet_from_a_seed():
    a = get_model("PSPDenseNet", device="cpu", seed=3, num_classes=3, backbone=ARCH)
    b = get_model("PSPDenseNet", device="cpu", seed=3, num_classes=3, backbone=ARCH)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone_modules == ("block0", "block1", "block2", "block3", "block4",
                                  "transition1", "transition2", "transition3")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PSPDenseNet(3, backbone=ARCH, pretrained=True)
    assert np.isfinite(a.eval()(torch.zeros(1, 3, 33, 33))["out"].detach().numpy()).all()

"""The port's UperNet against segtpu's on the same weights and inputs, on the
CPU in fp32: forward in eval and train mode, strict loading and the round
trip of the weights, one and three SGD steps, and one run of the training
CLI.

``fpn_out=64`` equals ResNet-18's layer1 width, so the FPN has the original
layout; ``fpn_out=32`` adds ``FPN.lateral_p0``. Batch 4 and 8: the PPN's
bin-1 stage normalizes over the batch alone (ROADMAP queue 3, BN variance
from few values).
"""

import functools

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu.utils.weight_convert import convert_upernet
from segtpu_torch import losses
from segtpu_torch import train as train_cli
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.models import get_model
from segtpu_torch.models.upernet import UperNet
from segtpu_torch.utils.weight_convert import upernet_state_dict_from_segtpu
from torch_parity import (IdentityDropout, nchw, nhwc, no_dropout, port_upernet,
                          rel_max, segtpu_upernet)

torch.set_num_threads(1)

CLASSES, HW = 5, 49
# fp32 on both sides; BN variance formulas differ at ~1e-6 and depth and
# updates amplify that (as tests/test_torch_step.py for PSPNet)
TOL = 1e-4


@functools.cache
def _segtpu(fpn_out):
    """segtpu UperNet-R18 (model, params, batch_stats), built once per
    fpn_out for the whole file."""
    return segtpu_upernet("resnet18", CLASSES, HW, fpn_out)


@pytest.mark.parametrize("fpn_out", [64, 32])
def test_eval_logits_match_segtpu(fpn_out):
    model, params, stats = _segtpu(fpn_out)
    x = np.random.default_rng(0).normal(size=(4, HW, HW, 3)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=False)
    port = port_upernet(params, stats, "resnet18", CLASSES, fpn_out).eval()
    assert (port.FPN.lateral_p0 is None) == (fpn_out == 64)
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == {"out"}
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL


@pytest.mark.parametrize("fpn_out", [64, 32])
def test_train_logits_and_running_stats_match_segtpu(fpn_out, monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", IdentityDropout)
    model, params, stats = _segtpu(fpn_out)
    x = np.random.default_rng(1).normal(size=(4, HW, HW, 3)).astype(np.float32)
    want, mutated = model.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
    port = no_dropout(port_upernet(params, stats, "resnet18", CLASSES, fpn_out)).train()
    got = port(nchw(x))
    assert set(got) == {"out"}
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL
    want_sd = upernet_state_dict_from_segtpu(
        params, jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    for k, v in port.state_dict().items():
        if "running_" in k:
            assert rel_max(v.numpy(), want_sd[k].numpy()) < TOL, k


def test_weights_load_strict_and_round_trip_through_convert_upernet():
    """segtpu variables -> the port (strict) -> segtpu's convert_upernet
    gives them back exactly, where the layout is the original's."""
    _, params, stats = _segtpu(64)
    model = port_upernet(params, stats, "resnet18", CLASSES, 64)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got_p, got_s = convert_upernet(sd, arch="resnet18")
    for want, got in ((params, got_p), (stats, got_s)):
        flat_w = flax.traverse_util.flatten_dict(want)
        flat_g = flax.traverse_util.flatten_dict(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=str(k))


def test_lateral_p0_weights_load_strict():
    _, params, stats = _segtpu(32)
    sd = upernet_state_dict_from_segtpu(params, stats)
    model = UperNet(CLASSES, backbone="resnet18", fpn_out=32)
    assert set(sd) == set(model.state_dict())
    assert {"FPN.lateral_p0.weight", "FPN.lateral_p0.bias"} <= set(sd)
    model.load_state_dict(sd, strict=True)


def test_options_segtpu_does_not_run_raise_and_backbone_trains_at_lr_over_10():
    model = UperNet(3, backbone="resnet18", use_aux=False)
    assert UperNet(3, backbone="resnet18", pretrained=True).pretrained is True
    opt, scheds = make_optimizer(model, lr=0.01, num_epochs=1, iters_per_epoch=4)
    decoder, backbone = opt.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].startswith("backbone.") for p in backbone["params"])
    assert not any(names[id(p)].startswith("backbone.") for p in decoder["params"])
    assert scheds[1](0) == pytest.approx(0.1 * scheds[0](0))


STEP_BATCH, STEPS = 8, 3
NORM = ([0.5, 0.5, 0.5], [0.25, 0.25, 0.25])
OPT = dict(lr=0.01, num_epochs=1, iters_per_epoch=10)


@pytest.fixture(scope="module")
def trajectories():
    """The port's state_dict after updates 1 and 3, and segtpu's variables
    after the same updates in the port's layout."""
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(STEPS):
        images = rng.integers(0, 256, size=(STEP_BATCH, HW, HW, 3)).astype(np.uint8)
        labels = rng.integers(0, CLASSES, size=(STEP_BATCH, HW, HW)).astype(np.int32)
        labels[:, :5, :5] = 255
        batches.append((images, labels))
    model, params, stats = _segtpu(32)
    port = no_dropout(port_upernet(params, stats, "resnet18", CLASSES, 32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", IdentityDropout)
        tx = seg_state.make_optimizer(**OPT)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params),
                                      tx=tx)
        jstep = seg_make_train_step(model, seg_losses.cross_entropy, CLASSES,
                                    compute_dtype=jnp.float32, norm_stats=NORM)
        seg_snaps = {}
        for i, (images, labels) in enumerate(batches):
            jstate, loss, _ = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                                    jax.random.PRNGKey(0))
            p, s = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
            seg_snaps[i + 1] = (np.asarray(loss), upernet_state_dict_from_segtpu(p, s))

    opt, scheds = make_optimizer(port, **OPT)
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32,
                           norm_stats=NORM)
    port_snaps = {}
    for i, (images, labels) in enumerate(batches):
        loss, _ = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        port_snaps[i + 1] = (loss.numpy(), {k: v.clone() for k, v in
                                            port.state_dict().items()})
    return seg_snaps, port_snaps


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_train_steps_match_segtpu(trajectories, n_steps):
    seg_snaps, port_snaps = trajectories
    w_loss, w_sd = seg_snaps[n_steps]
    g_loss, g_sd = port_snaps[n_steps]
    assert rel_max(g_loss, w_loss) < TOL
    assert set(g_sd) == set(w_sd)
    for k, v in g_sd.items():
        if not k.endswith("num_batches_tracked"):
            assert rel_max(v.numpy(), w_sd[k].numpy()) < TOL, k


def test_training_cli_trains_upernet_on_cpu(tmp_path):
    synthetic = {"batch_size": 4, "num_classes": 3, "crop_size": 33,
                 "num_workers": 1, "device_normalize": True}
    config = {
        "name": "TinyUperNet", "seed": 0,
        "arch": {"type": "UperNet", "args": {"backbone": "resnet18", "fpn_out": 32}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 8, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32",
                    "save_dir": str(tmp_path), "log_dir": str(tmp_path / "runs")},
    }
    trainer = train_cli.main(config, "cpu")
    assert isinstance(trainer.model, UperNet) and trainer.state.step == 2
    log = trainer.history[-1]
    assert np.isfinite(log["loss"]) and np.isfinite(log["val_loss"])
    assert 0.0 <= log["Mean_IoU"] <= 1.0


def test_get_model_builds_upernet_from_a_seed():
    a = get_model("UperNet", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    b = get_model("UperNet", device="cpu", seed=3, num_classes=3, backbone="resnet18")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())

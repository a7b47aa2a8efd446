"""Shared checks of the zoo families' parity tests (tests/test_torch_duc_hdc.py,
test_torch_unet.py, test_torch_segnet.py, test_torch_enet.py,
test_torch_gcn.py, test_torch_fcn.py, test_torch_pspdensenet.py): the
port's model against segtpu's on the same weights and inputs, on the CPU.

* eval-mode fp32 logits within TOL (1e-4) relative to the largest;
* train-mode logits and running statistics in float64 within TOL64 (1e-8):
  in fp32 segtpu's BN variance, E[x^2] - mean^2, drifts from torch's;
* strict loading, and segtpu's converter giving the variables back bit for
  bit;
* SGD with momentum under Poly, two groups (backbone at lr/10), CE with
  ignored pixels, in float64 on both sides: parameters, running statistics
  and loss within TOL after 1 and 3 updates (relative to the larger of a
  tensor's largest value and SCALE_FLOOR), and each tensor's change since
  the start within UPDATE_TOL of segtpu's (relative to the larger of its
  largest change and CHANGE_FLOOR), so that a group updated at the wrong
  rate, or not at all, fails;
* ``freeze_bn`` with dropout the identity on both sides;
* parameter groups: each group's parameter count is segtpu's
  ``partition_labels``'s.
"""

from __future__ import annotations

import functools
import os

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

from segtpu import losses as seg_losses
from segtpu.core import state as seg_state
from segtpu.core.steps import make_train_step as seg_make_train_step
from segtpu_torch import losses
from segtpu_torch.core.state import TrainState, make_optimizer, partition_labels
from segtpu_torch.core.steps import make_train_step
from torch_parity import (IdentityDropout, nchw, nhwc, no_dropout, rel_max,
                          segtpu_float64, state_dict64)

TOL = 1e-4
# the float64 runs: the same arithmetic in other orders
TOL64 = 1e-8
# a parameter whose gradient is 0 in exact arithmetic (DeepLab_DUC_HDC's
# classifier bias, which a 1x1 conv and a train-mode BN follow) moves by
# float64 rounding noise, about 1e-19: the steps' errors are relative to the
# larger of its largest value and this
SCALE_FLOOR = 1e-12
# that parameter's change is the same noise on both sides (a few 1e-18
# after 3 updates), while DUC-HDC's smallest real change, a BN weight at
# lr/10, is 3.5e-6: a change is held relative to the larger of its largest
# value and this
CHANGE_FLOOR = 1e-9
# the change since the start, relative: the float64 runs agree to 1e-10
# after one update; after three, SegResNet's differ by up to 9.1e-7 of a
# tensor's largest change (5e-9 after two: the two runs part as they go). A
# group updated at 10 times or a tenth of its rate, or not at all, is off
# by 0.9 or more
UPDATE_TOL = 1e-5
STEPS = 3
SGD = dict(optimizer_type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4,
           scheduler_type="Poly", num_epochs=1, iters_per_epoch=10, differential_lr=True)


def images(seed, hw, batch, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(batch, hw, hw, 3)).astype(dtype)


def assert_eval_matches(seg_model, params, stats, port, x):
    want = jax.jit(functools.partial(seg_model.apply, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(nchw(x))
    assert set(got) == {"out"}
    assert got["out"].shape == (x.shape[0], got["out"].shape[1], *x.shape[1:3])
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL
    return got["out"]


def assert_train_matches64(seg_model, params, stats, port, convert, x, has_bn=True):
    """Train-mode logits and running statistics, float64 on both sides; a
    model without BN (``has_bn`` false: FCN8) has no running statistic."""
    x = x.astype(np.float64)
    with segtpu_float64():
        want, mutated = jax.jit(functools.partial(
            seg_model.apply, train=True, mutable=["batch_stats"]))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   {"params": params, "batch_stats": stats}),
            jnp.asarray(x))
        want, mutated = jax.tree_util.tree_map(np.asarray, (want, mutated))
    port = no_dropout(port).double().train()
    got = port(nchw(x))["out"].detach().numpy().transpose(0, 2, 3, 1)
    assert rel_max(got, want["out"]) < TOL64
    want_sd = state_dict64(convert, params, mutated["batch_stats"])
    n = 0
    for k, v in port.state_dict().items():
        if "running_" in k:
            assert rel_max(v.numpy(), want_sd[k].numpy()) < TOL64, k
            n += 1
    assert n > 0 if has_bn else n == 0


def assert_round_trip(params, stats, port, seg_converter, **kwargs):
    """The port's state dict, read by segtpu's converter, gives segtpu's
    variables back bit for bit."""
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    got_p, got_s = seg_converter(sd, **kwargs)
    for want, got in ((params, got_p), (stats, got_s)):
        flat_w = flax.traverse_util.flatten_dict(want)
        flat_g = flax.traverse_util.flatten_dict(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=str(k))
    return sd


def assert_groups_match(params, port):
    """Each parameter group's count is segtpu's: ``partition_labels`` puts
    a top-level ``backbone`` scope or a ``backbone_*`` name in the backbone
    group."""
    labels = flax.traverse_util.flatten_dict(seg_state.partition_labels(params))
    flat = flax.traverse_util.flatten_dict(params)
    want = {"backbone": 0, "decoder": 0}
    for k, label in labels.items():
        want[label] += int(np.prod(flat[k].shape))
    got = {"backbone": 0, "decoder": 0}
    named = dict(port.named_parameters())
    for name, label in partition_labels(port).items():
        got[label] += named[name].numel()
    assert got == want
    return got


def assert_freeze_bn_matches(seg_model, params, stats, port, x, monkeypatch):
    """Train mode with ``freeze_bn``: segtpu's logits, and no running
    statistic moves; dropout is the identity on both sides."""
    monkeypatch.setattr(flax.linen, "Dropout", IdentityDropout)
    want, _ = jax.jit(functools.partial(seg_model.apply, train=True,
                                        mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        rngs={"dropout": jax.random.PRNGKey(0)})
    port = no_dropout(port).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(nchw(x))
    assert rel_max(nhwc(got["out"]), want["out"]) < TOL
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert port.training and not any(
        m.training for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d))


def batches(steps, hw, batch, classes):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        imgs = rng.normal(size=(batch, hw, hw, 3))
        labels = rng.integers(0, classes, size=(batch, hw, hw)).astype(np.int32)
        labels[:, :5, :5] = 255
        out.append((imgs, labels))
    return out


def trajectories(seg_model, params, stats, port, convert, classes, data):
    """segtpu's and the port's (loss, state dict) before (loss None) and
    after each SGD update on ``data``, float64 on both sides, in the port's
    layout."""
    return (segtpu_trajectory(seg_model, params, stats, convert, classes, data),
            port_trajectory(port, data))


def segtpu_trajectory(seg_model, params, stats, convert, classes, data):
    """segtpu's half of :func:`trajectories`."""
    with segtpu_float64():
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), (params, stats))
        tx, _ = seg_state.make_optimizer_with_schedules(**SGD)
        jstate = seg_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=stats, opt_state=tx.init(params), tx=tx)
        jstep = seg_make_train_step(seg_model, seg_losses.cross_entropy, classes,
                                    compute_dtype=jnp.float64)
        seg_snaps = [(None, state_dict64(convert, *jax.tree_util.tree_map(
            np.asarray, (params, stats))))]
        for imgs, labels in data:
            jstate, loss, _ = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                                    jax.random.PRNGKey(0))
            p, s = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
            seg_snaps.append((np.asarray(loss), state_dict64(convert, p, s)))
    return seg_snaps


def port_trajectory(port, data):
    """The port's half of :func:`trajectories`."""
    port = no_dropout(port).double()
    opt, scheds = make_optimizer(port, **SGD)
    assert len(opt.param_groups) == 2
    state = TrainState(port, opt, scheds)
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float64)
    port_snaps = [(None, {k: v.clone() for k, v in port.state_dict().items()})]
    for imgs, labels in data:
        loss, _ = step(state, torch.from_numpy(imgs), torch.from_numpy(labels))
        port_snaps.append((loss.numpy(), {k: v.clone() for k, v in
                                          port.state_dict().items()}))
    return port_snaps


def assert_step_matches(seg_snaps, port_snaps, n_steps):
    """After ``n_steps`` updates: the loss, every tensor, and every
    tensor's change since the start, against segtpu's."""
    (_, w_sd0), (_, g_sd0) = seg_snaps[0], port_snaps[0]
    (w_loss, w_sd), (g_loss, g_sd) = seg_snaps[n_steps], port_snaps[n_steps]
    assert rel_max(g_loss, w_loss) < TOL
    assert set(g_sd) == set(w_sd) == set(w_sd0) == set(g_sd0)
    moved = 0
    for k, v in g_sd.items():
        if not k.endswith("num_batches_tracked"):
            got, want = v.numpy(), w_sd[k].numpy()
            scale = max(float(np.max(np.abs(want))), SCALE_FLOOR)
            assert float(np.max(np.abs(got - want))) < TOL * scale, k
            d_got, d_want = got - g_sd0[k].numpy(), want - w_sd0[k].numpy()
            d_scale = max(float(np.max(np.abs(d_want))), CHANGE_FLOOR)
            assert float(np.max(np.abs(d_got - d_want))) < UPDATE_TOL * d_scale, k
            moved += d_scale > CHANGE_FLOOR
    assert moved > 0


def cli_config(arch, save_dir, crop=33, classes=3):
    """A one-epoch Synthetic run of ``arch`` under SGD + Poly on the CPU,
    validation included."""
    synthetic = {"batch_size": 2, "num_classes": classes, "crop_size": crop,
                 "num_workers": 1, "device_normalize": True}
    return {
        "name": "TinyZoo", "seed": 0, "arch": arch,
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": crop + 7, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 2, "image_hw": crop, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 1, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "compute_dtype": "float32",
                    "save_dir": str(save_dir),
                    "log_dir": os.path.join(str(save_dir), "runs")},
    }


def assert_pretrained_only_recorded(built, name, **kwargs):
    """``pretrained=True`` builds the same model from the same seed (the
    Trainer loads the file, not the constructor) and records the flag."""
    from segtpu_torch.models import get_model

    model = get_model(name, device="cpu", pretrained=True, **kwargs)
    assert model.pretrained is True and model.state_dict().keys() == built.state_dict().keys()
    assert all(torch.equal(v, built.state_dict()[k]) for k, v in model.state_dict().items())


def assert_cli_trained(trainer, model_cls):
    assert isinstance(trainer.model, model_cls) and trainer.state.step == 2
    log = trainer.history[-1]
    assert np.isfinite(log["loss"]) and np.isfinite(log["val_loss"])
    assert 0.0 <= log["Mean_IoU"] <= 1.0

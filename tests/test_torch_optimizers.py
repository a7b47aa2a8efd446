"""The port's optimizers and schedules against segtpu's, on the CPU.

Every optimizer segtpu takes (SGD, Adam, AdamW, RMSprop plain and centered,
Adagrad), with its options, under Poly and OneCycle, in two groups with the
backbone at lr/10: 5 updates of a small parameter tree with fixed seeded
gradients against segtpu's optax transform from
``make_optimizer_with_schedules``, both in float64, held to 1e-10 relative
(the same arithmetic in other orders). OneCycle's rate and momentum against
segtpu's at every step of a short run; ``freeze_backbone`` keeps the
backbone's bits; every optimizer's state and the update count survive a
checkpoint bit for bit, and a trainer run with Adam under OneCycle resumes
bit for bit.
"""

import contextlib
import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from segtpu import schedules as seg_schedules
from segtpu.core import state as seg_state
from segtpu_torch import schedules
from segtpu_torch.checkpoint import load_checkpoint, save_checkpoint
from segtpu_torch.core.state import OPTIMIZERS, TrainState, make_optimizer
from segtpu_torch.data.synthetic import Synthetic
from segtpu_torch.models import get_model
from segtpu_torch.trainer import Trainer
from torch_parity import rel_max

torch.set_num_threads(1)

TOL = 1e-10
UPDATES = 5
SHAPES = {"backbone": {"w": (4, 3), "b": (4,)}, "head": {"w": (2, 4), "b": (2,)}}
SCHED = dict(lr=0.05, num_epochs=2, iters_per_epoch=4)

CASES = {
    "SGD": ("SGD", {"momentum": 0.9, "weight_decay": 1e-4}),
    "SGD-nesterov": ("SGD", {"nesterov": True, "weight_decay": 1e-3}),
    "Adam": ("Adam", {"betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 1e-3}),
    "AdamW": ("AdamW", {"weight_decay": 1e-2}),
    "RMSprop": ("RMSprop", {"alpha": 0.9, "weight_decay": 0.0}),
    "RMSprop-centered-momentum": ("RMSprop", {"centered": True, "momentum": 0.5,
                                              "weight_decay": 1e-3}),
    "Adagrad": ("Adagrad", {"lr_decay": 0.1, "initial_accumulator_value": 0.1,
                            "weight_decay": 1e-3}),
}


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {m: {k: rng.normal(size=s) for k, s in p.items()} for m, p in SHAPES.items()}


class _Tree(nn.Module):
    """The parameter tree as a module: ``backbone.*`` and ``head.*``."""

    backbone_modules = ("backbone",)

    def __init__(self, arrays):
        super().__init__()
        for m, p in arrays.items():
            setattr(self, m, nn.ParameterDict(
                {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in p.items()}))

    def numpy(self):
        return {m: {k: v.detach().numpy().copy() for k, v in getattr(self, m).items()}
                for m in SHAPES}


def _grads():
    return [_arrays(100 + t) for t in range(UPDATES)]


def _segtpu_updates(opt_type, args, scheduler, **kw):
    """segtpu's parameters after each update, and its schedules."""
    with _x64():
        tx, scheds = seg_state.make_optimizer_with_schedules(
            optimizer_type=opt_type, scheduler_type=scheduler, **SCHED, **kw, **args)
        params = jax.tree_util.tree_map(jnp.asarray, _arrays(0))
        opt_state = tx.init(params)
        out = []
        for g in _grads():
            updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                           opt_state, params)
            params = optax.apply_updates(params, updates)
            out.append(jax.tree_util.tree_map(np.asarray, params))
        return out, [np.asarray([s(t) for t in range(UPDATES)]) for s in scheds]


def _port_updates(opt_type, args, scheduler, **kw):
    model = _Tree(_arrays(0))
    opt, scheds = make_optimizer(model, optimizer_type=opt_type,
                                 scheduler_type=scheduler, **SCHED, **kw, **args)
    state = TrainState(model, opt, scheds)
    out = []
    for g in _grads():
        for m, p in g.items():
            for k, v in p.items():
                getattr(model, m)[k].grad = torch.from_numpy(v.copy())
        state.apply_gradients()
        out.append(model.numpy())
    return out, [np.asarray([s(t) for t in range(UPDATES)]) for s in scheds], opt


def _assert_trees_match(got, want):
    for m in SHAPES:
        for k in SHAPES[m]:
            assert rel_max(got[m][k], want[m][k]) < TOL, (m, k)


@pytest.mark.parametrize("scheduler", ["Poly", "OneCycle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_segtpu(case, scheduler):
    opt_type, args = CASES[case]
    want, want_scheds = _segtpu_updates(opt_type, args, scheduler)
    got, got_scheds, opt = _port_updates(opt_type, args, scheduler)
    assert len(opt.param_groups) == 2 and len(got_scheds) == 2
    assert (opt.momentum_schedule is not None) == (
        opt_type == "SGD" and scheduler == "OneCycle")
    for g, w in zip(got_scheds, want_scheds):
        assert rel_max(g, w) < TOL
    for t in range(UPDATES):
        _assert_trees_match(got[t], want[t])


@pytest.mark.parametrize("case", ["SGD", "Adam", "RMSprop-centered-momentum"])
def test_one_group_without_differential_lr_matches_segtpu(case):
    opt_type, args = CASES[case]
    want, _ = _segtpu_updates(opt_type, args, "OneCycle", differential_lr=False)
    got, scheds, opt = _port_updates(opt_type, args, "OneCycle", differential_lr=False)
    assert len(opt.param_groups) == 1 and len(scheds) == 1
    _assert_trees_match(got[-1], want[-1])


@pytest.mark.parametrize("case", ["SGD", "AdamW", "Adagrad"])
def test_freeze_backbone_keeps_its_bits(case):
    opt_type, args = CASES[case]
    want, _ = _segtpu_updates(opt_type, args, "Poly", freeze_backbone=True)
    got, scheds, opt = _port_updates(opt_type, args, "Poly", freeze_backbone=True)
    # both schedules are still reported, as segtpu's are
    assert len(opt.param_groups) == 1 and len(scheds) == 2
    start = _arrays(0)["backbone"]
    for t in range(UPDATES):
        for k in start:
            np.testing.assert_array_equal(got[t]["backbone"][k], start[k])
            np.testing.assert_array_equal(want[t]["backbone"][k], start[k])
        for k in SHAPES["head"]:
            assert rel_max(got[t]["head"][k], want[t]["head"][k]) < TOL


def test_optimizer_defaults_follow_segtpu():
    model = _Tree(_arrays(0))
    sgd, _ = make_optimizer(model, optimizer_type="SGD")
    rms, _ = make_optimizer(model, optimizer_type="RMSprop")
    ada, _ = make_optimizer(model, optimizer_type="Adagrad", betas=(0.1, 0.2))
    assert sgd.defaults["momentum"] == 0.9
    assert rms.defaults["momentum"] == 0.0
    assert "betas" not in ada.defaults  # options the optimizer does not read drop out
    assert set(OPTIMIZERS) == set(seg_state._OPTIMIZERS)
    with pytest.raises(ValueError, match="unsupported optimizer"):
        make_optimizer(model, optimizer_type="LBFGS")
    with pytest.raises(KeyError, match="lr_scheduler"):
        make_optimizer(model, scheduler_type="Step")


@pytest.mark.parametrize("kw", [{}, {"momentums": (0.8, 0.9), "div_factor": 10.0,
                                     "phase1": 0.5}])
def test_one_cycle_matches_segtpu_at_every_step(kw):
    total = 3 * 5
    with _x64():
        want_lr, want_mom = seg_schedules.one_cycle(0.1, 3, 5, **kw)
        want = [(float(want_lr(t)), float(want_mom(t))) for t in range(total)]
    lr, mom = schedules.one_cycle(0.1, 3, 5, **kw)
    got = [(lr(t), mom(t)) for t in range(total)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert schedules.get_schedule("OneCycle") is schedules.one_cycle
    # the ramp peaks at base_lr at the end of phase 1, where momentum bottoms
    p1 = int(total * kw.get("phase1", 0.3))
    assert lr(p1 - 1) == pytest.approx(0.1) and mom(p1 - 1) == pytest.approx(
        kw.get("momentums", (0.85, 0.95))[0])


def _opt_state(opt):
    return [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_state_survives_a_checkpoint_bit_for_bit(case, tmp_path):
    """2 updates, save, load into a fresh state, 3 more in both: the same
    parameters, optimizer state and update count, bit for bit."""
    opt_type, args = CASES[case]
    grads = _grads()

    def fresh():
        model = _Tree(_arrays(0))
        return TrainState(model, *make_optimizer(
            model, optimizer_type=opt_type, scheduler_type="OneCycle", **SCHED, **args))

    def update(state, g):
        for m, p in g.items():
            for k, v in p.items():
                getattr(state.model, m)[k].grad = torch.from_numpy(v.copy())
        state.apply_gradients()

    a = fresh()
    for g in grads[:2]:
        update(a, g)
    save_checkpoint(str(tmp_path), "ck", a, 1, float("nan"), {}, "Tree")
    b = fresh()
    load_checkpoint(os.path.join(tmp_path, "ck"), b)
    assert b.step == 2
    for g in grads[2:]:
        update(a, g)
        update(b, g)
    for m in SHAPES:
        for k in SHAPES[m]:
            assert torch.equal(getattr(a.model, m)[k], getattr(b.model, m)[k])
    sa, sb = _opt_state(a.optimizer), _opt_state(b.optimizer)
    assert sa and len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(torch.as_tensor(x[k]), torch.as_tensor(y[k])), k
    assert [g["lr"] for g in a.optimizer.param_groups] == [
        g["lr"] for g in b.optimizer.param_groups]


CLASSES, CROP = 3, 33


def _config(save_dir, **trainer):
    synthetic = {"batch_size": 2, "num_classes": CLASSES, "crop_size": CROP,
                 "num_workers": 1, "device_normalize": True}
    return {
        "name": "TinyAdam", "seed": 0,
        "arch": {"type": "PSPNet", "args": {"backbone": "resnet18"}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 6, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 2, "image_hw": CROP, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "Adam", "differential_lr": True,
                      "args": {"lr": 0.001, "weight_decay": 1e-4,
                               "betas": [0.9, 0.99]}},
        "loss": "CE_DiceLoss", "ignore_index": 255,
        "lr_scheduler": {"type": "OneCycle", "args": {}},
        "trainer": {"epochs": 2, "save_dir": str(save_dir), "save_period": 1,
                    "log_per_iter": 1, "val": True, "monitor": "max Mean_IoU",
                    "compute_dtype": "float32", **trainer},
    }


def _trainer(config, resume=None):
    """A Trainer whose steps record (update count, batch fingerprint, rates)."""
    model = get_model("PSPNet", device="cpu", seed=0, num_classes=CLASSES,
                      **config["arch"]["args"])
    trainer = Trainer(model, config["loss"], config,
                      Synthetic(**config["train_loader"]["args"]),
                      Synthetic(**config["val_loader"]["args"]),
                      device="cpu", resume=resume)
    trainer.steps = []
    step = trainer.train_step

    def recording_step(state, images, labels):
        out = step(state, images, labels)
        trainer.steps.append((state.step, zlib.crc32(labels.numpy().tobytes())
                              ^ zlib.crc32(images.numpy().tobytes()),
                              [g["lr"] for g in state.optimizer.param_groups]))
        return out

    trainer.train_step = recording_step
    return trainer


def test_adam_under_one_cycle_resumes_bit_for_bit(tmp_path):
    """The uninterrupted 2-epoch run against one resumed from
    checkpoint-epoch1: the same batches at the same OneCycle rates, and the
    same parameters, BN statistics and Adam moments, bit for bit."""
    ref = _trainer(_config(tmp_path / "a"))
    ref.train()
    rates, _ = schedules.one_cycle(0.001, 2, 3)
    assert [s[2] for s in ref.steps] == [[rates(t), rates(t) * 0.1] for t in range(6)]
    resumed = _trainer(_config(tmp_path / "b"),
                       resume=os.path.join(ref.checkpoint_dir, "checkpoint-epoch1"))
    assert resumed.state.step == 3
    resumed.train()
    assert resumed.steps == ref.steps[3:]
    for k, v in ref.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    sa, sb = _opt_state(ref.state.optimizer), _opt_state(resumed.state.optimizer)
    assert all(set(s) == {"step", "exp_avg", "exp_avg_sq"} for s in sa)
    for x, y in zip(sa, sb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_freeze_backbone_and_freeze_bn_in_a_pspnet_step():
    """freeze_backbone: the backbone's parameters keep their bits, its BN
    statistics still move. freeze_bn: no running statistic moves, the BN
    scales still train, and ``train()`` does not undo it."""
    from segtpu_torch import losses
    from segtpu_torch.core.steps import make_train_step

    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.normal(size=(2, CROP, CROP, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, (2, CROP, CROP)).astype(np.int64))
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32)
    for flags in ({"freeze_backbone": True}, {"freeze_bn": True}):
        model = get_model("PSPNet", device="cpu", seed=1, num_classes=CLASSES,
                          backbone="resnet18", **flags)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt, scheds = make_optimizer(model, optimizer_type="AdamW", lr=0.01,
                                     weight_decay=0.1, num_epochs=1, iters_per_epoch=4,
                                     freeze_backbone=flags.get("freeze_backbone", False))
        state = TrainState(model, opt, scheds)
        for _ in range(2):
            step(state, images, labels)
        after = model.state_dict()
        backbone = [k for k in after if k.split(".")[0] in model.backbone_modules]
        stats = [k for k in after if "running_" in k]
        if "freeze_backbone" in flags:
            assert all(torch.equal(after[k], before[k]) for k in backbone
                       if "running_" not in k and "num_batches" not in k)
            assert not torch.equal(after["initial.1.running_mean"],
                                   before["initial.1.running_mean"])
            assert not torch.equal(after["master_branch.1.weight"],
                                   before["master_branch.1.weight"])
        else:
            assert all(torch.equal(after[k], before[k]) for k in stats)
            assert not torch.equal(after["initial.1.weight"], before["initial.1.weight"])
            assert not any(m.training for m in model.modules()
                           if isinstance(m, nn.BatchNorm2d))
            assert model.training

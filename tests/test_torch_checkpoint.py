"""The port's checkpoints, resume and preemption on the CPU.

A checkpoint round-trips bit for bit (model, optimizer, update count and the
random generator), also into and out of a channels_last model. A run resumed
from an epoch checkpoint, from a mid-epoch ``save_per_iters`` checkpoint or
from a SIGTERM checkpoint (mid-epoch, on the last iteration, after
validation) ends with the parameters, BN statistics and momentum buffers of
the uninterrupted run, bit for bit, after the same batches at the same
learning rates. The model part of a checkpoint, converted by segtpu's
``MODEL_CONVERTERS``, gives segtpu's eval logits.

PSPNet-R18 at 33 px, 3 classes, batch 2, 3 iterations an epoch, fp32, with
its dropouts on: they draw from the global generator, which the checkpoint
carries.
"""

import json
import logging
import math
import os
import shutil
import signal
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu.models.pspnet import PSPNet as SegtpuPSPNet
from segtpu.models.upernet import UperNet as SegtpuUperNet
from segtpu.utils.weight_convert import MODEL_CONVERTERS
from segtpu_torch import losses
from segtpu_torch.checkpoint import (load_checkpoint, load_config_from_checkpoint,
                                     load_model_weights, save_checkpoint)
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.data.synthetic import Synthetic
from segtpu_torch.models import get_model
from segtpu_torch.trainer import Trainer, TrainingPreempted
from torch_parity import nchw, nhwc, rel_max

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CLASSES, CROP = 3, 33
# fp32 on both sides: BN variance formulas differ at ~1e-6 (as
# tests/test_torch_model.py)
TOL = 1e-4
MODELS = {"PSPNet": {"backbone": "resnet18", "pallas_stem_wgrad": True},
          "UperNet": {"backbone": "resnet18", "fpn_out": 64}}


def _config(save_dir, **trainer):
    synthetic = {"batch_size": 2, "num_classes": CLASSES, "crop_size": CROP,
                 "num_workers": 2, "device_normalize": True}
    return {
        "name": "TinyPSP", "seed": 0,
        "arch": {"type": "PSPNet", "args": MODELS["PSPNet"]},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 6, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 3, "image_hw": CROP, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 2, "save_dir": str(save_dir), "save_period": 1,
                    "log_dir": os.path.join(str(save_dir), "runs"),
                    "save_per_iters": 2, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "early_stop": 10,
                    "compute_dtype": "float32", **trainer},
    }


def _trainer(config, resume=None):
    """A Trainer whose steps record (update count, batch fingerprint, the
    learning rates the update used)."""
    model = get_model("PSPNet", device="cpu", seed=0, num_classes=CLASSES,
                      **config["arch"]["args"])
    trainer = Trainer(model, "CrossEntropyLoss2d", config,
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


def _snapshot(state):
    """Parameters and BN statistics, momentum buffers, update count."""
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [opt.state[p]["momentum_buffer"].clone()
             for g in opt.param_groups for p in g["params"]],
            state.step)


def _assert_identical(got, want):
    (sd_g, mom_g, step_g), (sd_w, mom_w, step_w) = got, want
    assert step_g == step_w
    assert set(sd_g) == set(sd_w)
    for k in sd_w:
        assert torch.equal(sd_g[k], sd_w[k]), k
    assert len(mom_g) == len(mom_w)
    assert all(torch.equal(g, w) for g, w in zip(mom_g, mom_w))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted two-epoch run (save_per_iters 2, so its last
    checkpoint-latest is epoch 2, iteration 2): its final state, its steps
    and its checkpoint directory. The checkpoints are removed afterwards."""
    root = tmp_path_factory.mktemp("reference")
    trainer = _trainer(_config(root))
    history = trainer.train()
    yield {"final": _snapshot(trainer.state), "steps": trainer.steps,
           "dir": trainer.checkpoint_dir, "history": history}
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture
def save_dir(tmp_path):
    yield tmp_path / "saved"
    shutil.rmtree(tmp_path / "saved", ignore_errors=True)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_round_trip_is_bit_identical(arch, tmp_path):
    """After one SGD step of a channels_last model, the checkpoint loads back
    into a fresh contiguous model and a fresh channels_last one with the same
    bits: weights, BN statistics, momentum buffers, update count, and the
    random generator's state."""
    def fresh(seed, channels_last):
        model = get_model(arch, device="cpu", seed=seed, num_classes=CLASSES,
                          **MODELS[arch])
        if channels_last:
            model = model.to(memory_format=torch.channels_last)
        opt, schedules = make_optimizer(model, num_epochs=2, iters_per_epoch=3)
        return TrainState(model, opt, schedules)

    state = fresh(0, channels_last=True)
    kernel = next(p for p in state.model.parameters() if p.dim() == 4)
    assert not kernel.is_contiguous()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, CROP, CROP, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, CLASSES, (2, CROP, CROP), np.int64))
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32,
                           norm_stats=([0.5] * 3, [0.25] * 3))
    step(state, images, labels)
    want = _snapshot(state)
    rng_state = torch.get_rng_state()
    config = {"arch": {"type": arch, "args": MODELS[arch]}}
    path = save_checkpoint(str(tmp_path), "ck", state, epoch=3, monitor_best=0.25,
                           config=config, arch=arch,
                           extra_meta={"resume_epoch": 4, "resume_iter": 1})
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    torch.manual_seed(123)  # move the generator; the load restores it
    for channels_last in (False, True):
        loaded = fresh(1, channels_last)
        meta = load_checkpoint(path, loaded)
        _assert_identical(_snapshot(loaded), want)
        assert torch.equal(torch.get_rng_state(), rng_state)
    assert meta == {"epoch": 3, "monitor_best": 0.25, "config": config,
                    "arch": arch, "resume_epoch": 4, "resume_iter": 1}
    assert load_config_from_checkpoint(path) == config
    weights_only = load_model_weights(path, fresh(2, False).model)
    for k, v in want[0].items():
        assert torch.equal(weights_only.state_dict()[k], v), k
    # a second save under the same name replaces the first whole
    state.step = 7
    save_checkpoint(str(tmp_path), "ck", state, 4, math.nan, config, arch)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert json.load(open(os.path.join(path, "meta.json")))["epoch"] == 4


def test_meta_keeps_an_unset_monitor_as_null(tmp_path):
    """+/-inf (no validation yet) is stored as null, so a 'min' monitor
    resumes with its own +inf; a finite best is kept (segtpu's
    tests/test_trainer.py::test_checkpoint_meta_preserves_unset_monitor)."""
    model = get_model("PSPNet", device="cpu", num_classes=CLASSES, backbone="resnet18")
    opt, schedules = make_optimizer(model)
    state = TrainState(model, opt, schedules)
    save_checkpoint(str(tmp_path), "ck", state, 0, math.inf, {}, "PSPNet")
    assert json.load(open(tmp_path / "ck" / "meta.json"))["monitor_best"] is None
    save_checkpoint(str(tmp_path), "ck2", state, 1, 0.37, {}, "PSPNet")
    assert json.load(open(tmp_path / "ck2" / "meta.json"))["monitor_best"] == \
        pytest.approx(0.37)


def test_uninterrupted_run_writes_its_checkpoints(reference):
    d = reference["dir"]
    assert {"config.json", "checkpoint-epoch1", "checkpoint-epoch2",
            "checkpoint-latest", "best_model"} <= set(os.listdir(d))
    assert json.load(open(os.path.join(d, "config.json")))["name"] == "TinyPSP"
    latest = json.load(open(os.path.join(d, "checkpoint-latest", "meta.json")))
    assert (latest["epoch"], latest["resume_epoch"], latest["resume_iter"]) == (1, 2, 2)
    # update t uses the Poly rate at count t + 1 of 6, the backbone at 1/10
    for count, _, lrs in reference["steps"]:
        rate = 0.01 * (1 - count / 6) ** 0.9
        assert lrs == pytest.approx([rate, rate / 10])
    assert [s[0] for s in reference["steps"]] == [1, 2, 3, 4, 5, 6]


def _resume_and_check(reference, save_dir, resume, first_step):
    """Resume into a fresh trainer; its steps, batches and rates are the
    uninterrupted run's from ``first_step`` on, and its final state is the
    uninterrupted run's, bit for bit."""
    trainer = _trainer(_config(save_dir, save_per_iters=0, save_period=10),
                       resume=resume)
    assert trainer.state.step == first_step - 1
    trainer.train()
    assert trainer.preempted is None
    assert trainer.steps == reference["steps"][first_step - 1:]
    _assert_identical(_snapshot(trainer.state), reference["final"])
    return trainer


def test_resume_from_an_epoch_checkpoint_is_bit_identical(reference, save_dir):
    trainer = _resume_and_check(
        reference, save_dir, os.path.join(reference["dir"], "checkpoint-epoch1"), 4)
    assert trainer.history[-1]["val_loss"] == reference["history"][-1]["val_loss"]


def test_resume_from_a_mid_epoch_checkpoint_is_bit_identical(reference, save_dir):
    """checkpoint-latest (epoch 2, iteration 2): the resumed run takes only
    the epoch's third batch."""
    trainer = _resume_and_check(
        reference, save_dir, os.path.join(reference["dir"], "checkpoint-latest"), 6)
    assert trainer.start_epoch == 2 and len(trainer.steps) == 1


@pytest.mark.parametrize("when", ["mid-epoch", "last-iteration", "after-validation"])
def test_sigterm_writes_latest_and_resumes_bit_identical(when, reference, save_dir):
    """A SIGTERM ends train() cleanly with checkpoint-latest written, the
    previous handler back in place and ``preempted`` set; the resumed run
    ends where the uninterrupted one did. Mirrors segtpu's
    tests/test_trainer.py::test_sigterm_preemption_checkpoint_and_resume and
    test_sigterm_on_last_iteration_checkpoints_before_validation."""
    trainer = _trainer(_config(save_dir / "first", save_per_iters=0))
    prev = signal.getsignal(signal.SIGTERM)
    step, valid, ran = trainer.train_step, trainer._valid_epoch, []

    def step_with_sigterm(state, images, labels):
        if state.step + 1 == {"mid-epoch": 2, "last-iteration": 3}.get(when):
            assert signal.getsignal(signal.SIGTERM) == trainer._on_preempt
            signal.raise_signal(signal.SIGTERM)
        return step(state, images, labels)

    def valid_with_sigterm(epoch):
        ran.append(epoch)
        if when == "after-validation":
            signal.raise_signal(signal.SIGTERM)
        return valid(epoch)

    trainer.train_step, trainer._valid_epoch = step_with_sigterm, valid_with_sigterm
    trainer.train()
    assert isinstance(trainer.preempted, TrainingPreempted)
    assert signal.getsignal(signal.SIGTERM) == prev
    latest = os.path.join(trainer.checkpoint_dir, "checkpoint-latest")
    meta = json.load(open(os.path.join(latest, "meta.json")))
    want_step, want_meta = {
        "mid-epoch": (2, {"epoch": 0, "resume_epoch": 1, "resume_iter": 2}),
        "last-iteration": (3, {"epoch": 1}),
        "after-validation": (3, {"epoch": 1})}[when]
    assert trainer.state.step == want_step
    assert {k: meta[k] for k in want_meta} == want_meta
    assert ("resume_iter" in meta) == (when == "mid-epoch")
    # a SIGTERM on the last iteration stops the run before validation
    assert ran == ([] if when != "after-validation" else [1])
    _resume_and_check(reference, save_dir / "resumed", latest, want_step + 1)


def test_train_cli_resumes_with_the_checkpoint_config(reference, tmp_path):
    """``--resume`` without ``--config`` reads the config from meta.json
    (a copy whose save_dir points into this test's directory)."""
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    ckpt = str(tmp_path / "checkpoint-epoch1")
    shutil.copytree(os.path.join(reference["dir"], "checkpoint-epoch1"), ckpt)
    meta = json.load(open(os.path.join(ckpt, "meta.json")))
    meta["config"]["trainer"]["save_dir"] = str(tmp_path / "saved")
    meta["config"]["trainer"]["log_dir"] = str(tmp_path / "runs")
    json.dump(meta, open(os.path.join(ckpt, "meta.json"), "w"))
    res = subprocess.run([sys.executable, "-m", "segtpu_torch.train", "--resume",
                          ckpt, "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"Checkpoint <{ckpt}> (epoch 2) was loaded" in res.stderr
    assert "TRAIN epoch 2" in res.stderr and "TRAIN epoch 1" not in res.stderr
    assert (tmp_path / "saved" / "TinyPSP").is_dir()
    for d in ("saved", "checkpoint-epoch1"):
        shutil.rmtree(tmp_path / d)


def test_unported_trainer_keys_are_logged(tmp_path):
    """``tensorboard``, ``log_dir`` and ``profile`` are ported: no warning,
    and the event file goes under ``log_dir``."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("segtpu_torch.Trainer")
    logger.addHandler(handler)
    try:
        config = _config(tmp_path, tensorboard=True, log_dir=str(tmp_path), profile=3)
        trainer = _trainer(config)
    finally:
        logger.removeHandler(handler)
    msgs = [r.getMessage() for r in records if r.levelno == logging.WARNING]
    assert msgs == []
    assert os.path.dirname(trainer.writer.path).startswith(str(tmp_path))


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_checkpoint_weights_convert_to_segtpu(arch, tmp_path):
    """The model part of a port checkpoint, read as numpy and converted by
    segtpu's MODEL_CONVERTERS, gives segtpu's eval logits (1e-4 of the
    largest, fp32)."""
    model = get_model(arch, device="cpu", seed=4, num_classes=CLASSES, **MODELS[arch])
    with torch.no_grad():  # move BN off its init
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    opt, schedules = make_optimizer(model)
    path = save_checkpoint(str(tmp_path), "ck", TrainState(model, opt, schedules),
                           1, 0.5, {}, arch)
    sd = torch.load(os.path.join(path, "state.pt"), weights_only=True)["model"]
    params, stats = MODEL_CONVERTERS[arch]({k: v.numpy() for k, v in sd.items()},
                                           arch="resnet18")
    seg = (SegtpuPSPNet(num_classes=CLASSES, backbone="resnet18") if arch == "PSPNet"
           else SegtpuUperNet(num_classes=CLASSES, backbone="resnet18", fpn_out=64))
    x = np.random.default_rng(5).normal(size=(2, CROP, CROP, 3)).astype(np.float32)
    want = seg.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                     train=False)["out"]
    port = get_model(arch, device="cpu", seed=9, num_classes=CLASSES, **MODELS[arch])
    with torch.no_grad():
        got = load_model_weights(path, port).eval()(nchw(x))["out"]
    assert rel_max(nhwc(got), want) < TOL

"""The port's training CLI, Trainer and data loader on the CPU, and the rule
that an entry point asked for no device runs on CUDA or raises."""

import json
import logging
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from segtpu.data.synthetic import Synthetic as SegtpuSynthetic
from segtpu_torch.core.steps import prep_images
from segtpu_torch.data.synthetic import Synthetic
from segtpu_torch.models import get_model
from segtpu_torch.trainer import Trainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _config(**trainer):
    synthetic = {"batch_size": 2, "num_classes": 3, "crop_size": 33,
                 "num_workers": 2, "device_normalize": True}
    return {
        "name": "TinyPSP", "seed": 0,
        "arch": {"type": "PSPNet",
                 "args": {"backbone": "resnet18", "pallas_stem_wgrad": True}},
        "train_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 4, "image_hw": 40, "flip": True}},
        "val_loader": {"type": "Synthetic", "args": {
            **synthetic, "size": 3, "image_hw": 33, "val": True,
            "augment": False, "shuffle": False}},
        "optimizer": {"type": "SGD", "differential_lr": True,
                      "args": {"lr": 0.01, "weight_decay": 1e-4, "momentum": 0.9}},
        "loss": "CrossEntropyLoss2d", "ignore_index": 255,
        "lr_scheduler": {"type": "Poly", "args": {}},
        "trainer": {"epochs": 2, "log_per_iter": 1, "val": True,
                    "monitor": "max Mean_IoU", "early_stop": 10,
                    "compute_dtype": "float32", **trainer},
    }


def _run_cli(tmp_path, *args, config=None):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config or _config()))
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    return subprocess.run([sys.executable, "-m", "segtpu_torch.train",
                           "--config", str(cfg), *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_trains_on_cpu(tmp_path):
    """Two epochs of PSPNet-R18 on Synthetic data: a finite loss and a
    Mean_IoU in every epoch, and no kernel launch on the CPU."""
    res = _run_cli(tmp_path, "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    log = res.stderr
    losses = [float(v) for v in re.findall(r"TRAIN epoch \d \| loss ([0-9.naif]+)", log)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    mious = [float(v) for v in re.findall(r"VAL   epoch \d \| .*mIoU ([0-9.]+)", log)]
    assert len(mious) == 2 and all(0.0 <= v <= 1.0 for v in mious)
    assert re.search(r"iter 1 \| loss [0-9.]+ \| lr 0\.00", log)
    assert "kernel launches: stem_conv_wgrad=0" in log


# the progress bar's text at a log_per_iter, as segtpu's: the epoch's log
# line ("TRAIN epoch 1 | loss 1.234 | mIoU ...") does not match it
BAR_TEXT = r"epoch 1 \| loss \d+\.\d{3} \| B \d+\.\d{2} D \d+\.\d{2}"


@pytest.mark.parametrize("bar", [True, False])
def test_cli_draws_the_progress_bar_unless_turned_off(tmp_path, bar):
    """``trainer.progress_bar`` is on by default, as segtpu's: a tqdm bar
    over the epoch on stderr, its text set at each ``log_per_iter``; with
    ``progress_bar: false`` there is none. The log lines stay either way."""
    keys = {"epochs": 1, "val": False, "save_dir": str(tmp_path / "saved"),
            "log_dir": str(tmp_path / "runs")}
    cfg = _config(**keys) if bar else _config(progress_bar=False, **keys)
    res = _run_cli(tmp_path, "--device", "cpu", config=cfg)
    assert res.returncode == 0, res.stderr[-3000:]
    assert bool(re.search(BAR_TEXT, res.stderr)) == bar
    assert ("epoch 1:   0%" in res.stderr) == bar  # the bar drawn before a step
    assert re.search(r"epoch 1 iter 2 \| loss [0-9.]+ \| lr", res.stderr)
    assert re.search(r"TRAIN epoch 1 \| loss [0-9.]+", res.stderr)


def test_trainer_without_tqdm_raises_with_the_bar_on(monkeypatch, tmp_path):
    """With the key on and no tqdm, the epoch raises ``ImportError``, as
    segtpu's does, before its first step; never a quiet skip."""
    monkeypatch.setitem(sys.modules, "tqdm", None)
    trainer = _cpu_trainer(_config(epochs=1, val=False, save_dir=str(tmp_path / "saved"),
                                   log_dir=str(tmp_path / "runs")))
    with pytest.raises(ImportError):
        trainer.train()
    assert trainer.state.step == 0


def test_cli_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    res = _run_cli(tmp_path)
    assert res.returncode != 0
    assert "CUDA was requested but no GPU is visible" in res.stderr


def test_get_model_and_trainer_without_device_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        get_model("PSPNet", num_classes=3, backbone="resnet18")
    cfg = _config()
    loader = Synthetic(**cfg["train_loader"]["args"])
    model = get_model("PSPNet", device="cpu", num_classes=3, backbone="resnet18")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        Trainer(model, "CrossEntropyLoss2d", cfg, loader)


def _cpu_trainer(cfg):
    loader = Synthetic(**cfg["train_loader"]["args"])
    model = get_model("PSPNet", device="cpu", num_classes=3, backbone="resnet18")
    return Trainer(model, "CrossEntropyLoss2d", cfg, loader, device="cpu")


@pytest.mark.parametrize("keys", [{"model_parallel": 2}, {"spatial": True},
                                  {"model_parallel": 4, "spatial": True}])
def test_trainer_raises_on_a_model_axis(keys):
    """segtpu raises when ``model_parallel`` or ``spatial`` asks for a model
    axis its mesh lacks: here one device, which no model axis of 2 or more
    divides, and on which ``spatial`` has no model axis to split H over
    (the model axis itself: ``tests/test_torch_model_axis.py``)."""
    with pytest.raises(ValueError, match=r"does not divide the 1 device\(s\)|need a mesh "
                                         r"with a >1 'model' axis"):
        _cpu_trainer(_config(**keys))


def _warnings(cfg):
    """The Trainer's warnings while it is built from ``cfg`` on the CPU."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("segtpu_torch.Trainer")
    logger.addHandler(handler)
    try:
        trainer = _cpu_trainer(cfg)
    finally:
        logger.removeHandler(handler)
    return trainer, [r.getMessage() for r in records if r.levelno == logging.WARNING]


def test_trainer_warns_on_remat_and_device_keys(tmp_path):
    """``remat`` is honoured (``tests/test_torch_remat.py``), and so are
    ``devices`` and ``device_ids`` (``test_trainer_honours_the_device_keys``):
    none of them warns; ``model_parallel: 1`` and ``spatial: false`` are
    accepted."""
    trainer, msgs = _warnings(_config(remat=True, devices=1, device_ids="0",
                                      model_parallel=1, spatial=False,
                                      save_dir=str(tmp_path),
                                      log_dir=str(tmp_path / "runs")))
    assert msgs == [] and trainer.remat


@pytest.mark.parametrize("keys", [{"devices": 1}, {"device_ids": "0"},
                                  {"device_ids": [0]}])
def test_trainer_honours_the_device_keys(keys, tmp_path):
    """One device asked for in one process: no warning, no process group,
    no GlobalBatchNorm2d, no wrap; more than the process group's ranks
    raise, as a run on N devices is N processes."""
    from segtpu_torch.nn.layers import GlobalBatchNorm2d

    dirs = dict(save_dir=str(tmp_path), log_dir=str(tmp_path / "runs"))
    trainer, msgs = _warnings(_config(**keys, **dirs))
    assert msgs == [] and trainer.world == 1 and trainer.state.wrapped is None
    assert not any(isinstance(m, GlobalBatchNorm2d) for m in trainer.model.modules())
    assert not torch.distributed.is_initialized()
    for more in ({"devices": 2}, {"device_ids": "0,1"}, {"device_ids": [0, 2]}):
        with pytest.raises(ValueError, match=r"ask for 2 device\(s\) but this process "
                                             r"group has 1 rank"):
            _cpu_trainer(_config(**more, **dirs))


def test_cli_device_ids_and_the_devices_a_run_takes(monkeypatch):
    """``-d 0,1`` sets ``trainer.device_ids``; a run takes device_ids, else
    the first ``devices``, else every visible GPU, and raises for more GPUs
    than are visible; on the CPU, ``devices`` processes."""
    from segtpu_torch.train import apply_device_arg, plan_devices

    cfg, dev = apply_device_arg(_config(), "0,1")
    assert (cfg["trainer"]["device_ids"], dev) == ("0,1", "cuda")
    assert apply_device_arg(_config(), "cpu") == (_config(), "cpu")
    with pytest.raises(SystemExit):
        apply_device_arg(_config(), "gpu0")
    assert plan_devices(_config(devices=2), "cpu") == ["cpu", "cpu"]
    assert plan_devices(_config(), "cpu") == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert plan_devices(cfg, "cuda") == ["cuda:0", "cuda:1"]
    assert plan_devices(_config(device_ids=[1]), "cuda") == ["cuda:1"]
    assert plan_devices(_config(devices=1), "cuda") == ["cuda:0"]
    assert plan_devices(_config(), "cuda") == ["cuda:0", "cuda:1"]
    for keys in ({"devices": 3}, {"device_ids": "0,2"}):
        with pytest.raises(ValueError, match="asked for, 2 visible"):
            plan_devices(_config(**keys), "cuda")
    with pytest.raises(ValueError, match="repeat one"):
        plan_devices(_config(device_ids="1,1"), "cuda")


def test_cli_trains_on_two_cpu_processes(tmp_path):
    """``trainer.devices: 2`` with ``--device cpu`` starts 2 gloo processes:
    rank 0 alone logs the run (two epochs, a finite loss and a Mean_IoU in
    each), draws the progress bar and writes its files."""
    cfg = _config(devices=2, save_period=1, save_dir=str(tmp_path / "saved"),
                  log_dir=str(tmp_path / "runs"))
    res = _run_cli(tmp_path, "--device", "cpu", config=cfg)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"TRAIN epoch \d \| loss ([0-9.naif]+)",
                                           res.stderr)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert len(re.findall(r"VAL   epoch \d \| .*mIoU ([0-9.]+)", res.stderr)) == 2
    assert res.stderr.count("kernel launches: stem_conv_wgrad=0") == 1
    # the progress bar (on by default) is drawn on rank 0 alone: one bar an
    # epoch, its text set there
    for epoch in (1, 2):
        assert res.stderr.count(f"epoch {epoch}:   0%") == 1
    assert re.search(BAR_TEXT, res.stderr)
    run_dir, = (tmp_path / "saved" / "TinyPSP").iterdir()
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "best_model", "checkpoint-epoch1", "checkpoint-epoch2", "config.json"]
    assert len(list((tmp_path / "runs").glob("*/*/events.out.tfevents.*"))) == 1


@pytest.mark.parametrize("dtype", ["int8", "bf16", "float64", "Float16"])
def test_trainer_rejects_an_unsupported_compute_dtype(dtype):
    """float16 is taken since segtpu's float16 was ported
    (``tests/test_torch_float16.py``); every name that numpy's dtype does
    not map to float16 or float32, but "bfloat16", still raises."""
    with pytest.raises(ValueError, match=rf"compute_dtype '{dtype}'; supported: "
                                         r"\['bfloat16', 'float16', 'float32'\]"):
        _cpu_trainer(_config(compute_dtype=dtype))


@pytest.mark.parametrize("monitor", ["min val_loss", "max Pixel_Accuracy",
                                     "max no_such_metric"])
def test_trainer_monitor_and_early_stop(monitor, tmp_path):
    """With early_stop 0 the run stops at the first epoch that does not
    improve on the best so far; a metric never computed stops it at once."""
    cfg = _config(epochs=4, monitor=monitor, early_stop=0, save_dir=str(tmp_path),
                  log_dir=str(tmp_path / "runs"))
    loader = Synthetic(**cfg["train_loader"]["args"])
    val = Synthetic(**cfg["val_loader"]["args"])
    model = get_model("PSPNet", device="cpu", num_classes=3, backbone="resnet18")
    history = Trainer(model, "CrossEntropyLoss2d", cfg, loader, val,
                      device="cpu").train()
    assert all({"loss", "val_loss", "Mean_IoU"} <= set(h) for h in history)
    mode, metric = monitor.split()
    if metric not in history[0]:
        assert len(history) == 1
        return
    best, want = history[0][metric], len(history)
    for i, h in enumerate(history[1:], start=2):
        better = h[metric] < best if mode == "min" else h[metric] > best
        if not better:
            want = i
            break
        best = h[metric]
    assert len(history) == want


def test_synthetic_batches_match_segtpu():
    """The port's loader gives segtpu's batches: same samples, crops, flips
    and order (thread workers, per-sample RNG)."""
    args = dict(batch_size=3, size=7, num_classes=4, image_hw=40, crop_size=33,
                flip=True, shuffle=True, num_workers=2, device_normalize=True)
    for (gi, gl), (wi, wl) in zip(Synthetic(**args), SegtpuSynthetic(**args)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_val_loader_pads_the_tail_and_device_normalize_matches_host():
    """The ragged val tail is padded with ignore-labeled samples, and uint8
    transport normalized by the step equals the host's normalization on the
    real samples (1e-6: the same fp32 arithmetic)."""
    args = dict(batch_size=2, size=3, num_classes=4, image_hw=33, crop_size=33,
                val=True, augment=False, shuffle=False, num_workers=1)
    raw = list(Synthetic(**args, device_normalize=True))
    host = list(Synthetic(**args))
    assert len(raw) == 2 and (raw[1][1][1] == -100).all()
    raw_images = np.concatenate([b[0] for b in raw])[:3]
    host_images = np.concatenate([b[0] for b in host])[:3]
    loader = Synthetic(**args)
    x = prep_images(torch.from_numpy(raw_images), (loader.MEAN, loader.STD),
                    torch.float32)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), host_images,
                               rtol=1e-6, atol=1e-6)

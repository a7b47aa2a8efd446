"""Training orchestration: the epoch loop, validation, monitoring, early
stop, checkpoints, resume and preemption.

Counterpart of ``segtpu/trainer.py``. Seg stats and the running loss stay on
the device through an epoch; the host reads the loss at log boundaries and
everything at the epoch's end.

Each run writes ``<save_dir>/<name>/<timestamp>/``: ``config.json``,
``checkpoint-epoch{N}`` every ``save_period`` epochs, ``best_model`` when the
monitored metric improved, and ``checkpoint-latest`` every
``save_per_iters`` iterations or on SIGTERM. A resume from a mid-epoch
checkpoint replays the rest of the same epoch's batch order.

A model built with ``pretrained`` gets its encoder from a local ``.pth``
file before any resume (``pretrained.py``). With ``tensorboard`` (the
default), segtpu's events go to ``<log_dir>/<name>/<timestamp>/`` (log_dir
``saved/runs`` by default; ``utils/tensorboard.py``): ``train/loss`` every
``log_per_iter`` iterations, the epoch's train metrics and learning rates,
the val metrics and the 15-row val grid of input, target and prediction.
``profile: N`` traces the first N steps of the first epoch with
``torch.profiler`` into ``<checkpoint dir>/profile/``, a Chrome trace.
"""

from __future__ import annotations

import datetime
import json
import logging
import math
import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from segtpu_torch import losses as loss_lib
from segtpu_torch import metrics as metrics_lib
from segtpu_torch import resolve_device
from segtpu_torch.checkpoint import load_checkpoint, save_checkpoint
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_eval_step, make_train_step
from segtpu_torch.data import DevicePrefetcher
from segtpu_torch.metrics import AverageMeter, SegStats
from segtpu_torch.pretrained import maybe_load_pretrained
from segtpu_torch.utils.helpers import colorize_mask, denormalize, dir_exists
from segtpu_torch.utils.logger import setup_logging
from segtpu_torch.utils.tensorboard import SummaryWriter

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: segtpu's trainer keys that the port does not implement yet: each is
#: ignored with a warning
_NOT_PORTED = ("remat", "devices", "device_ids")
#: the val batches whose first image goes into the grid
_VIZ_BATCHES = 15


class TrainingPreempted(RuntimeError):
    """Raised inside the epoch loop after a SIGTERM's checkpoint-latest was
    written (its message says where the resumed run starts)."""


class Trainer:
    """Trains ``model`` on ``train_loader`` from a config with segtpu's
    schema. ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``;
    ``trainer.compute_dtype`` ("bfloat16" default, or "float32") picks the
    activation dtype. ``resume`` is a checkpoint directory to continue
    from; ``train_logger`` (a ``utils.logger.Logger``) gets each epoch's
    log."""

    def __init__(self, model, loss, config: Dict, train_loader,
                 val_loader=None, device="cuda", resume: Optional[str] = None,
                 train_logger=None):
        self.device = resolve_device(device)
        setup_logging()
        self.logger = logging.getLogger(f"segtpu_torch.{type(self).__name__}")
        self.config = config
        self.train_logger = train_logger
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.num_classes = train_loader.dataset.num_classes
        self.ignore_index = config.get("ignore_index", 255)
        self.loss_fn = loss_lib.get_loss(loss) if isinstance(loss, str) else loss

        cfg_trainer = config["trainer"]
        model_parallel = int(cfg_trainer.get("model_parallel", 1))
        spatial = bool(cfg_trainer.get("spatial", False))
        if model_parallel > 1 or spatial:
            raise ValueError(
                f"trainer.model_parallel={model_parallel}/spatial={spatial} need a "
                f"'model' mesh axis; segtpu_torch runs on one device and has no "
                f"model axis (ROADMAP)")
        dtype_name = cfg_trainer.get("compute_dtype", "bfloat16")
        if dtype_name not in _DTYPES:
            raise ValueError(f"unsupported trainer.compute_dtype {dtype_name!r}; "
                             f"supported: {sorted(_DTYPES)}")
        self.compute_dtype = _DTYPES[dtype_name]
        self.epochs = cfg_trainer["epochs"]
        self.save_period = cfg_trainer.get("save_period", 10)
        self.save_per_iters = cfg_trainer.get("save_per_iters", 0)
        for key in _NOT_PORTED:
            if cfg_trainer.get(key):
                self.logger.warning(f"trainer.{key} is not ported yet "
                                    f"(ROADMAP); ignored")
        self.start_epoch = 1
        self._resume_iter = 0
        self._preempted = False
        #: the TrainingPreempted that ended the last train(), else None
        self.preempted: Optional[TrainingPreempted] = None
        self.do_validation = cfg_trainer.get("val", True) and val_loader is not None
        self.val_per_epochs = cfg_trainer.get("val_per_epochs", 1)
        self.log_per_iter = cfg_trainer.get("log_per_iter", 20)
        self.history = []

        model = model.to(self.device)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        opt_cfg = config.get("optimizer", {"type": "SGD", "args": {}})
        sched_cfg = config.get("lr_scheduler", {"type": "Poly", "args": {}})
        optimizer, schedules = make_optimizer(
            model,
            optimizer_type=opt_cfg.get("type", "SGD"),
            differential_lr=opt_cfg.get("differential_lr", True),
            freeze_backbone=config.get("arch", {}).get("args", {}).get(
                "freeze_backbone", False),
            scheduler_type=sched_cfg.get("type", "Poly"),
            scheduler_args=sched_cfg.get("args", {}),
            num_epochs=self.epochs,
            iters_per_epoch=max(len(train_loader), 1),
            **opt_cfg.get("args", {}))
        self.state = TrainState(model, optimizer, schedules)
        # in place, so the optimizer keeps its parameters; before a resume,
        # which overwrites it
        maybe_load_pretrained(model, config)
        # dropout draws from the global generator: seeded from the config as
        # segtpu seeds its dropout key (seed + 1), restored by a resume
        torch.manual_seed(config.get("seed", 0) + 1)

        # uint8 transport: the loaders ship raw pixels and the steps
        # normalize on the device; train and val must agree on it
        dev_norm = train_loader.dataset.device_normalize
        if val_loader is not None and val_loader.dataset.device_normalize != dev_norm:
            raise ValueError("train_loader and val_loader disagree on "
                             "device_normalize; set it in both loader args")
        self.norm_stats = ((train_loader.dataset.mean, train_loader.dataset.std)
                           if dev_norm else None)
        self.train_step = make_train_step(
            self.loss_fn, ignore_index=self.ignore_index,
            compute_dtype=self.compute_dtype, norm_stats=self.norm_stats)
        self.eval_step = make_eval_step(
            self.loss_fn, ignore_index=self.ignore_index,
            compute_dtype=self.compute_dtype, norm_stats=self.norm_stats)

        self.monitor = cfg_trainer.get("monitor", "off")
        if self.monitor == "off":
            self.mnt_mode, self.mnt_best = "off", 0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"trainer.monitor must start with min or max, "
                                 f"got {self.monitor!r}")
            self.mnt_best = -math.inf if self.mnt_mode == "max" else math.inf
            self.early_stopping = cfg_trainer.get("early_stop", math.inf)
        self.improved = False
        self.not_improved_count = 0

        start_time = datetime.datetime.now().strftime("%m-%d_%H-%M")
        self.checkpoint_dir = os.path.join(cfg_trainer.get("save_dir", "saved/"),
                                           config.get("name", "run"), start_time)
        dir_exists(self.checkpoint_dir)
        with open(os.path.join(self.checkpoint_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=4, sort_keys=True)
        self.writer = None
        if cfg_trainer.get("tensorboard", True):
            self.writer = SummaryWriter(os.path.join(
                cfg_trainer.get("log_dir", "saved/runs"), config.get("name", "run"),
                start_time))
        self.profile_steps = cfg_trainer.get("profile", 0)
        self.profile_dir = os.path.join(self.checkpoint_dir, "profile")
        self.wrt_step = 0
        if resume:
            self._resume_checkpoint(resume)

    @property
    def model(self):
        return self.state.model

    def train(self):
        """Runs the epochs; returns the per-epoch logs. A SIGTERM ends the
        run cleanly after writing ``checkpoint-latest``; ``self.preempted``
        then holds the :class:`TrainingPreempted`."""
        self.preempted = None
        self._install_preemption_handler()
        try:
            self._train_loop()
        except TrainingPreempted as e:
            self.preempted = e
            self.logger.warning(
                f"Preempted (SIGTERM): checkpoint-latest written ({e}). Resume "
                f"with --resume "
                f"{os.path.join(self.checkpoint_dir, 'checkpoint-latest')}")
        finally:
            self._restore_preemption_handler()
            if self.writer is not None:
                self.writer.close()
        return self.history

    def _install_preemption_handler(self):
        """SIGTERM sets a flag that the loop reads at the next iteration
        boundary. Signal handlers can only be set from the main thread;
        elsewhere (a trainer driven from another thread) this is a no-op."""
        self._preempted = False
        self._handler_installed = False
        if threading.current_thread() is threading.main_thread():
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_preempt)
            self._handler_installed = True

    def _restore_preemption_handler(self):
        # signal.signal returns None for a handler installed from C; that is
        # restored as the default
        if self._handler_installed:
            signal.signal(signal.SIGTERM, self._prev_sigterm
                          if self._prev_sigterm is not None else signal.SIG_DFL)
            self._handler_installed = False
            self._prev_sigterm = None

    def _on_preempt(self, signum, frame):
        self._preempted = True

    def _save_latest(self, epoch: int, extra_meta: Optional[Dict] = None):
        save_checkpoint(self.checkpoint_dir, "checkpoint-latest", self.state,
                        epoch, self.mnt_best, self.config,
                        type(self.model).__name__, extra_meta=extra_meta)

    def _train_loop(self):
        for epoch in range(self.start_epoch, self.epochs + 1):
            results = self._train_epoch(epoch)
            if self._preempted:
                # SIGTERM on the epoch's last iteration: keep the finished
                # epoch now, before a long validation can outlast the grace
                # period; no resume_iter, so the resume starts at epoch + 1
                self._save_latest(epoch)
                raise TrainingPreempted(f"after epoch {epoch}, before validation")
            if self.do_validation and epoch % self.val_per_epochs == 0:
                # val metrics replace the train ones; the train loss stays
                results = {**results, **self._valid_epoch(epoch)}
            log = {"epoch": epoch, **results}
            self.history.append(log)
            if self.train_logger is not None:
                self.train_logger.add_entry(log)
            if self.writer is not None:
                self.writer.flush()

            if self.mnt_mode != "off" and epoch % self.val_per_epochs == 0:
                if self.mnt_metric not in log:
                    self.logger.warning(f"The metric being tracked "
                                        f"({self.mnt_metric}) has not been "
                                        f"calculated. Training stops.")
                    break
                if self.mnt_mode == "min":
                    improved = log[self.mnt_metric] < self.mnt_best
                else:
                    improved = log[self.mnt_metric] > self.mnt_best
                self.improved = improved
                if improved:
                    self.mnt_best = log[self.mnt_metric]
                    self.not_improved_count = 0
                else:
                    self.not_improved_count += 1
                if self.not_improved_count > self.early_stopping:
                    self.logger.info(f"Performance didn't improve for "
                                     f"{self.early_stopping} epochs")
                    self.logger.warning("Training Stopped")
                    break

            if epoch % self.save_period == 0:
                self._save_checkpoint(epoch, save_best=self.improved)
            if self._preempted:
                # SIGTERM during validation or the bookkeeping after it
                self._save_latest(epoch)
                raise TrainingPreempted(f"after epoch {epoch}")

    def _log_dict(self, loss_key, loss, stats):
        seg = metrics_lib.summarize(stats)
        return {loss_key: round(loss, 3),
                "Pixel_Accuracy": float(seg["Pixel_Accuracy"]),
                "Mean_IoU": float(seg["Mean_IoU"]),
                "Class_IoU": {k: float(v) for k, v in seg["Class_IoU"].items()}}

    def _train_epoch(self, epoch: int) -> Dict:
        total = SegStats.zeros(self.num_classes, self.device)
        loss_acc = torch.zeros((), device=self.device)
        batch_time, data_time = AverageMeter(), AverageMeter()
        n_iters = 0
        skip = 0
        if self._resume_iter and epoch == self.start_epoch:
            # mid-epoch resume: the rest of this epoch's order
            skip, self._resume_iter = self._resume_iter, 0
            self.train_loader.skip_batches(skip)
        iters_per_epoch = len(self.train_loader)
        profiler = None
        if self.profile_steps > 0 and epoch == self.start_epoch:
            profiler = self._start_profile()
        tic = time.perf_counter()
        # D: the wait for the next batch on the device. The finally stops a
        # trace that a SIGTERM (or a failed step) ends early, so it is whole.
        try:
            for it, (images, labels) in enumerate(
                    DevicePrefetcher(self.train_loader, self.device)):
                data_time.update(time.perf_counter() - tic)
                if profiler is not None and it == self.profile_steps:
                    self._stop_profile(profiler)
                    profiler = None
                loss, stats = self.train_step(self.state, images, labels)
                total = total + stats
                loss_acc += loss
                n_iters += 1
                it_abs = it + skip  # the position in the epoch's order
                if it_abs + 1 < iters_per_epoch and (
                        self._preempted or (self.save_per_iters and
                                            (it_abs + 1) % self.save_per_iters == 0)):
                    # the state holds this iteration's update; a resume
                    # replays the order from it_abs + 1 (a SIGTERM on the last
                    # iteration is handled in _train_loop)
                    self._save_latest(epoch - 1, extra_meta={
                        "resume_epoch": epoch, "resume_iter": it_abs + 1})
                    if self._preempted:
                        raise TrainingPreempted(
                            f"epoch {epoch} iter {it_abs + 1}/{iters_per_epoch}")
                if (it + 1) % self.log_per_iter == 0:
                    loss_val = float(loss)
                    lrs = ", ".join(f"{lr:.6g}" for lr in self.state.current_lrs())
                    self.logger.info(f"epoch {epoch} iter {it_abs + 1} | loss "
                                     f"{loss_val:.4f} | lr {lrs}")
                    self.wrt_step = (epoch - 1) * iters_per_epoch + it_abs + 1
                    if self.writer is not None:
                        self.writer.add_scalar("train/loss", loss_val, self.wrt_step)
                batch_time.update(time.perf_counter() - tic)
                tic = time.perf_counter()
        finally:
            if profiler is not None:
                self._stop_profile(profiler)
        avg_loss = float(loss_acc) / max(n_iters, 1)
        log = self._log_dict("loss", avg_loss, total)
        if self.writer is not None:
            for k in ("Pixel_Accuracy", "Mean_IoU"):
                self.writer.add_scalar(f"train/{k}", log[k], self.wrt_step)
            # one a parameter group, segtpu's order: decoder, then backbone
            for i, lr in enumerate(self.state.current_lrs()):
                self.writer.add_scalar(f"train/Learning_rate_{i}", lr, self.wrt_step)
        self.logger.info(
            f"TRAIN epoch {epoch} | loss {avg_loss:.3f} | "
            f"mIoU {log['Mean_IoU']:.3f} | PixAcc {log['Pixel_Accuracy']:.3f} | "
            f"B {batch_time.average:.3f}s D {data_time.average:.3f}s")
        return log

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(self.profile_dir))
        profiler.start()
        return profiler

    def _stop_profile(self, profiler):
        """Waits for the traced steps' device work, then writes the trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        self.logger.info(f"profile of the first {self.profile_steps} steps written "
                         f"to {self.profile_dir}")

    def _valid_epoch(self, epoch: int) -> Dict:
        """val_loss is weighted by each batch's valid pixels, so the padded
        tail batch does not bias it. With tensorboard, the first image of
        each of the first 15 batches goes into the val grid: its argmax is
        taken on the device, and only that image is copied to the host."""
        total = SegStats.zeros(self.num_classes, self.device)
        loss_acc = torch.zeros((), device=self.device)
        weight_acc = torch.zeros((), device=self.device)
        viz = []
        for it, (images, labels) in enumerate(DevicePrefetcher(self.val_loader, self.device)):
            loss, stats, logits = self.eval_step(self.model, images, labels)
            if self.writer is not None and it < _VIZ_BATCHES:
                pred = torch.argmax(logits[:1], dim=1)[0]
                viz.append((images[0].cpu().numpy(), labels[0].cpu().numpy(),
                            pred.cpu().numpy()))
            total = total + stats
            loss_acc += loss * stats.labeled
            weight_acc += stats.labeled
        avg_loss = float(loss_acc) / max(float(weight_acc), 1e-12)
        log = self._log_dict("val_loss", avg_loss, total)
        if self.writer is not None:
            self._write_val_grid(viz, epoch)
            self.wrt_step = epoch * max(len(self.train_loader), 1)
            self.writer.add_scalar("val/loss", avg_loss, self.wrt_step)
            for k in ("Pixel_Accuracy", "Mean_IoU"):
                self.writer.add_scalar(f"val/{k}", log[k], self.wrt_step)
        self.logger.info(
            f"VAL   epoch {epoch} | loss {avg_loss:.3f} | "
            f"mIoU {log['Mean_IoU']:.3f} | PixAcc {log['Pixel_Accuracy']:.3f}")
        return log

    def _write_val_grid(self, viz, epoch: int):
        """Rows of (input | target | prediction), segtpu's grid: uint8
        pixels over 255 or the denormalized image, the target (ignore shown
        as 255) and the prediction through the palette; CHW in [0, 1]."""
        if not viz:
            return
        ds = self.val_loader.dataset
        rows = []
        for img, tgt, pred in viz:
            if img.dtype == np.uint8:  # uint8 transport: raw pixels
                rgb = img.astype(np.float32) / 255.0
            else:
                rgb = denormalize(img, ds.mean, ds.std)
            tgt_rgb = np.asarray(colorize_mask(np.where(tgt < 0, 255, tgt), ds.palette)
                                 .convert("RGB"), np.float32) / 255.0
            pred_rgb = np.asarray(colorize_mask(pred, ds.palette).convert("RGB"),
                                  np.float32) / 255.0
            rows.append(np.concatenate([rgb, tgt_rgb, pred_rgb], axis=1))
        grid = np.concatenate(rows, axis=0)
        self.writer.add_image("val/inputs_targets_predictions", grid.transpose(2, 0, 1), epoch)

    def _save_checkpoint(self, epoch: int, save_best: bool = False):
        arch = type(self.model).__name__
        name = f"checkpoint-epoch{epoch}"
        self.logger.info(f"Saving a checkpoint: {name}")
        save_checkpoint(self.checkpoint_dir, name, self.state, epoch,
                        self.mnt_best, self.config, arch)
        if save_best:
            save_checkpoint(self.checkpoint_dir, "best_model", self.state,
                            epoch, self.mnt_best, self.config, arch)
            self.logger.info("Saving current best: best_model")

    def _resume_checkpoint(self, resume_path: str):
        self.logger.info(f"Loading checkpoint: {resume_path}")
        meta = load_checkpoint(resume_path, self.state)
        self.start_epoch = meta.get("epoch", 0) + 1
        if "resume_iter" in meta:
            self.start_epoch = meta["resume_epoch"]
            self._resume_iter = meta["resume_iter"]
            self.logger.info(f"Mid-epoch checkpoint: resuming epoch "
                             f"{self.start_epoch} at batch {self._resume_iter}")
        # the loader's shuffle stream is positioned on the resumed epoch, so
        # the batch order matches an uninterrupted run
        self.train_loader.set_epoch(self.start_epoch - 1)
        if meta.get("monitor_best") is not None:  # None: no validation yet
            self.mnt_best = meta["monitor_best"]
        self.not_improved_count = 0
        ck_cfg = meta.get("config", {})
        if ck_cfg.get("arch") != self.config.get("arch"):
            self.logger.warning("Warning! Current model is not the same as the "
                                "one in the checkpoint")
        if (ck_cfg.get("optimizer", {}).get("type")
                != self.config.get("optimizer", {}).get("type")):
            self.logger.warning("Warning! Current optimizer is not the same as "
                                "the one in the checkpoint")
        self.logger.info(f"Checkpoint <{resume_path}> (epoch {self.start_epoch}) "
                         f"was loaded")

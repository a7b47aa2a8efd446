"""Checkpoints: save, resume, and load weights for inference.

Counterpart of ``segtpu/checkpoint.py``. A checkpoint is a directory
``<directory>/<name>/`` with two files:

* ``state.pt``: the model's ``state_dict()`` (in the original torch repo's
  key layout), the optimizer's ``state_dict()``, the update count and the
  random generators' states (the CPU one, and the card's where the model
  lives on one), so that dropout draws the same masks after a resume;
* ``meta.json``: ``epoch``, ``monitor_best`` (``null`` when not finite),
  ``config``, ``arch``, plus ``extra_meta`` (a mid-epoch checkpoint's
  ``resume_epoch``/``resume_iter``).

A checkpoint is written under a temporary name and renamed into place, so a
preempted process never leaves a torn one under ``name``. ``state.pt`` holds
tensors in plain containers only and loads with ``weights_only=True``.

Under a process group every rank calls :func:`save_checkpoint` at the same
point: each rank's generators' states are gathered, and rank 0 alone writes
them (under ``rng["ranks"]``) beside the unwrapped model's keys. Every rank
waits at a barrier and then reads a checkpoint in :func:`load_checkpoint`,
taking its own generators' states where the checkpoint has them; so a
checkpoint saved on N ranks resumes on M. Under tensor parallelism
(``core/tensor_parallel.py``) the sharded weights and their optimizer
state are gathered into the one-device layout on save and cut back to
each rank's slices on load, so a checkpoint of a sharded run resumes on
one rank, and one of a single rank on a sharded run, bit for bit; the
inference and serving paths read it as any other.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, Optional

import torch

from segtpu_torch.core import mesh, tensor_parallel

_META = "meta.json"
_STATE = "state.pt"


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _rng_state(device: torch.device) -> Dict:
    rng = {"cpu": torch.get_rng_state()}
    if device.type == "cuda":
        rng["cuda"] = torch.cuda.get_rng_state(device)
    return rng


def _set_rng_state(rng: Dict, device: torch.device) -> None:
    torch.set_rng_state(rng["cpu"])
    if device.type == "cuda" and "cuda" in rng:
        torch.cuda.set_rng_state(rng["cuda"], device)


def save_checkpoint(directory: str, name: str, state, epoch: int,
                    monitor_best: float, config: Dict, arch: str,
                    extra_meta: Optional[Dict] = None) -> str:
    """Write ``state`` (a :class:`~segtpu_torch.core.state.TrainState`) and
    its metadata to ``<directory>/<name>/``; returns that path. Under a
    process group, a collective: rank 0 writes."""
    path = os.path.abspath(os.path.join(directory, name))
    rng = _rng_state(_device_of(state.model))
    model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
    if tensor_parallel.sharded_dims(state.model):  # a collective of every rank
        model_sd, opt_sd = tensor_parallel.gather_state(state.model, state.optimizer,
                                                        model_sd, opt_sd)
    if mesh.initialized():
        ranks = mesh.gather_objects({k: v.cpu() for k, v in rng.items()})
        if not mesh.is_main():
            return path
        rng = {**rng, "ranks": ranks}
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"model": model_sd, "optimizer": opt_sd,
                "step": int(state.step), "rng": rng},
               os.path.join(tmp, _STATE))
    # +/-inf means "no validation has run yet": store None so a resume keeps
    # its own fresh init instead of a bound a 'min' monitor never beats
    mb = float(monitor_best)
    meta = {"epoch": epoch, "monitor_best": mb if math.isfinite(mb) else None,
            "config": config, "arch": arch, **(extra_meta or {})}
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    # the old checkpoint stays whole under ``path`` or ``old`` until the new
    # one is in place
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path


def _load_state(path: str, device: torch.device) -> Dict:
    return torch.load(os.path.join(os.path.abspath(path), _STATE),
                      map_location=device, weights_only=True)


def read_meta(path: str) -> Dict:
    """The checkpoint's ``meta.json``, or ``{}`` where there is none."""
    meta_path = os.path.join(os.path.abspath(path), _META)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_checkpoint(path: str, state) -> Dict:
    """Restore model, optimizer, update count and random generators into
    ``state`` in place; returns the checkpoint's meta. The tensors land on
    the model's device whatever device they were saved from. They are read
    on the CPU: the optimizer moves its state to each parameter's device
    itself, and keeps the step counts of Adam-like optimizers on the CPU,
    where torch makes them.

    Under a process group every rank waits for the others first (a
    checkpoint rank 0 has just written is whole), then reads; rank r takes
    its own generators' states where the checkpoint has r ranks or more,
    else rank 0's, reseeded from them and r, so that the ranks' dropout
    masks still differ."""
    mesh.barrier()
    device = _device_of(state.model)
    saved = _load_state(path, torch.device("cpu"))
    model_sd, opt_sd = saved["model"], saved["optimizer"]
    if tensor_parallel.sharded_dims(state.model):
        model_sd, opt_sd = tensor_parallel.scatter_state(state.model, state.optimizer,
                                                         model_sd, opt_sd)
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)
    state.step = int(saved["step"])
    r, ranks = mesh.rank(), saved["rng"].get("ranks", [])
    _set_rng_state(ranks[r] if r < len(ranks) else saved["rng"], device)
    if r >= max(len(ranks), 1):
        torch.manual_seed(torch.randint(2 ** 62, (1,)).item() + r)
    return read_meta(path)


def load_model_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore only the model's weights (the inference path: no optimizer
    needs to be rebuilt); returns ``model``."""
    model.load_state_dict(_load_state(path, _device_of(model))["model"])
    return model


def load_config_from_checkpoint(path: str) -> Optional[Dict]:
    return read_meta(path).get("config")

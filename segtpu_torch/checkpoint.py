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
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, Optional

import torch

_META = "meta.json"
_STATE = "state.pt"


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def save_checkpoint(directory: str, name: str, state, epoch: int,
                    monitor_best: float, config: Dict, arch: str,
                    extra_meta: Optional[Dict] = None) -> str:
    """Write ``state`` (a :class:`~segtpu_torch.core.state.TrainState`) and
    its metadata to ``<directory>/<name>/``; returns that path."""
    path = os.path.abspath(os.path.join(directory, name))
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    device = _device_of(state.model)
    rng = {"cpu": torch.get_rng_state()}
    if device.type == "cuda":
        rng["cuda"] = torch.cuda.get_rng_state(device)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
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
    where torch makes them."""
    device = _device_of(state.model)
    saved = _load_state(path, torch.device("cpu"))
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    torch.set_rng_state(saved["rng"]["cpu"])
    if device.type == "cuda" and "cuda" in saved["rng"]:
        torch.cuda.set_rng_state(saved["rng"]["cuda"], device)
    return read_meta(path)


def load_model_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore only the model's weights (the inference path: no optimizer
    needs to be rebuilt); returns ``model``."""
    model.load_state_dict(_load_state(path, _device_of(model))["model"])
    return model


def load_config_from_checkpoint(path: str) -> Optional[Dict]:
    return read_meta(path).get("config")

"""Training traffic (``kind: train_step``): the port's train step, dispatched
back to back on a ring of device-resident batches.

Set-up builds one train state as the port's trainer builds it
(``core/state.make_optimizer``, ``TrainState``, ``core/steps.make_train_step``;
the configuration's model holding the benchmark's weights), makes
``ring`` distinct batches from the seed on the device (uint8 NHWC images
normalised in the step with the configuration's ``norm_stats``; labels in
blocks of ``label_block`` pixels, a share ``ignore_share`` of the blocks
``ignore_index``), and drives the state through ``checked_steps`` steps of
the window's own call on the ring's first batches, which warm up every
shape. Their losses, the first step's outputs (``out`` and ``aux``), the
first gradient of each leaf (the optimizer's momentum buffer after one
step, less the weight decay's share) and each leaf's change over the
checked steps are kept for the check, and the keep
masks of the model's dropouts are read from their outputs (an element is
dropped where the dropout's input is not 0 and its output is), with the
share of its live elements each call dropped.

The window dispatches steps on the ring, from where the checked steps
stopped, with no synchronise between them, until ``seconds`` have passed on
the host's clock, then synchronises: ``train_imgs_per_s`` is the images of
every dispatched step over that time, ``train_peak_gib`` the largest
allocation in it.

The check runs the reference from the same weights on the same batches,
with the same masks, in float32 without TF32: its losses, first outputs,
first gradients and changes against the program's (``check.py``); and the
widest gap of a dropout call's drop rate from the traffic's ``dropout_p``
(``drop_rate_gap``), since the masks the reference takes are the program's.

``subject="control"`` puts the reference computed in float8 in the
program's place (no window): the benchmark's control.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from segbench import check, devices, program, reference
from segbench.reference import train as ref_train
from segbench.reference.precision import strict_fp32

#: the units of the end-to-end metrics :meth:`Session.window` returns
UNITS = {"train_imgs_per_s": "imgs/s", "train_peak_gib": "GiB"}
_BATCH_SALT = 0xBA7C
_MASK_SALT = 0xD0
_DROPOUT_SALT = 0xD1
GIB = 2.0 ** 30


def make_batches(traffic: dict, config: dict, seed: int, device: torch.device):
    """``traffic["ring"]`` batches of (uint8 NHWC images, int32 labels),
    drawn from ``seed`` on ``device`` in a few calls."""
    n, b, crop = traffic["ring"], traffic["batch"], traffic["crop"]
    block = traffic["label_block"]
    g = torch.Generator(device=device).manual_seed(_BATCH_SALT ^ int(seed))
    coarse = -(-crop // 32)
    low = torch.rand(n * b, 3, coarse, coarse, generator=g, device=device)
    fine = torch.rand(n * b, 3, crop, crop, generator=g, device=device)
    images = F.interpolate(low, size=(crop, crop), mode="bilinear", align_corners=False)
    images = (images * 200.0 + fine * 55.0).clamp(0, 255).to(torch.uint8)
    images = images.permute(0, 2, 3, 1).contiguous()
    cells = -(-crop // block)
    classes = torch.randint(0, config["num_classes"], (n * b, 1, cells, cells),
                            generator=g, device=device)
    ignored = torch.rand(n * b, 1, cells, cells, generator=g, device=device) < traffic[
        "ignore_share"]
    classes = torch.where(ignored, config["ignore_index"], classes)
    labels = F.interpolate(classes.float(), scale_factor=block, mode="nearest")
    labels = labels[:, 0, :crop, :crop].to(torch.int32)
    return [(images[i * b:(i + 1) * b], labels[i * b:(i + 1) * b]) for i in range(n)]


def normalize(images: torch.Tensor, config: dict) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW ``(x / 255 - mean) / std``."""
    mean = torch.tensor(config["norm_stats"]["mean"], device=images.device).view(1, 3, 1, 1)
    std = torch.tensor(config["norm_stats"]["std"], device=images.device).view(1, 3, 1, 1)
    return (images.permute(0, 3, 1, 2).float() / 255.0 - mean) / std


def total_updates(traffic: dict) -> int:
    sched = traffic["lr_scheduler"]
    return sched["epochs"] * sched["iters_per_epoch"]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, values))


class Readings:
    """What the checked steps of one subject give: losses, first gradient
    norms and change norms by leaf."""

    def __init__(self):
        self.losses: List[float] = []
        self.outputs: Dict[str, torch.Tensor] = {}  # the first step's, on the host
        self.grads: Dict[str, float] = {}
        self.changes: Dict[str, float] = {}

    def keep_outputs(self, model: torch.nn.Module):
        """A hook that keeps ``model``'s first outputs (float32, on the
        host); remove it after the step."""
        def keep(module, inputs, outputs):
            if not self.outputs:
                self.outputs = {k: v.detach().float().cpu() for k, v in outputs.items()}
        return model.register_forward_hook(keep)


class MaskMismatch(ValueError):
    """The program's dropout ran on another shape than the reference's."""


class _MaskTape:
    """Keep masks by (step, dropout name): read from the program's dropouts,
    or drawn from the seed (the control's run); and each call's drop rate."""

    def __init__(self, seed: int, p: float, recorded: bool):
        self.recorded = recorded
        self.masks: Dict[tuple, torch.Tensor] = {}
        self.drop_rates: List[float] = []
        self.step = 0
        self.gen_seed = _MASK_SALT ^ int(seed)
        self.p = p

    def hook(self, name):
        def record(module, inputs, output):
            live = inputs[0] != 0
            kept = output != 0
            self.masks[(self.step, name)] = kept.cpu()
            self.drop_rates.append(float((live & ~kept).sum() / live.sum().clamp(min=1)))
        return record

    def source(self, name, shape, device):
        key = (self.step, name)
        if key not in self.masks and self.recorded:
            raise KeyError(f"no mask of dropout {name!r} was read at step {self.step}")
        if key not in self.masks:
            g = torch.Generator(device=device).manual_seed(
                self.gen_seed + 1000 * self.step + len(self.masks))
            self.masks[key] = (torch.rand(shape, generator=g, device=device) >= self.p).cpu()
            self.drop_rates.append(1.0 - float(self.masks[key].float().mean()))
        if tuple(self.masks[key].shape) != tuple(shape):
            raise MaskMismatch(f"dropout {name!r} at step {self.step}: the program's mask is "
                               f"{tuple(self.masks[key].shape)}, the reference's input {shape}")
        return self.masks[key].to(device)


class Session:
    """One run of a training cell: set-up in the constructor, then
    :meth:`window`, :meth:`traced`, :meth:`release` and :meth:`check`."""

    unit = "step"

    def __init__(self, cell, seed: int, device: torch.device, subject: str = "program"):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic, self.config = cell.traffic, cell.config
        self.subject = subject
        phases = devices.Phases(device)
        state = program.weights(self.config, self.seed, device)
        self.ring = make_batches(self.traffic, self.config, self.seed, device)
        self.tape = _MaskTape(self.seed, self.traffic["dropout_p"], subject == "program")
        phases.mark("weights and batches")
        if subject == "program":
            self._build_program(state)
        else:
            self._build_control(state)
        del state
        phases.mark("model, optimizer and step")
        # the program's dropouts draw from the global generators, which a
        # caller seeds (the port's trainer from its config)
        torch.manual_seed(_DROPOUT_SALT ^ self.seed)
        self.readings = self._checked_steps()
        phases.mark("checked steps")
        self.next = self.traffic["checked_steps"]
        self.memory_peak_bytes = devices.peak_bytes(device)
        self.window_units = 0
        self.window_s = 0.0

    # -- the program -------------------------------------------------------

    def _build_program(self, state) -> None:
        from segtpu_torch import losses
        from segtpu_torch.core import state as state_lib
        from segtpu_torch.core import steps
        from segtpu_torch.nn.layers import convert_global_bn

        t, cfg = self.traffic, self.config
        model = program.build_model(cfg, state, self.device)
        convert_global_bn(model)
        opt_cfg, sched = t["optimizer"], t["lr_scheduler"]
        optimizer, schedules = state_lib.make_optimizer(
            model, optimizer_type=opt_cfg["type"],
            differential_lr=opt_cfg["differential_lr"], scheduler_type=sched["type"],
            num_epochs=sched["epochs"], iters_per_epoch=sched["iters_per_epoch"],
            **opt_cfg["args"])
        self.state = state_lib.TrainState(model, optimizer, schedules)
        norm = (cfg["norm_stats"]["mean"], cfg["norm_stats"]["std"])
        self.step_fn = steps.make_train_step(
            losses.get_loss(t["loss"]), ignore_index=cfg["ignore_index"],
            aux_weight=t["aux_weight"], compute_dtype=getattr(torch, t["compute_dtype"]),
            norm_stats=norm)
        self.named = dict(model.named_parameters())

    def _program_step(self, i: int) -> torch.Tensor:
        images, labels = self.ring[i % len(self.ring)]
        loss, _ = self.step_fn(self.state, images, labels)
        return loss

    def _program_first_grads(self, p0) -> Dict[str, torch.Tensor]:
        """The first gradient as the optimizer took it: its momentum buffer
        after one step (``g + wd * p0``) less ``wd * p0``; NaN where the step
        made no update."""
        opt = self.state.optimizer
        by_id = {id(p): n for n, p in self.named.items()}
        grads = {}
        for group in opt.param_groups:
            for p in group["params"]:
                name = by_id[id(p)]
                buf = opt.state[p].get("momentum_buffer")
                if buf is None:  # no update was made
                    grads[name] = torch.full_like(p, float("nan"))
                else:
                    grads[name] = buf - group["weight_decay"] * p0[name]
        return grads

    # -- the control: the reference in float8 in the program's place -------

    def _build_control(self, state) -> None:
        with torch.device(self.device):
            model = reference.build(self.config, "fp8", self.tape.source)
        model.load_state_dict(state)
        opt = self.traffic["optimizer"]["args"]
        self.control = (model, ref_train.SGD(model, opt["lr"], opt["momentum"],
                                             opt["weight_decay"], total_updates(self.traffic)))
        self.named = dict(model.named_parameters())

    def _control_step(self, i: int) -> torch.Tensor:
        model, sgd = self.control
        images, labels = self.ring[i % len(self.ring)]
        with strict_fp32():
            return torch.tensor(ref_train.train_step(model, sgd, normalize(images, self.config),
                                                     labels, self.traffic["aux_weight"]))

    # -- set-up's checked steps --------------------------------------------

    def _checked_steps(self) -> Readings:
        r = Readings()
        p0 = {n: p.detach().clone() for n, p in self.named.items()}
        model = self.state.model if self.subject == "program" else self.control[0]
        hooks = [r.keep_outputs(model)]
        if self.subject == "program":
            hooks += [m.register_forward_hook(self.tape.hook(n))
                      for n, m in model.named_modules() if isinstance(m, torch.nn.Dropout)]
        try:
            for i in range(self.traffic["checked_steps"]):
                self.tape.step = i
                step = self._program_step if self.subject == "program" else self._control_step
                r.losses.append(float(step(i)))
                if i == 0:
                    if self.subject == "program":
                        r.grads = _norms(self._program_first_grads(p0))
                    else:
                        r.grads = _norms({n: p.grad for n, p in self.named.items()})
        finally:
            for h in hooks:
                h.remove()
        r.changes = _norms({n: p.detach() - p0[n] for n, p in self.named.items()})
        return r

    # -- the window ---------------------------------------------------------

    def _unit(self) -> None:
        with torch.profiler.record_function("segbench.step"):
            self._program_step(self.next)
        self.next += 1

    def window(self, seconds: float) -> Dict[str, float]:
        devices.synchronize(self.device)
        devices.reset_peak(self.device)
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._unit()
            steps += 1
        devices.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        peak = devices.peak_bytes(self.device)
        self.memory_peak_bytes = max(self.memory_peak_bytes, peak)
        self.window_units, self.window_s = steps, elapsed
        return {"train_imgs_per_s": steps * self.traffic["batch"] / elapsed,
                "train_peak_gib": peak / GIB}

    def traced(self):
        from segbench import trace

        return trace.profile(self._unit, self.traffic["trace_steps"], counters=kernel_launches)

    @property
    def attempted(self) -> int:
        return self.window_units

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        for name in ("state", "step_fn", "named", "control"):
            self.__dict__.pop(name, None)
        gc.collect()
        devices.free(self.device)

    def reference_readings(self) -> Readings:
        """The reference's checked steps in float32 (TF32 off), from the
        same weights, batches and masks."""
        r = Readings()
        state = program.weights(self.config, self.seed, self.device)
        with torch.device(self.device):
            model = reference.build(self.config, "fp32", self.tape.source)
        model.load_state_dict(state)
        del state
        opt = self.traffic["optimizer"]["args"]
        sgd = ref_train.SGD(model, opt["lr"], opt["momentum"], opt["weight_decay"],
                            total_updates(self.traffic))
        named = dict(model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named.items()}
        hook = r.keep_outputs(model)
        with strict_fp32():
            for i in range(self.traffic["checked_steps"]):
                self.tape.step = i
                images, labels = self.ring[i]
                r.losses.append(ref_train.train_step(model, sgd, normalize(images, self.config),
                                                     labels, self.traffic["aux_weight"]))
                if i == 0:
                    r.grads = _norms({n: p.grad for n, p in named.items()})
        hook.remove()
        r.changes = _norms({n: p.detach() - p0[n] for n, p in named.items()})
        del model, sgd, named, p0
        gc.collect()
        devices.free(self.device)
        return r

    def check(self) -> Dict[str, float]:
        got = self.readings
        try:
            ref = self.reference_readings()
        except MaskMismatch as e:  # the program computed on other shapes
            print(f"segbench: {e}", file=sys.stderr)
            return dict.fromkeys(("loss_gap", "logit_gap", "grad_gap", "change_gap",
                                  "drop_rate_gap"), math.nan)
        grads = check.leaf_gaps(got.grads, ref.grads)
        changes = check.leaf_gaps(got.changes, ref.changes, check.moving_leaves(ref.grads))
        self.diagnostics = {
            "losses": got.losses, "reference_losses": ref.losses,
            "worst_grads": sorted(grads.items(), key=lambda kv: -kv[1])[:5],
            "worst_changes": sorted(changes.items(), key=lambda kv: -kv[1])[:5],
            "median_grad_gap": statistics.median(grads.values()),
            "median_change_gap": statistics.median(changes.values()),
            "dropout_drop_rates": self.tape.drop_rates}
        print(f"segbench: {json.dumps(self.diagnostics)}", file=sys.stderr)
        return {"loss_gap": check.loss_gap(got.losses, ref.losses),
                "logit_gap": check.output_gap(got.outputs, ref.outputs),
                "grad_gap": check.worst(grads)[0], "change_gap": check.worst(changes)[0],
                "drop_rate_gap": check.rate_gap(self.tape.drop_rates, self.tape.p)}


def kernel_launches() -> Dict[str, float]:
    """The port's kernel launch counters."""
    from segtpu_torch.ops import conv_wgrad, flatconv

    return {"stem_conv_wgrad.launches": conv_wgrad.stem_conv_wgrad.launches,
            "flat_conv_wgrad.launches": flatconv.flat_conv_wgrad.launches,
            "flat_conv_dgrad.launches": flatconv.flat_conv_dgrad.launches}

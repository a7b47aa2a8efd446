"""Train state and optimizer construction.

Counterpart of ``segtpu/core/state.py``: torch-semantics SGD, Adam, AdamW,
RMSprop (plain or centered) and Adagrad, in two parameter groups, the
decoder at ``lr`` and the backbone at ``lr/10``, under a per-iteration
schedule (Poly or OneCycle). Before update t (counting from 0) each group's
lr is set to its schedule at t, which is how optax's
``scale_by_learning_rate`` applies it in segtpu; under OneCycle, SGD's
momentum is set the same way from the momentum schedule.

segtpu re-derives these optimizers in optax with torch's semantics; here
they are ``torch.optim``'s own, in torch's default form (the for-loop on
the CPU, ``foreach`` on the card; never ``fused``). ``freeze_backbone``
leaves the backbone out of the optimizer and stops its gradients: its
parameters keep their bits and weight decay does not reach them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from segtpu_torch import schedules as sched_lib

#: segtpu's ``_OPTIMIZERS``: each name's class and the config arguments
#: segtpu's transform reads besides ``weight_decay`` (and SGD's and
#: RMSprop's ``momentum``); others are dropped, as segtpu drops them
OPTIMIZERS = {"SGD": (torch.optim.SGD, ()),
              "Adam": (torch.optim.Adam, ("betas", "eps")),
              "AdamW": (torch.optim.AdamW, ("betas", "eps")),
              "RMSprop": (torch.optim.RMSprop, ("alpha", "eps", "centered")),
              "Adagrad": (torch.optim.Adagrad,
                          ("eps", "lr_decay", "initial_accumulator_value"))}


def partition_labels(model: nn.Module) -> Dict[str, str]:
    """``'backbone'`` for parameters under the model's backbone modules
    (``model.backbone_modules``), ``'decoder'`` for the rest."""
    backbone = set(getattr(model, "backbone_modules", ()))
    return {name: "backbone" if name.split(".")[0] in backbone else "decoder"
            for name, _ in model.named_parameters()}


def make_optimizer(
    model: nn.Module,
    optimizer_type: str = "SGD",
    lr: float = 0.01,
    momentum: Optional[float] = None,
    weight_decay: float = 1e-4,
    nesterov: bool = False,
    differential_lr: bool = True,
    freeze_backbone: bool = False,
    scheduler_type: str = "Poly",
    num_epochs: int = 80,
    iters_per_epoch: int = 1000,
    scheduler_args: Optional[Dict] = None,
    **opt_args,
):
    """``(optimizer, [lr schedule per group])`` from the config's
    "optimizer" and "lr_scheduler" fields; ``opt_args`` (``betas``, ``eps``,
    ``alpha``, ``centered``, ``lr_decay``, ``initial_accumulator_value``)
    go to the ``torch.optim`` class.

    Group 0 is the decoder; with ``differential_lr`` group 1 is the backbone
    at 0.1x. With ``freeze_backbone`` the backbone has no group, but both
    schedules are still returned for the log, as segtpu's are. SGD's
    momentum defaults to 0.9 and RMSprop's to 0, as segtpu's. Under
    OneCycle, an SGD optimizer carries the momentum schedule as
    ``optimizer.momentum_schedule`` (None otherwise), which
    :meth:`TrainState.apply_gradients` reads; the others ignore it, as
    segtpu's do."""
    if optimizer_type not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer type {optimizer_type!r}; "
                         f"supported: {sorted(OPTIMIZERS)}")
    scheduler_args = dict(scheduler_args or {})
    mom_sched = None
    if scheduler_type == "OneCycle":
        sched, mom_sched = sched_lib.one_cycle(lr, num_epochs, iters_per_epoch,
                                               **scheduler_args)
    else:
        sched = sched_lib.get_schedule(scheduler_type)(
            lr, num_epochs, iters_per_epoch, **scheduler_args)
    cls, accepted = OPTIMIZERS[optimizer_type]
    kwargs = {k: v for k, v in opt_args.items() if k in accepted}
    kwargs["weight_decay"] = weight_decay
    if optimizer_type == "SGD":
        kwargs.update(momentum=0.9 if momentum is None else momentum, nesterov=nesterov)
        if mom_sched is not None:
            kwargs["momentum"] = mom_sched(0)
    else:
        if optimizer_type == "RMSprop":
            kwargs["momentum"] = 0.0 if momentum is None else momentum
        mom_sched = None

    labels = partition_labels(model)
    named = list(model.named_parameters())
    decoder = [p for n, p in named if labels[n] == "decoder"]
    backbone = [p for n, p in named if labels[n] == "backbone"]
    schedules = [sched, lambda s: sched(s) * 0.1] if differential_lr else [sched]
    if freeze_backbone:
        for p in backbone:
            p.requires_grad_(False)
        groups = [{"params": decoder}]
    elif differential_lr:
        groups = [{"params": decoder}, {"params": backbone}]
    else:
        groups = [{"params": decoder + backbone}]
    opt = cls(groups, lr=sched(0), **kwargs)
    opt.momentum_schedule = mom_sched
    return opt, schedules


class TrainState:
    """Model, optimizer, per-group schedules and the update count.

    ``model`` is always the unwrapped module: checkpoints hold its keys (no
    ``module.`` prefix), so a run saved on N ranks resumes on M. Under a
    process group of more than one rank, :meth:`data_parallel` adds the
    wrap that the train step runs through (:attr:`train_module`); with a
    model axis, :meth:`model_axis` sums the gradients instead
    (:meth:`sync_gradients`)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedules: List[Callable[[int], float]]):
        self.model = model
        self.optimizer = optimizer
        self.schedules = schedules
        self.step = 0
        self.wrapped: Optional[nn.Module] = None
        #: [(group, scale, parameters)] whose gradients :meth:`sync_gradients`
        #: sums
        self.grad_groups: Optional[list] = None

    def model_axis(self) -> None:
        """Sum the gradients over the model axis's groups after each
        backward (``core/mesh.py``'s table): a parameter sharded by
        ``core/tensor_parallel.py`` over the data group (its weight gather
        summed the model group's parts already); a replicated one over the
        world, divided by the model axis's size under tensor parallelism
        alone, whose model ranks each hold the whole gradient (the mean of
        equal terms is their value, and the division by a power of two is
        exact; it keeps the replicas' bits equal where the card's
        nondeterministic sums part them). Built after the optimizer, on the
        sharded model; frozen parameters are left out."""
        from segtpu_torch.core import mesh, tensor_parallel

        sharded = tensor_parallel.sharded_dims(self.model)
        scale = 1.0 if mesh.spatial() else 1.0 / mesh.model_size()
        groups = {}
        for name, p in self.model.named_parameters():
            if p.requires_grad:
                key = (mesh.data_group(), 1.0) if name in sharded else (None, scale)
                groups.setdefault((id(key[0]), key[1]), (*key, []))[2].append(p)
        self.grad_groups = [g for g in groups.values() if mesh.group_size(g[0]) > 1]

    def sync_gradients(self) -> None:
        """Each group's gradients summed over it (and scaled), in one
        all-reduce a group (no-op without :meth:`model_axis`)."""
        import torch.distributed as dist

        for group, scale, params in self.grad_groups or ():
            grads = [p.grad for p in params if p.grad is not None]
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            if scale != 1.0:
                flat.mul_(scale)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def data_parallel(self) -> None:
        """Wrap the model in ``DistributedDataParallel`` over the default
        process group, after the optimizer was built on the unwrapped
        module (its parameter groups and ``backbone_modules`` unchanged;
        frozen parameters, which need no gradient, are left out of the
        all-reduce). The wrap's first broadcast makes every rank's weights
        rank 0's. Buffers are not broadcast: ``GlobalBatchNorm2d`` keeps the
        running statistics equal on every rank. ``find_unused_parameters``
        stays off: every model of the zoo uses all its parameters."""
        from torch.nn.parallel import DistributedDataParallel

        dev = next(self.model.parameters()).device
        self.wrapped = DistributedDataParallel(
            self.model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)

    @property
    def train_module(self) -> nn.Module:
        """The module a train step runs: the wrap where there is one."""
        return self.model if self.wrapped is None else self.wrapped

    def apply_gradients(self) -> None:
        """One optimizer update at the schedules' rates for this step, and
        at the momentum schedule's momentum where the optimizer has one."""
        mom_sched = getattr(self.optimizer, "momentum_schedule", None)
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(self.step)
            if mom_sched is not None:
                group["momentum"] = mom_sched(self.step)
        self.optimizer.step()
        self.step += 1

    def current_lrs(self) -> List[float]:
        """The per-group rates of the last update applied (both groups'
        with ``differential_lr``, a frozen backbone's included)."""
        step = max(self.step - 1, 0)
        return [s(step) for s in self.schedules]

"""Train and eval steps.

Counterpart of ``segtpu/core/steps.py``: forward, plus ``aux_weight`` times
the aux loss, backward, the optimizer update, then seg stats from the
logits, which stay on the device. Activations run under autocast to the
16-bit ``compute_dtype`` (bfloat16, or float16 as segtpu takes it); BN,
loss and optimizer state stay fp32. ``compute_dtype=torch.float32`` runs
everything in fp32 (the CPU tests). As in segtpu, float16 has no loss
scaler: gradients under its smallest normal are subnormal or zero.

Under a process group the step runs through the state's data-parallel wrap
(``TrainState.data_parallel``) and its loss is the global batch's
(``losses.py``); the loss is scaled by the world size before ``backward``,
so that the wrap's mean of the ranks' gradients is the gradient of the
global loss, as segtpu's under its mesh. With a model axis
(``TrainState.model_axis``) there is no wrap: the gradients are summed over
the axis's groups after ``backward``. Under spatial sharding the images and
labels are this rank's rows (``core/spatial.py``), and ``rows`` is their
layout over the model group.
The stats stay each rank's own until the trainer sums them at the epoch's
end.

While ``torch.profiler`` records, the train step runs in the port's span
``segtpu_torch.step`` (``tracing.py``), whose children are ``.prep``,
``.forward`` (the model and the loss), ``.backward`` (``zero_grad`` and
``backward``), ``.grad_sync`` (where the state has gradient groups),
``.optimizer`` and ``.seg_stats``.

``remat`` (segtpu's ``trainer.remat``) wraps the forward in
``torch.utils.checkpoint`` (``use_reentrant=False``, dropout's generator
state preserved): the backward recomputes the activations instead of
keeping them. The recompute's BatchNorms update copies of their running
statistics, so the forward's update stays the only one.

Batches come in as the loader makes them: NHWC images (uint8 raw pixels
with ``norm_stats``, else normalized float) and (B, H, W) labels, already on
the device. The NHWC -> NCHW permute is a view, so the model sees a
channels_last tensor.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from segtpu_torch.core import mesh, spatial
from segtpu_torch.core.state import TrainState
from segtpu_torch.metrics import seg_stats_from_logits
from segtpu_torch.nn.layers import remat
from segtpu_torch.tracing import span


def prep_images(images: torch.Tensor, norm_stats,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """NHWC batch -> NCHW (channels_last) in ``compute_dtype``. With
    ``norm_stats=(mean, std)`` the uint8 pixels are normalized here as
    ``(x/255 - mean)/std`` in fp32."""
    x = images.permute(0, 3, 1, 2)
    if norm_stats is not None:
        mean, std = (torch.as_tensor(v, dtype=torch.float32).to(x.device)
                     .view(1, -1, 1, 1) for v in norm_stats)
        x = (x.float() / 255.0 - mean) / std
    return x.to(compute_dtype)


#: the compute dtypes that run under autocast
HALF_DTYPES = (torch.bfloat16, torch.float16)


def autocast(device: torch.device, compute_dtype: torch.dtype):
    """Autocast to ``compute_dtype`` on ``device`` where it is 16-bit, on the
    GPU and on the CPU alike; off for float32 and float64."""
    half = compute_dtype in HALF_DTYPES
    return torch.autocast(device_type=device.type,
                          dtype=compute_dtype if half else torch.bfloat16, enabled=half)


def _in_compute_dtype(logits: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """The logits in a 16-bit ``compute_dtype``, as segtpu's stay in it end
    to end: CUDA's autocast runs the bilinear resize in float32, so the
    model's logits come out float32 there (the CPU's stay 16-bit). The seg
    stats' argmax (``metrics._argmax``) and the val grid take them so."""
    if compute_dtype in HALF_DTYPES and logits.dtype != compute_dtype:
        return logits.to(compute_dtype)
    return logits


def _forward_loss(model, x, labels, loss_fn, ignore_index, aux_weight, compute_dtype,
                  use_remat=False):
    with autocast(x.device, compute_dtype):
        outputs = remat(model, model, x) if use_remat else model(x)
    logits = outputs["out"]
    loss = loss_fn(logits, labels, ignore_index=ignore_index)
    if "aux" in outputs:
        loss = loss + aux_weight * loss_fn(outputs["aux"], labels,
                                           ignore_index=ignore_index)
    return loss, logits


def _rows_scope(x, rows):
    """The layouts' scope under spatial sharding; nothing otherwise."""
    if not mesh.spatial():
        return contextlib.nullcontext()
    if rows is None:
        raise ValueError("spatial: the step takes the input's layout (rows=)")
    return spatial.sharded(x, rows)


def make_train_step(loss_fn: Callable, ignore_index: int = 255,
                    aux_weight: float = 0.4,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    norm_stats=None, remat: bool = False):
    """Returns ``step(state, images, labels, rows=None) -> (loss,
    SegStats)``; the state's model and optimizer are updated in place.
    ``rows`` is the input's layout under spatial sharding."""

    def step(state: TrainState, images, labels, rows=None):
        with span("segtpu_torch.step"):
            model = state.train_module
            model.train()
            with span("segtpu_torch.step.prep"):
                x = prep_images(images, norm_stats, compute_dtype)
            with _rows_scope(x, rows):
                with span("segtpu_torch.step.forward"):
                    loss, logits = _forward_loss(model, x, labels, loss_fn, ignore_index,
                                                 aux_weight, compute_dtype, remat)
                with span("segtpu_torch.step.backward"):
                    state.optimizer.zero_grad(set_to_none=True)
                    if state.wrapped is None:
                        loss.backward()
                    else:  # the wrap's mean of the ranks' gradients becomes their sum
                        (loss * mesh.world_size()).backward()
            if state.grad_groups:
                with span("segtpu_torch.step.grad_sync"):
                    state.sync_gradients()
            with span("segtpu_torch.step.optimizer"):
                state.apply_gradients()
            with torch.no_grad(), span("segtpu_torch.step.seg_stats"):
                stats = seg_stats_from_logits(
                    _in_compute_dtype(logits.detach(), compute_dtype), labels)
            return loss.detach(), stats

    return step


def make_eval_step(loss_fn: Callable, ignore_index: int = 255,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   norm_stats=None):
    """Returns ``step(model, images, labels, rows=None) -> (loss, SegStats,
    logits)`` in eval mode, without gradients; the logits, in a 16-bit
    ``compute_dtype`` when it is one, stay on the device (this rank's rows
    under spatial sharding)."""

    @torch.no_grad()
    def step(model, images, labels, rows=None):
        model.eval()
        x = prep_images(images, norm_stats, compute_dtype)
        with _rows_scope(x, rows):
            loss, logits = _forward_loss(model, x, labels, loss_fn, ignore_index,
                                         0.0, compute_dtype)
        logits = _in_compute_dtype(logits, compute_dtype)
        return loss, seg_stats_from_logits(logits, labels), logits

    return step

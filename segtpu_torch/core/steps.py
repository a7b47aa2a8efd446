"""Train and eval steps.

Counterpart of ``segtpu/core/steps.py``: forward, plus ``aux_weight`` times
the aux loss, backward, the optimizer update, then seg stats from the
logits, which stay on the device. Activations run under bf16 autocast; BN,
loss and optimizer state stay fp32. ``compute_dtype=torch.float32`` runs
everything in fp32 (the CPU tests).

Batches come in as the loader makes them: NHWC images (uint8 raw pixels
with ``norm_stats``, else normalized float) and (B, H, W) labels, already on
the device. The NHWC -> NCHW permute is a view, so the model sees a
channels_last tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from segtpu_torch.core.state import TrainState
from segtpu_torch.metrics import seg_stats_from_logits


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


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          enabled=compute_dtype == torch.bfloat16)


def _forward_loss(model, x, labels, loss_fn, ignore_index, aux_weight, compute_dtype):
    with _autocast(x.device, compute_dtype):
        outputs = model(x)
    logits = outputs["out"]
    loss = loss_fn(logits, labels, ignore_index=ignore_index)
    if "aux" in outputs:
        loss = loss + aux_weight * loss_fn(outputs["aux"], labels,
                                           ignore_index=ignore_index)
    return loss, logits


def make_train_step(loss_fn: Callable, ignore_index: int = 255,
                    aux_weight: float = 0.4,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    norm_stats=None):
    """Returns ``step(state, images, labels) -> (loss, SegStats)``; the
    state's model and optimizer are updated in place."""

    def step(state: TrainState, images, labels):
        model = state.model
        model.train()
        x = prep_images(images, norm_stats, compute_dtype)
        loss, logits = _forward_loss(model, x, labels, loss_fn, ignore_index,
                                     aux_weight, compute_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            stats = seg_stats_from_logits(logits.detach(), labels)
        return loss.detach(), stats

    return step


def make_eval_step(loss_fn: Callable, ignore_index: int = 255,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   norm_stats=None):
    """Returns ``step(model, images, labels) -> (loss, SegStats, logits)``
    in eval mode, without gradients; the logits stay on the device."""

    @torch.no_grad()
    def step(model, images, labels):
        model.eval()
        x = prep_images(images, norm_stats, compute_dtype)
        loss, logits = _forward_loss(model, x, labels, loss_fn, ignore_index,
                                     0.0, compute_dtype)
        return loss, seg_stats_from_logits(logits, labels), logits

    return step

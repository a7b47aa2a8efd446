"""Streaming segmentation metrics, kept on the device.

Counterpart of ``segtpu/metrics.py``: per-batch (correct, labeled, inter,
union) are computed where the logits are and summed there; the host reads
them once, in :func:`summarize`. Under a process group each rank's sums are
its own shard's until :meth:`SegStats.all_reduce`.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from segtpu_torch.ops.reductions import fast_argmax, onehot_first_max, packed_argmax

#: the values of ``SEGTPU_ARGMAX``, segtpu's switch of the prediction argmax
ARGMAX_VARIANTS = ("packed", "fast", "jnp")


class SegStats(NamedTuple):
    """Confusion-style accumulators (float32): ``correct, labeled`` for pixel
    accuracy, per-class ``inter, union`` for IoU."""

    correct: torch.Tensor  # scalar
    labeled: torch.Tensor  # scalar
    inter: torch.Tensor    # (num_classes,)
    union: torch.Tensor    # (num_classes,)

    @staticmethod
    def zeros(num_classes: int, device="cpu") -> "SegStats":
        z = torch.zeros((), dtype=torch.float32, device=device)
        zc = torch.zeros(num_classes, dtype=torch.float32, device=device)
        return SegStats(z, z.clone(), zc, zc.clone())

    def __add__(self, other: "SegStats") -> "SegStats":
        return SegStats(*(a + b for a, b in zip(self, other)))

    def all_reduce(self) -> "SegStats":
        """The sums over the ranks whose pixels differ (one collective; every
        rank without a model axis); ``self`` outside a group. The trainer
        calls it once an epoch, before :func:`summarize`."""
        from segtpu_torch.core import mesh

        return SegStats(*mesh.global_sums(*self, group=mesh.pixel_group()))


def seg_stats(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> SegStats:
    """Per-batch stats from integer predictions and targets (any shape).
    Pixels whose target is outside ``[0, num_classes)`` are excluded."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = (target >= 0) & (target < num_classes)
    match = (pred == target) & valid
    c = num_classes

    def count(idx, mask):
        # masked-out pixels land in an extra bin that is dropped
        return torch.bincount(torch.where(mask, idx, c), minlength=c + 1)[:c].float()

    inter = count(target, match)
    area_pred = count(pred.clamp(0, c - 1), valid)
    area_lab = count(target, valid)
    return SegStats(match.sum().float(), valid.sum().float(), inter,
                    area_pred + area_lab - inter)


def seg_stats_from_logits(logits: torch.Tensor, target: torch.Tensor) -> SegStats:
    """Stats straight from (B, C, H, W) logits, through segtpu's prediction
    argmax (:func:`_argmax`)."""
    return seg_stats(_argmax(logits), target, logits.shape[1])


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """segtpu's prediction argmax over the classes of (B, C, H, W) logits.
    ``SEGTPU_ARGMAX`` (read at each call) picks it: ``packed``
    (:func:`packed_argmax`, which compares bfloat16 roundings), ``fast`` or
    ``jnp`` (both the first maximum, ``torch.argmax``). Unset, 16-bit logits
    (bfloat16 and float16) take ``packed`` and wider ones ``fast``, as in
    segtpu. Another value raises, where segtpu falls back to ``fast``."""
    variant = os.environ.get("SEGTPU_ARGMAX", "")
    if not variant:
        variant = ("packed" if logits.dtype in (torch.bfloat16, torch.float16)
                   else "fast")
    if variant == "packed":
        return packed_argmax(logits, dim=1)
    if variant in ("fast", "jnp"):
        return fast_argmax(logits, dim=1)
    raise ValueError(f"SEGTPU_ARGMAX={variant!r}; it takes one of "
                     f"{', '.join(ARGMAX_VARIANTS)}")


def seg_stats_from_logits_onehot(logits: torch.Tensor, target: torch.Tensor) -> SegStats:
    """segtpu's index-free form of :func:`seg_stats_from_logits`: the counts
    come from the one-hot of the first maximum (:func:`onehot_first_max`,
    which compares the logits in their own dtype, as ``fast`` does), with
    no argmax index. Equal to :func:`seg_stats_from_logits` under
    ``SEGTPU_ARGMAX=fast``."""
    c = logits.shape[1]
    onehot_p = onehot_first_max(logits, dim=1).movedim(1, -1).reshape(-1, c)
    target = target.reshape(-1).long()
    valid = (target >= 0) & (target < c)
    onehot_t = F.one_hot(torch.where(valid, target, 0), c).float() * valid[:, None]
    inter = (onehot_p * onehot_t).sum(0)
    area_pred = (onehot_p * valid[:, None]).sum(0)
    area_lab = onehot_t.sum(0)
    return SegStats(inter.sum(), valid.sum().float(), inter,
                    area_pred + area_lab - inter)


def eval_metrics(logits: torch.Tensor, target: torch.Tensor, num_classes: int) -> SegStats:
    """segtpu's ``eval_metrics``: the stats of the (B, C, H, W) logits'
    prediction argmax (:func:`_argmax`), on the device."""
    return seg_stats(_argmax(logits), target, num_classes)


def summarize(stats: SegStats) -> Dict[str, object]:
    """Host-side summary: pixel accuracy, mIoU, per-class IoU (rounded to 3
    places, with the 1e-10-scale epsilon of segtpu)."""
    correct, labeled, inter, union = (t.detach().cpu().double().numpy()
                                      for t in stats)
    eps = np.spacing(1, dtype=np.float64)
    pix_acc = 1.0 * correct / (eps + labeled)
    iou = 1.0 * inter / (eps + union)
    return {
        "Pixel_Accuracy": np.round(pix_acc, 3),
        "Mean_IoU": np.round(iou.mean(), 3),
        "Class_IoU": dict(zip(range(len(iou)), np.round(iou, 3))),
    }


class AverageMeter:
    """Weighted streaming mean."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, weight=1):
        self.val = val
        self.sum += val * weight
        self.count += weight

    @property
    def average(self):
        return self.sum / max(self.count, 1e-12)

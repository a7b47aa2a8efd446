"""Streaming segmentation metrics, kept on the device.

Counterpart of ``segtpu/metrics.py``: per-batch (correct, labeled, inter,
union) are computed where the logits are and summed there; the host reads
them once, in :func:`summarize`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


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
    """Stats straight from (B, C, H, W) logits. The argmax is the first
    maximum, on the logits' own dtype (bf16 logits are compared as bf16)."""
    return eval_metrics(logits, target, logits.shape[1])


def eval_metrics(logits: torch.Tensor, target: torch.Tensor, num_classes: int) -> SegStats:
    """segtpu's ``eval_metrics``: the stats of the (B, C, H, W) logits'
    argmax (``torch.argmax``, the first maximum), on the device."""
    return seg_stats(torch.argmax(logits, dim=1), target, num_classes)


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

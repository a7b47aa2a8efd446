"""Shape alignment: the original's ``F.pad`` semantics, and crops.

Counterpart of ``segtpu/ops/shape.py::pad_or_crop_tl``. The original aligns
a decoder output to a skip or identity with ``F.pad(x, (dw, 0, dh, 0))``
(ENet's bottlenecks, GCN's deconv decoder), where a negative width crops;
segtpu re-derived that as a pad and a slice, and here it is the call
itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_or_crop_tl(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW ``x`` to ``h`` x ``w``: zeros added, or rows and columns cut, at
    the top and left only."""
    dh, dw = h - x.shape[-2], w - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (dw, 0, dh, 0))


def crop(x: torch.Tensor, top: int, left: int, size) -> torch.Tensor:
    """NCHW ``x``'s rows ``[top, top + size[0])`` and columns ``[left, left
    + size[1])`` (DeepLab_DUC_HDC's crops to the low-level map and to the
    input, SegResNet's ceil-crop and centre crop)."""
    return x[..., top:top + int(size[0]), left:left + int(size[1])]


def hw(x: torch.Tensor):
    """The map's (H, W) (its global size under spatial sharding, where the
    model's crop arithmetic reads it through an attribute)."""
    return int(x.shape[-2]), int(x.shape[-1])

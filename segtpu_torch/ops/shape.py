"""Shape alignment with the original's ``F.pad`` semantics.

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

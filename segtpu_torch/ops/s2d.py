"""Space-to-depth stem convolution.

Counterpart of ``segtpu/ops/s2d.py``. A stride-2 conv over (C, H, W) is
exactly a stride-1 conv over the 2x2 space-to-depth view (4C, H/2, W/2)
with the kernel's taps redistributed the same way:

    y[o, oi, oj] = sum_{c,ky,kx} w[o, c, ky, kx] * xp[c, 2oi+ky, 2oj+kx]
                 = sum_{(dy,dx,c),ty,tx} w2[o, (dy,dx,c), ty, tx] * z[(dy,dx,c), oi+ty, oj+tx]

with ``z[(dy,dx,c), i, j] = xp[c, 2i+dy, 2j+dx]`` and ``ky = 2ty+dy``: the
same multiply-adds, in another order. The weight stays in the stride-2
layout (``(O, C, k, k)``), so checkpoints and converters are unchanged;
the relayout is part of the forward, and autograd carries the gradient
back through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2), channels in (dy, dx, c) order;
    H and W even."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth takes an even H and W, got {h} x {w}")
    z = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return z.reshape(n, 4 * c, h // 2, w // 2)


def s2d_weight(weight: torch.Tensor) -> torch.Tensor:
    """(O, C, k, k) stride-2 weight -> (O, 4C, ceil(k/2), ceil(k/2))
    stride-1 weight; odd k is zero-padded to k+1 at the bottom and right
    (taps the stride-2 windows never read)."""
    o, c, k, _ = weight.shape
    ke = k + k % 2
    w = F.pad(weight, (0, ke - k, 0, ke - k))
    w = w.reshape(o, c, ke // 2, 2, ke // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return w.reshape(o, 4 * c, ke // 2, ke // 2)


def s2d_stem_conv(x: torch.Tensor, weight: torch.Tensor, padding: int,
                  pad_h=None) -> torch.Tensor:
    """Bias-free stride-2 conv of NCHW ``x`` with the (O, C, k, k)
    ``weight``, computed as a stride-1 conv in space-to-depth space; equal
    to ``F.conv2d(x, weight, stride=2, padding=padding)``. ``pad_h = (top,
    bottom)`` pads H instead of ``padding`` (a band of an image sharded over
    H, x carrying its halo rows)."""
    n, c, h, w = x.shape
    k = weight.shape[2]
    top, bottom = (padding, padding) if pad_h is None else pad_h
    # one more zero row or column where the padded size is odd, so the 2x2
    # blocks tile it: no window of the stride-2 conv reads it
    eh = (h + top + bottom) % 2
    ew = (w + 2 * padding) % 2
    z = space_to_depth(F.pad(x, (padding, padding + ew, top, bottom + eh)))
    out = F.conv2d(z, s2d_weight(weight).to(z.dtype))
    oh = (h + top + bottom - k) // 2 + 1
    ow = (w + 2 * padding - k) // 2 + 1
    return out[:, :, :oh, :ow]


class S2DStemConv2d(nn.Module):
    """The stem's first conv (k x k, stride 2, pad k//2, no bias) through
    :func:`s2d_stem_conv`. Same ``weight`` (O, I, k, k) as the
    ``nn.Conv2d`` it replaces."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, weight_init):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.weight_init = weight_init
        weight_init(self.weight.data, None)

    def forward(self, x):
        return s2d_stem_conv(x, self.weight, self.kernel_size // 2)

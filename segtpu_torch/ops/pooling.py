"""Pooling on NCHW tensors, with torch semantics.

Counterpart of ``segtpu/ops/pooling.py``: the ResNet stem's 3x3/2/pad-1 max
pool, UNet's and ENet's ceil-mode pools, the PSP pyramid's adaptive average
pools, ASPP's image mean, and the argmax pools and unpools of SegNet, SegResNet and ENet.
segtpu re-derived these as TPU matmuls, one-hot expands and compare/select
planes; here they are torch's own pooling, which defines the semantics
segtpu reproduces (bin i of an adaptive pool covers ``[floor(i*in/out),
ceil((i+1)*in/out))``; the first row-major maximum of a window wins),
except :func:`max_unpool_flat`, whose winner torch's CUDA kernel leaves to
a race.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window=2, stride=None, padding=0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch-style max pool (padding never wins: it is -inf); ``ceil_mode``
    keeps a last partial window."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)


def adaptive_avg_pool_multi(x: torch.Tensor, sizes: Sequence) -> List[torch.Tensor]:
    """``adaptive_avg_pool2d(x, s)`` for every bin size ``s``."""
    return [F.adaptive_avg_pool2d(x, s) for s in sizes]


def image_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W, kept as a 1x1 map, summed in at least fp32
    (ASPP's image pool)."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).mean(
        dim=(2, 3), keepdim=True).to(x.dtype)


def max_pool_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/stride-2 max pool that also returns where each maximum came from
    (SegNet's encoder, ENet's downsampling blocks). Odd edges keep a last
    partial window, as segtpu's -inf padding does. The indices are torch's,
    flat positions in the input plane for :func:`max_unpool`; segtpu's are
    positions inside the window, so only the pooled and unpooled values
    compare."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True, return_indices=True)


def max_unpool(y: torch.Tensor, idx: torch.Tensor, output_size) -> torch.Tensor:
    """Inverse of :func:`max_pool_argmax`: each pooled value back at its
    argmax in a zero plane of ``output_size`` (the pool's input size). The
    2x2/2 windows do not overlap, so no position is written twice."""
    return F.max_unpool2d(y, idx, 2, 2, output_size=tuple(output_size))


def max_pool_argmax_flat(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3/stride-2/pad-1 ``max_pool2d(..., return_indices=True)``, whose
    windows overlap (SegResNet's stem pool): the indices are flat row-major
    positions ``h*W + w`` in each input plane, segtpu's to the element."""
    return F.max_pool2d(x, 3, 2, 1, return_indices=True)


class _MaxUnpoolFlat(torch.autograd.Function):
    """torch-CPU's ``max_unpool2d`` on every device.

    Overlapping windows can pick one input position, and the values put
    back there are the decoder's, which differ. torch's CPU kernel writes
    the pooled pixels in row-major order, so the last one's value stays;
    segtpu reproduces that, and torch's CUDA kernel races. Here the winner
    is decided first: each pooled pixel's row-major ordinal goes into the
    canvas by an ``amax`` scatter, an order-free reduction, and the
    winners' values are gathered. The backward is torch's: every pooled
    pixel reads the cotangent at its index, losers included."""

    @staticmethod
    def forward(ctx, y, idx, output_hw):
        b, c, ho, wo = y.shape
        oh, ow = output_hw
        flat_idx = idx.reshape(b, c, ho * wo)
        ordinal = torch.arange(ho * wo, device=y.device, dtype=torch.int32)
        winner = torch.full((b, c, oh * ow), -1, device=y.device, dtype=torch.int32)
        winner.scatter_reduce_(2, flat_idx, ordinal.expand(b, c, -1), "amax")
        taken = winner >= 0
        values = y.reshape(b, c, ho * wo).gather(2, winner.clamp(min=0).long())
        out = torch.where(taken, values, torch.zeros((), dtype=y.dtype, device=y.device))
        ctx.save_for_backward(idx)
        return out.reshape(b, c, oh, ow)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, c, ho, wo = idx.shape
        grad = g.reshape(b, c, -1).gather(2, idx.reshape(b, c, ho * wo))
        return grad.reshape(b, c, ho, wo), None, None


def max_unpool_flat(y: torch.Tensor, idx: torch.Tensor, output_hw) -> torch.Tensor:
    """``y`` (B, C, ho, wo) placed at its flat ``idx`` positions (from
    :func:`max_pool_argmax_flat`) in a zero (B, C, oh, ow) canvas, read as
    one row-major plane of ``oh*ow``; where indices repeat, the highest
    row-major pooled pixel's value wins, on every device (SegResNet's
    epilogue). Its backward gathers the cotangent at every index."""
    return _MaxUnpoolFlat.apply(y, idx, (int(output_hw[0]), int(output_hw[1])))

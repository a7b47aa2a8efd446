"""The arithmetic of the reference's convolutions.

:data:`FP32` is the reference itself: ``F.conv2d`` in float32 (the caller
turns TF32 off, :func:`strict_fp32`). :data:`FP8` is the benchmark's
control, the reference one precision below the configurations' bfloat16:
each convolution's input and weight rounded to float8 e4m3 and its output
gradient to float8 e5m2, each tensor scaled by its largest magnitude first
(per-tensor scaling, as fp8 training does), the products summed in float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def strict_fp32():
    """float32 matrix products and convolutions without TF32, restored
    after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def round_fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` after scaling its largest magnitude to
    ``top``, returned in ``t``'s dtype and scale."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xq = round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = round_fp8(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        ctx.conv = (stride, padding, dilation)
        ctx.has_bias = b is not None
        return F.conv2d(xq, wq, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation = ctx.conv
        dyq = round_fp8(dy, torch.float8_e5m2, E5M2_MAX)
        dx, dw, db = torch.ops.aten.convolution_backward(
            dyq, xq, wq, [wq.shape[0]] if ctx.has_bias else None,
            stride, padding, dilation, False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], ctx.has_bias])
        return dx, dw, db, None, None, None


class Precision:
    """How the reference computes a convolution."""

    def __init__(self, name: str):
        self.name = name

    def conv2d(self, x, w, b: Optional[torch.Tensor], stride, padding, dilation):
        if self.name == "fp8":
            return _Fp8Conv.apply(x, w, b, (stride, stride), (padding, padding),
                                  (dilation, dilation))
        return F.conv2d(x, w, b, stride, padding, dilation)


FP32 = Precision("fp32")
FP8 = Precision("fp8")
PRECISIONS = {"fp32": FP32, "fp8": FP8}

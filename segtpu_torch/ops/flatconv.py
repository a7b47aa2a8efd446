"""Backward of a stride-1 conv on flat rows: CUDA kernels, plain versions and
the autograd Function that uses them.

Counterpart of ``segtpu/ops/flatconv.py``. The conv is stride 1, dilation
d, kh x kw, pad p, with ``(k - 1) * d == 2 * p`` so that x and dy have the
same spatial size. The public functions keep segtpu's layouts and result
types:

* :func:`flat_conv_wgrad` ``(x NHWC, dy NHWC) -> dW (kh, kw, C, O)`` fp32;
* :func:`flat_conv_dgrad` ``(dy NHWC, w HWIO) -> dx (N, H, W, C)`` bf16;

with x, dy and w rounded to bf16 and the products summed in fp32. On CUDA
tensors they launch the hand-written kernels of
``segtpu_torch/csrc/flat_conv.cu`` (or raise); on CPU tensors they run
:func:`flat_conv_wgrad_plain` and :func:`flat_conv_dgrad_plain`, the same
arithmetic in plain PyTorch.

:class:`FlatConv` ports segtpu's ``flat_conv`` custom VJP on NCHW ``x`` and
OIHW ``weight``: the forward is the library conv, the backward is the two
kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

_LIB_NAME = "flat_conv"
# The wgrad partial buffer holds splits * kh*kw*C*O floats; it stays under
# this many (64 MiB), and a dW larger than that is refused.
MAX_PARTIAL_FLOATS = 1 << 24
_INT_MAX = 2**31 - 1


def _geometry(kernel_hw, padding: int, dilation: int) -> Tuple[int, int]:
    kh, kw = (kernel_hw, kernel_hw) if isinstance(kernel_hw, int) else tuple(kernel_hw)
    if padding < 0 or dilation < 1 or kh < 1 or kw < 1:
        raise ValueError(f"flat_conv: kernel {kernel_hw}, padding {padding}, "
                         f"dilation {dilation}")
    for k in (kh, kw):
        if (k - 1) * dilation != 2 * padding:
            raise ValueError(
                f"flat_conv takes a same-size stride-1 conv, (k-1)*d == 2p; "
                f"got k={k}, d={dilation}, p={padding}")
    return kh, kw


def _check(name, act, other):
    """Shared checks of both wrappers: 4-D floating tensors, and rows the
    kernels can index."""
    if act.dim() != 4 or other.dim() != 4:
        raise ValueError(f"{name} takes 4-D tensors, got {tuple(act.shape)} "
                         f"and {tuple(other.shape)}")
    for t in (act, other):
        if not t.is_floating_point():
            raise TypeError(f"{name} takes floating tensors, got {t.dtype}")
    rows = act.shape[0] * act.shape[1] * act.shape[2]
    if rows + 64 > _INT_MAX:
        raise ValueError(f"{name}: {rows} rows are past the kernel's int row index")


def _check_wgrad(x, dy, kernel_hw, padding, dilation):
    kh, kw = _geometry(kernel_hw, padding, dilation)
    if x.dim() == 4 and dy.dim() == 4 and tuple(x.shape[:3]) != tuple(dy.shape[:3]):
        raise ValueError(f"flat_conv_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} differ in N, H or W")
    _check("flat_conv_wgrad", x, dy)
    c, o = x.shape[-1], dy.shape[-1]
    if kh * kw * c * o > MAX_PARTIAL_FLOATS:
        raise ValueError(f"flat_conv_wgrad: dW of {kh}x{kw}x{c}x{o} is past the "
                         f"kernel's {MAX_PARTIAL_FLOATS} floats")
    return kh, kw


def _check_dgrad(dy, w_hwio, kernel_hw, padding, dilation):
    kh, kw = _geometry(kernel_hw, padding, dilation)
    if w_hwio.dim() == 4 and dy.dim() == 4 and (
            tuple(w_hwio.shape[:2]) != (kh, kw) or w_hwio.shape[3] != dy.shape[3]):
        raise ValueError(f"flat_conv_dgrad: w {tuple(w_hwio.shape)} is not "
                         f"({kh}, {kw}, C, {dy.shape[3]})")
    _check("flat_conv_dgrad", dy, w_hwio)
    return kh, kw


def _shifted(t, a, b, d, h, w):
    """Rows a*d .. a*d+h-1, columns b*d .. b*d+w-1 of padded NHWC ``t``."""
    return t[:, a * d:a * d + h, b * d:b * d + w]


def flat_conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kernel_hw=(3, 3),
                          padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version: bf16-rounded x and dy, fp32 sums, one einsum
    per tap over the shifted slice of the zero-padded x."""
    kh, kw = _check_wgrad(x, dy, kernel_hw, padding, dilation)
    p, d = padding, dilation
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, p, p, p, p))
    dyf = dy.to(torch.bfloat16).float()
    return torch.stack([
        torch.stack([torch.einsum("nhwc,nhwo->co", _shifted(xp, a, b, d, h, w), dyf)
                     for b in range(kw)])
        for a in range(kh)])


def flat_conv_dgrad_plain(dy: torch.Tensor, w_hwio: torch.Tensor, kernel_hw=(3, 3),
                          padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version: bf16-rounded dy and w, fp32 sums, one einsum
    per tap over the shifted slice of the zero-padded dy (the tap flipped),
    the result rounded to bf16."""
    kh, kw = _check_dgrad(dy, w_hwio, kernel_hw, padding, dilation)
    p, d = padding, dilation
    h, w = dy.shape[1], dy.shape[2]
    dyp = F.pad(dy.to(torch.bfloat16).float(), (0, 0, p, p, p, p))
    wf = w_hwio.to(torch.bfloat16).float()
    dx = None
    for a in range(kh):
        for b in range(kw):
            term = torch.einsum("nhwo,co->nhwc", _shifted(dyp, a, b, d, h, w),
                                wf[kh - 1 - a, kw - 1 - b])
            dx = term if dx is None else dx + term
    return dx.to(torch.bfloat16)


@functools.cache
def _lib():
    from segtpu_torch.ops import build

    lib = build.load(_LIB_NAME)
    lib.flat_conv_tile.restype = ctypes.c_int
    lib.flat_conv_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                                    + [ctypes.c_void_p])
    lib.flat_conv_wgrad.restype = ctypes.c_int
    lib.flat_conv_dgrad.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                                    + [ctypes.c_void_p])
    lib.flat_conv_dgrad.restype = ctypes.c_int
    return lib


# blocks of the wgrad kernel resident on one SM (128 threads of 128
# registers each; 4 x 16K of the SM's 64K registers)
_WGRAD_BLOCKS_PER_SM = 4


def wgrad_plan(rows: int, taps: int, c: int, o: int, tile: int, sms: int):
    """(splits, rows per split) of a wgrad launch: as many blocks as fit on
    the card at once, and no more, so that no second wave of a few blocks
    doubles the time; the partial buffer under :data:`MAX_PARTIAL_FLOATS`."""
    tiles = taps * math.ceil(c / tile) * math.ceil(o / tile)
    splits = max(1, min(_WGRAD_BLOCKS_PER_SM * sms // tiles,
                        MAX_PARTIAL_FLOATS // (taps * c * o), rows))
    rows_per_split = math.ceil(rows / splits)
    return math.ceil(rows / rows_per_split), rows_per_split


def _dense_bf16(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``t`` as a bf16, contiguous, 16-byte-aligned tensor, and whether that
    took a copy beyond the cast."""
    t = t.to(torch.bfloat16)
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t, False
    return t.clone(memory_format=torch.contiguous_format), True


def _on_one_cuda_device(name, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}; "
                         f"all must be on one CUDA device (or all on the CPU)")
    return dev


def flat_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel_hw=(3, 3),
                    padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """dL/dW (HWIO ``(kh, kw, C, O)``, fp32) of the stride-1 conv, from NHWC
    ``x`` and ``dy``.

    CPU tensors go to :func:`flat_conv_wgrad_plain`. CUDA tensors launch the
    kernel, which reads bf16 NHWC-contiguous inputs: other dtypes are rounded
    to bf16 and non-contiguous inputs copied first (counted in
    ``flat_conv_wgrad.copies``). Each launch adds one to
    ``flat_conv_wgrad.launches``.
    """
    kh, kw = _check_wgrad(x, dy, kernel_hw, padding, dilation)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return flat_conv_wgrad_plain(x, dy, (kh, kw), padding, dilation)
    dev = _on_one_cuda_device("flat_conv_wgrad", x, dy)
    n, h, w, c = x.shape
    o = dy.shape[3]
    with torch.cuda.device(dev):
        lib = _lib()
        (xb, cx), (dyb, cdy) = _dense_bf16(x), _dense_bf16(dy)
        flat_conv_wgrad.copies += cx + cdy
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, rows_per_split = wgrad_plan(n * h * w, kh * kw, c, o,
                                            lib.flat_conv_tile(), sms)
        out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=dev)
        partial = out
        if splits > 1:
            partial = torch.empty((splits, kh, kw, c, o), dtype=torch.float32,
                                  device=dev)
        err = lib.flat_conv_wgrad(
            xb.data_ptr(), dyb.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, c, o, kh, kw, padding, dilation, splits, rows_per_split,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flat_conv_wgrad kernel launch failed: CUDA error {err}")
        flat_conv_wgrad.launches += 1
    return out


flat_conv_wgrad.launches = 0
flat_conv_wgrad.copies = 0


def flat_conv_dgrad(dy: torch.Tensor, w_hwio: torch.Tensor, kernel_hw=(3, 3),
                    padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """dL/dx (NHWC ``(N, H, W, C)``, bf16) of the stride-1 conv, from NHWC
    ``dy`` and the HWIO weight.

    CPU tensors go to :func:`flat_conv_dgrad_plain`. CUDA tensors launch the
    kernel, as :func:`flat_conv_wgrad` does (``flat_conv_dgrad.launches``;
    ``flat_conv_dgrad.copies`` counts copies of dy, not of the small weight).
    """
    kh, kw = _check_dgrad(dy, w_hwio, kernel_hw, padding, dilation)
    if dy.device.type == "cpu" and w_hwio.device.type == "cpu":
        return flat_conv_dgrad_plain(dy, w_hwio, (kh, kw), padding, dilation)
    dev = _on_one_cuda_device("flat_conv_dgrad", dy, w_hwio)
    n, h, w, o = dy.shape
    c = w_hwio.shape[2]
    with torch.cuda.device(dev):
        lib = _lib()
        dyb, copied = _dense_bf16(dy)
        flat_conv_dgrad.copies += copied
        wb, _ = _dense_bf16(w_hwio)  # the weight is small: rearranged freely
        dx = torch.empty((n, h, w, c), dtype=torch.bfloat16, device=dev)
        err = lib.flat_conv_dgrad(
            dyb.data_ptr(), wb.data_ptr(), dx.data_ptr(), n, h, w, c, o, kh, kw,
            padding, dilation, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flat_conv_dgrad kernel launch failed: CUDA error {err}")
        flat_conv_dgrad.launches += 1
    return dx


flat_conv_dgrad.launches = 0
flat_conv_dgrad.copies = 0


class FlatConv(torch.autograd.Function):
    """Stride-1 conv on NCHW ``x`` and OIHW ``weight``, bias-free, whose
    backward is :func:`flat_conv_wgrad` and :func:`flat_conv_dgrad`."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, kernel_hw, padding: int, dilation: int):
        ctx.save_for_backward(x, weight)
        ctx.geom = (kernel_hw, padding, dilation)
        return F.conv2d(x, weight.to(x.dtype), padding=padding, dilation=dilation)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        kernel_hw, p, d = ctx.geom
        g = dy.permute(0, 2, 3, 1)  # NHWC; a view when dy is channels_last
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = flat_conv_dgrad(g, weight.permute(2, 3, 1, 0), kernel_hw, p, d)
            dx = dx.permute(0, 3, 1, 2).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = flat_conv_wgrad(x.permute(0, 2, 3, 1), g, kernel_hw, p, d)
            dw = dw.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw, None, None, None


def flat_conv(x: torch.Tensor, weight: torch.Tensor, kernel_hw=(3, 3),
              padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, padding=padding, dilation=dilation)`` whose
    backward runs the flat-row kernels. ``x`` NCHW, ``weight`` OIHW; groups
    are not supported."""
    kh, kw = _geometry(kernel_hw, padding, dilation)
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"flat_conv takes NCHW x and OIHW weight, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if tuple(weight.shape[2:]) != (kh, kw):
        raise ValueError(f"flat_conv: weight {tuple(weight.shape)} is not "
                         f"{kh}x{kw}")
    if weight.shape[1] != x.shape[1]:
        raise ValueError(f"flat_conv: weight takes {weight.shape[1]} channels, x "
                         f"has {x.shape[1]} (groups are not supported)")
    return FlatConv.apply(x, weight, (kh, kw), padding, dilation)

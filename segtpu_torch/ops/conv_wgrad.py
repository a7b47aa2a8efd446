"""Weight gradient of the stride-2 stem conv: CUDA kernel, plain version and
the autograd Function that uses them.

Counterpart of ``segtpu/ops/conv_wgrad.py``. :func:`stem_conv_wgrad` keeps
segtpu's layout: ``(x NHWC, dy NHWC, kernel) -> dW (k, k, C, CO)`` fp32, with
x and dy rounded to bf16 and the products summed in fp32. On a CUDA tensor
it launches the hand-written kernel in ``segtpu_torch/csrc/
stem_conv_wgrad.cu`` (or raises); on a CPU tensor it runs
:func:`stem_conv_wgrad_plain`, the same arithmetic in plain PyTorch.

:class:`StemConv` ports ``pallas_stem_conv``: the forward is the library
conv, the backward's weight gradient is :func:`stem_conv_wgrad`, and the
input gradient is zero, which is right only where the conv reads the model
input.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

_LIB_NAME = "stem_conv_wgrad"
# The kernel's constants (segtpu_torch/csrc/stem_conv_wgrad.cu), mirrored
# for the launch plan.
THREADS = 256
TILE_W = 32             # output pixels a block stages at a time
MAX_TAPS_PER_THREAD = 16
MAX_CO_TILE = 256       # widest o tile (its dy tile is 32 KB)
SMEM_LIMIT = 48 * 1024  # bytes of shared memory a launch takes without opt-in
# The partial buffer holds row_blocks * k*k*C*CO floats; the plan keeps it
# under this many (64 MiB), down to one row block that writes dW directly.
MAX_PARTIAL_FLOATS = 1 << 24


def _out_size(size: int, k: int) -> int:
    return (size + 2 * (k // 2) - k) // 2 + 1


def _check_shapes(x, dy, k):
    if k % 2 != 1:
        raise ValueError(f"stem_conv_wgrad takes an odd kernel size, got {k}")
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"stem_conv_wgrad takes NHWC x and dy, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    n, h, w, _ = x.shape
    want = (n, _out_size(h, k), _out_size(w, k))
    if tuple(dy.shape[:3]) != want:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}: want {want + (dy.shape[3],)}")
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_floating_point():
            raise TypeError(f"stem_conv_wgrad: {name} must be floating, got {t.dtype}")


def stem_conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kernel: int = 7) -> torch.Tensor:
    """Plain PyTorch version: bf16-rounded x and dy, fp32 sums, one einsum
    per tap over the stride-2 slice of the padded input."""
    _check_shapes(x, dy, kernel)
    k, p = kernel, kernel // 2
    xf = x.to(torch.bfloat16).float()
    dyf = dy.to(torch.bfloat16).float()
    xp = F.pad(xf, (0, 0, p, p, p, p))
    ho, wo = dy.shape[1], dy.shape[2]
    taps = []
    for kh in range(k):
        row = []
        for kw in range(k):
            xs = xp[:, kh:kh + 2 * (ho - 1) + 1:2, kw:kw + 2 * (wo - 1) + 1:2]
            row.append(torch.einsum("nhwc,nhwo->co", xs, dyf))
        taps.append(torch.stack(row))
    return torch.stack(taps)


class StemPlan(NamedTuple):
    """Launch of the stem kernel on a grid of (row_blocks, tap_groups,
    o_tiles). An o tile is ``co_tile`` output channels; a tap group is a box
    of ``kr`` rows kh, ``kc`` columns kw and ``cs`` channels c, of which each
    thread owns ``nt`` taps; a row block walks ``rows_per_block`` output
    rows (n, ho). With one row block the kernel writes dW directly."""
    co_tile: int
    kr: int
    kc: int
    cs: int
    nt: int
    tap_groups: int
    o_tiles: int
    rows_per_block: int
    row_blocks: int


def smem_bytes(co_tile: int, kr: int, kc: int, cs: int) -> int:
    """Shared memory of one block (``stem_conv_wgrad_smem_bytes``): the dy
    tile and the x slice of a tap group, as fp32."""
    return 4 * (TILE_W * co_tile + kr * (2 * TILE_W + kc - 2) * cs)


def stem_wgrad_plan(n: int, ho: int, c: int, co: int, k: int, sms: int) -> StemPlan:
    """The stem kernel's launch for x with C channels and dy (N, Ho, Wo, CO).

    The o tile is CO padded to a power of two (its quarter divides the
    block's threads), at most :data:`MAX_CO_TILE`, further o tiles on a grid
    axis. The tap boxes are the fewest that keep each thread at most
    :data:`MAX_TAPS_PER_THREAD` taps and the block within
    :data:`SMEM_LIMIT`; their sizes are balanced. About four blocks an SM,
    with the partial buffer under :data:`MAX_PARTIAL_FLOATS`.
    """
    co_tile = min(MAX_CO_TILE, max(4, 1 << (co - 1).bit_length()))
    o_tiles = -(-co // co_tile)
    cap = THREADS // (co_tile // 4) * MAX_TAPS_PER_THREAD  # taps a block holds
    best = None
    for kr in range(k, 0, -1):
        for kc in range(k, 0, -1):
            room = SMEM_LIMIT - smem_bytes(co_tile, 0, kc, 0)
            cs = min(c, cap // (kr * kc), room // smem_bytes(0, kr, kc, 1))
            if cs < 1:
                continue
            counts = (-(-k // kr), -(-k // kc), -(-c // cs))
            if best is None or math.prod(counts) < math.prod(best):
                best = counts
    gh, gw, gc = best
    kr, kc, cs = -(-k // gh), -(-k // gw), -(-c // gc)  # balanced boxes
    nt = -(-(kr * kc * cs) // (THREADS // (co_tile // 4)))
    tap_groups = gh * gw * gc
    rows = n * ho
    row_blocks = max(1, min(-(-4 * sms // (tap_groups * o_tiles)),
                            MAX_PARTIAL_FLOATS // (k * k * c * co), rows))
    rows_per_block = -(-rows // row_blocks)
    return StemPlan(co_tile, kr, kc, cs, nt, tap_groups, o_tiles, rows_per_block,
                    -(-rows // rows_per_block))


@functools.cache
def _lib():
    from segtpu_torch.ops import build

    lib = build.load(_LIB_NAME)
    lib.stem_conv_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                                    + [ctypes.c_void_p])
    lib.stem_conv_wgrad.restype = ctypes.c_int
    lib.stem_conv_wgrad_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.stem_conv_wgrad_smem_bytes.restype = ctypes.c_int
    return lib


def stem_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel: int = 7) -> torch.Tensor:
    """dL/dW (HWIO ``(k, k, C, CO)``, fp32) of conv k x k / stride 2 /
    pad k//2, from NHWC ``x`` and ``dy``.

    CPU tensors go to :func:`stem_conv_wgrad_plain`. CUDA tensors launch the
    CUDA kernel, which reads bf16 NHWC-contiguous inputs: other dtypes are
    rounded to bf16 and non-contiguous inputs copied first (each copy is
    counted in ``stem_conv_wgrad.copies``). Each launch adds one to
    ``stem_conv_wgrad.launches``.
    """
    _check_shapes(x, dy, kernel)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return stem_conv_wgrad_plain(x, dy, kernel)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"stem_conv_wgrad: x on {x.device} and dy on "
                         f"{dy.device}; both must be on one CUDA device")
    k = kernel
    n, h, w, c = x.shape
    _, ho, wo, co = dy.shape
    with torch.cuda.device(x.device):
        lib = _lib()
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = stem_wgrad_plan(n, ho, c, co, k, sms)
        xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        if not xb.is_contiguous() or not dyb.is_contiguous():
            stem_conv_wgrad.copies += 1
            xb, dyb = xb.contiguous(), dyb.contiguous()
        out = torch.empty((k, k, c, co), dtype=torch.float32, device=x.device)
        partial = out
        if plan.row_blocks > 1:
            partial = torch.empty((plan.row_blocks, k * k * c, co),
                                  dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stem_conv_wgrad(
            xb.data_ptr(), dyb.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, c, ho, wo, co, k, plan.co_tile, plan.kr, plan.kc, plan.cs,
            plan.nt, plan.rows_per_block, plan.row_blocks, stream)
        if err != 0:
            raise RuntimeError(f"stem_conv_wgrad kernel launch failed: CUDA error {err}")
        stem_conv_wgrad.launches += 1
    return out


stem_conv_wgrad.launches = 0
stem_conv_wgrad.copies = 0


class StemConv(torch.autograd.Function):
    """Conv k x k / stride 2 / pad k//2, bias-free, NCHW, whose weight
    gradient is :func:`stem_conv_wgrad`."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, k: int):
        ctx.save_for_backward(x)
        ctx.k = k
        ctx.weight_dtype = weight.dtype
        return F.conv2d(x, weight.to(x.dtype), stride=2, padding=k // 2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dw = stem_conv_wgrad(x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1),
                             kernel=ctx.k)
        dw = dw.permute(3, 2, 0, 1).to(ctx.weight_dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            # The stem conv's input is the MODEL INPUT (data): its gradient
            # is never used, so a zero dx is free. Do NOT use StemConv
            # mid-network where a real dx is needed.
            dx = torch.zeros_like(x)
        return dx, dw, None


class StemConv2d(nn.Module):
    """The stem's first conv with :class:`StemConv`'s backward. Same
    ``weight`` (O, I, k, k) as the ``nn.Conv2d`` it replaces, so state
    dicts are unaffected."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, weight_init):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.weight_init = weight_init
        weight_init(self.weight.data, None)

    def forward(self, x):
        return StemConv.apply(x, self.weight, self.kernel_size)

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
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

_LIB_NAME = "flat_conv"
# The wgrad partial buffer holds splits * kh*kw*C*O floats; the plan keeps
# it under this many (64 MiB). A dW too large for two splits is written by
# one split directly, with no partial buffer.
MAX_PARTIAL_FLOATS = 1 << 24
WGRAD_CHUNK = 64  # dy rows the wgrad kernel stages at a time
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
    lib.flat_conv_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                                    + [ctypes.c_void_p])
    lib.flat_conv_wgrad.restype = ctypes.c_int
    lib.flat_conv_wgrad_occupancy.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.flat_conv_wgrad_occupancy.restype = ctypes.c_int
    lib.flat_conv_dgrad.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                                    + [ctypes.c_void_p])
    lib.flat_conv_dgrad.restype = ctypes.c_int
    lib.flat_conv_dgrad_occupancy.argtypes = [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.flat_conv_dgrad_occupancy.restype = ctypes.c_int
    return lib


WGRAD_TILE_C = 64  # c tile of the wgrad kernel: the M of one warpgroup product


class WgradPlan(NamedTuple):
    """Launch of the wgrad kernel: a block owns ``taps`` taps of one tap row
    and a :data:`WGRAD_TILE_C` x ``tile_o`` tile of their dW; ``splits``
    blocks share each tile, split s taking the chunks of :data:`WGRAD_CHUNK`
    rows s, s + splits, s + 2 splits, ..."""
    tile_o: int
    taps: int
    splits: int


def wgrad_tiling(kw: int, o: int, dilation: int) -> Tuple[int, int]:
    """(tile_o, taps) of the wgrad kernel: a narrow o tile of 24 or 32 for
    O <= 32, else 64; up to three taps of a tap row a block, one when their x
    window would pass 64 + 128 rows."""
    taps = min(kw, 3)
    if (taps - 1) * dilation > 128:
        taps = 1
    return (24 if o <= 24 else 32 if o <= 32 else 64), taps


def wgrad_plan(rows: int, kh: int, kw: int, c: int, o: int, dilation: int, sms: int,
               blocks_per_sm: int, tile_o=None) -> WgradPlan:
    """The wgrad launch: as many blocks as fit on the card at once
    (``blocks_per_sm``, the kernel's own occupancy) and no more, so that no
    second wave of a few blocks doubles the time; no more splits than
    chunks; the partial buffer under :data:`MAX_PARTIAL_FLOATS`, or none
    (one split). ``tile_o`` overrides the tiling's o tile."""
    natural, taps = wgrad_tiling(kw, o, dilation)
    tile_o = tile_o or natural
    tiles = (kh * math.ceil(kw / taps) * math.ceil(c / WGRAD_TILE_C)
             * math.ceil(o / tile_o))
    splits = max(1, min(blocks_per_sm * sms // tiles,
                        MAX_PARTIAL_FLOATS // (kh * kw * c * o),
                        math.ceil(rows / WGRAD_CHUNK), 65535))
    return WgradPlan(tile_o, taps, splits)


def wgrad_occupancy(lib, o: int, dilation: int, tile_o: int, taps: int) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of the wgrad
    kernel of ``lib`` launched with this o tile and taps, as the CUDA runtime
    reports it on the current card."""
    smem = ctypes.c_int(0)
    blocks = lib.flat_conv_wgrad_occupancy(o, dilation, tile_o, taps, ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError(f"flat_conv_wgrad: no block fits on an SM (CUDA error "
                           f"{-blocks}, {smem.value} bytes of shared memory)")
    return blocks, smem.value


def wgrad_launch_plan(x_shape, o: int, kernel_hw, dilation: int,
                      device) -> Tuple[WgradPlan, int, int]:
    """(plan, blocks per SM, shared memory bytes per block) of the wgrad
    launch :func:`flat_conv_wgrad` makes for NHWC ``x_shape`` and O channels
    on the CUDA ``device``."""
    n, h, w, c = x_shape
    kh, kw = kernel_hw
    tile_o, taps = wgrad_tiling(kw, o, dilation)
    with torch.cuda.device(device):
        blocks, smem = wgrad_occupancy(_lib(), o, dilation, tile_o, taps)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return wgrad_plan(n * h * w, kh, kw, c, o, dilation, sms, blocks), blocks, smem


# The dgrad kernel's constants (segtpu_torch/csrc/flat_conv.cu), mirrored
# for its launch plan.
DGRAD_ROWS = 128          # dx rows of a block tile (two warpgroups of 64)
DGRAD_STAGES = 3          # depth of the cp.async ring
DGRAD_MAX_SHIFT = 128     # extra window rows a stage's taps may span
DGRAD_EPILOGUE_BYTES = 8 * 16 * 72 * 2
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory a Hopper block takes


class DgradPlan(NamedTuple):
    """Launch of the dgrad kernel: ``blocks`` blocks walk the tiles of
    :data:`DGRAD_ROWS` dx rows x ``tile_c`` channels, t = block, block +
    blocks, ... (c tile fastest); K runs over the taps and o chunks of
    ``ko``, a stage holding ``taps`` taps of one tap row and their one dy
    window; ``resident`` keeps the whole weight in shared memory."""
    tile_c: int
    ko: int
    taps: int
    resident: bool
    blocks: int


def dgrad_smem_bytes(tile_c: int, ko: int, taps: int, dilation: int, o: int,
                     kh: int, kw: int, resident: bool) -> int:
    """Dynamic shared memory of one dgrad block (``dgrad_smem`` in the
    kernel): the weight tiles, the ring of dy windows (and of raw dy spans
    where O is not a multiple of 8 and fits one chunk), the epilogue tiles,
    and 1024 bytes of alignment slack."""
    wtiles = kh * kw * -(-o // ko) if resident else DGRAD_STAGES * taps
    win = DGRAD_ROWS + (taps - 1) * dilation
    span = -(-(win * o * 2) // 16) * 16 + 16 if o % 8 and o <= ko else 0
    return (wtiles * tile_c * ko * 2 + DGRAD_STAGES * (win * (ko + 8) * 2 + span)
            + DGRAD_EPILOGUE_BYTES + 1024)


DGRAD_TILES = ((64, 32), (64, 64), (128, 32), (128, 64), (256, 32))  # (tile_c, ko) built


def dgrad_tiling(c: int, o: int, kh: int, kw: int, dilation: int, tile_c=None, ko=None):
    """(tile_c, ko, taps, resident) of the dgrad kernel. The c tile covers C
    up to 256 (64, 128 or 256 wide), so dy is read once per c tile; the o
    chunk is 32 for O <= 32 and at the 256-wide tile, else 64. A stage holds
    as many taps of a tap row as fit (all kw where the window and the ring
    allow), in balanced groups. The weight stays resident where there is one
    c tile and all of it fits beside the ring. ``tile_c`` and ``ko``
    override the choice (one of :data:`DGRAD_TILES`)."""
    tile_c = tile_c or (64 if c <= 64 else 128 if c <= 128 else 256)
    ko = ko or (32 if o <= 32 or tile_c == 256 else 64)
    if (tile_c, ko) not in DGRAD_TILES:
        raise ValueError(f"flat_conv_dgrad: no kernel for c tile {tile_c}, o chunk {ko}")
    for resident in ((True, False) if c <= tile_c else (False,)):
        taps = kw
        while taps > 1 and ((taps - 1) * dilation > DGRAD_MAX_SHIFT or dgrad_smem_bytes(
                tile_c, ko, taps, dilation, o, kh, kw, resident) > SMEM_PER_BLOCK):
            taps -= 1
        if dgrad_smem_bytes(tile_c, ko, taps, dilation, o, kh, kw,
                            resident) <= SMEM_PER_BLOCK:
            return tile_c, ko, -(-kw // -(-kw // taps)), resident
    raise ValueError(f"flat_conv_dgrad: no launch fits C={c}, O={o}, {kh}x{kw}, "
                     f"dilation {dilation}")


def dgrad_plan(rows: int, c: int, o: int, kh: int, kw: int, dilation: int, sms: int,
               blocks_per_sm: int, tile_c=None, ko=None) -> DgradPlan:
    """The dgrad launch: as many blocks as fit on the card at once
    (``blocks_per_sm``, the kernel's own occupancy), each walking its share
    of the tiles, and no more blocks than tiles. The block count is a
    multiple of the c tiles, so each block keeps one c tile. ``tile_c`` and
    ``ko`` override the tiling's."""
    tile_c, ko, taps, resident = dgrad_tiling(c, o, kh, kw, dilation, tile_c, ko)
    ctiles = -(-c // tile_c)
    tiles = -(-rows // DGRAD_ROWS) * ctiles
    blocks = min(tiles, max(ctiles, blocks_per_sm * sms // ctiles * ctiles))
    return DgradPlan(tile_c, ko, taps, resident, blocks)


def dgrad_occupancy(lib, o: int, kh: int, kw: int, dilation: int, tile_c: int, ko: int,
                    taps: int, resident: bool) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes per block) of the dgrad
    kernel of ``lib`` for this tiling, as the CUDA runtime reports it on the
    current card."""
    smem = ctypes.c_int(0)
    blocks = lib.flat_conv_dgrad_occupancy(o, kh, kw, dilation, tile_c, ko, taps,
                                           int(resident), ctypes.byref(smem))
    if blocks <= 0:
        raise RuntimeError(f"flat_conv_dgrad: no block fits on an SM (CUDA error "
                           f"{-blocks}, {smem.value} bytes of shared memory)")
    return blocks, smem.value


def dgrad_launch_plan(dy_shape, c: int, kernel_hw, dilation: int,
                      device) -> Tuple[DgradPlan, int, int]:
    """(plan, blocks per SM, shared memory bytes per block) of the dgrad
    launch :func:`flat_conv_dgrad` makes for NHWC ``dy_shape`` and C input
    channels on the CUDA ``device``."""
    n, h, w, o = dy_shape
    kh, kw = kernel_hw
    tile_c, ko, taps, resident = dgrad_tiling(c, o, kh, kw, dilation)
    with torch.cuda.device(device):
        blocks, smem = dgrad_occupancy(_lib(), o, kh, kw, dilation, tile_c, ko, taps,
                                       resident)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dgrad_plan(n * h * w, c, o, kh, kw, dilation, sms, blocks), blocks, smem


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
        plan, _, _ = wgrad_launch_plan(x.shape, o, (kh, kw), dilation, dev)
        out = torch.empty((kh, kw, c, o), dtype=torch.float32, device=dev)
        partial = out
        if plan.splits > 1:
            partial = torch.empty((plan.splits, kh, kw, c, o), dtype=torch.float32,
                                  device=dev)
        err = lib.flat_conv_wgrad(
            xb.data_ptr(), dyb.data_ptr(), partial.data_ptr(), out.data_ptr(),
            n, h, w, c, o, kh, kw, padding, dilation, plan.tile_o, plan.taps,
            plan.splits, torch.cuda.current_stream(dev).cuda_stream)
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
        # the weight is small and rearranged freely: O is padded with zeros to
        # a multiple of 8, so that its rows take 16-byte copies
        ow = -(-o // 8) * 8
        wb, _ = _dense_bf16(F.pad(w_hwio, (0, ow - o)) if ow != o else w_hwio)
        plan, _, _ = dgrad_launch_plan(dy.shape, c, (kh, kw), dilation, dev)
        dx = torch.empty((n, h, w, c), dtype=torch.bfloat16, device=dev)
        err = lib.flat_conv_dgrad(
            dyb.data_ptr(), wb.data_ptr(), dx.data_ptr(), n, h, w, c, o, ow, kh, kw,
            padding, dilation, plan.tile_c, plan.ko, plan.taps, int(plan.resident),
            plan.blocks, torch.cuda.current_stream(dev).cuda_stream)
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

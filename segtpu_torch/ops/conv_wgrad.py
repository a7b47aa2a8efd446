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

Each takes the H padding as ``pad_h = (top, bottom)``, ``(k//2, k//2)`` for
a whole image: a band of an image sharded over H (``core/spatial.py``)
carries its halo rows in x and pads only at the image's own top and
bottom, so the bands' dW sum to the whole image's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_LIB_NAME = "stem_conv_wgrad"
# The kernel's constants (segtpu_torch/csrc/stem_conv_wgrad.cu), mirrored
# for the launch plan.
TILE_P = 64             # output pixels of a tile (one output row's, at most)
TILE_O = 64             # output channels of a tile
WARPS = 4               # warps of a block; each owns nt n8 tiles of taps
MAX_NT = 6              # n8 tiles a warp owns at most: 192 taps a block
MAX_STAGES = 8          # deepest ring
MIN_STAGES = 4          # shallowest ring a launch takes by choice
MAX_BLOCKS_PER_SM = 4
DY_TILE_BYTES = TILE_P * TILE_O * 2
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block can opt into on an H100
SMEM_PER_SM = 228 * 1024  # shared memory of an H100 SM, 1 KB of it reserved per block
SMEM_TARGET = 110 * 1024  # a block's share when two fit on an SM: what sizes the box
# The partial buffer holds row_blocks * k*k*C*CO floats; the plan keeps it
# under this many (64 MiB), down to one row block that writes dW directly.
MAX_PARTIAL_FLOATS = 1 << 24


def _out_size(size: int, k: int, pad=None) -> int:
    top, bottom = (k // 2, k // 2) if pad is None else pad
    return (size + top + bottom - k) // 2 + 1


def _pad_h(k: int, pad_h):
    top, bottom = (k // 2, k // 2) if pad_h is None else (int(pad_h[0]), int(pad_h[1]))
    if not (0 <= top <= k and 0 <= bottom <= k):
        raise ValueError(f"stem_conv_wgrad: H padding {(top, bottom)} outside [0, {k}]")
    return top, bottom


def _check_shapes(x, dy, k, pad_h=None):
    if k % 2 != 1:
        raise ValueError(f"stem_conv_wgrad takes an odd kernel size, got {k}")
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError(f"stem_conv_wgrad takes NHWC x and dy, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    n, h, w, _ = x.shape
    want = (n, _out_size(h, k, _pad_h(k, pad_h)), _out_size(w, k))
    if tuple(dy.shape[:3]) != want:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}: want {want + (dy.shape[3],)}")
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_floating_point():
            raise TypeError(f"stem_conv_wgrad: {name} must be floating, got {t.dtype}")


def stem_conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, kernel: int = 7,
                          pad_h=None) -> torch.Tensor:
    """Plain PyTorch version: bf16-rounded x and dy, fp32 sums, one einsum
    per tap over the stride-2 slice of the padded input (``pad_h`` zero
    rows above and below, ``k//2`` each by default)."""
    _check_shapes(x, dy, kernel, pad_h)
    k, p = kernel, kernel // 2
    top, bottom = _pad_h(k, pad_h)
    xf = x.to(torch.bfloat16).float()
    dyf = dy.to(torch.bfloat16).float()
    xp = F.pad(xf, (0, 0, p, p, top, bottom))
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
    o_tiles). A tap group is a box of ``kr`` rows kh, ``kc`` columns kw and
    ``cs`` channels c, padded to 32 * ``nt`` taps (each of the block's
    :data:`WARPS` warps owns ``nt`` n8 tiles of them); an o tile is
    :data:`TILE_O` output channels. A row block walks a contiguous range of
    the N * Ho * ceil(Wo / :data:`TILE_P`) pixel tiles through a ring of
    ``stages`` slots; ``span`` stages whole-C spans of the input rows (else
    the box's channels are gathered). With one row block the kernel writes
    dW directly."""
    nt: int
    kr: int
    kc: int
    cs: int
    span: bool
    stages: int
    tap_groups: int
    o_tiles: int
    row_blocks: int


def span_cols(kc: int) -> int:
    """Input columns a tile's ``kc`` taps kw read."""
    return 2 * (TILE_P - 1) + kc


def x_row_elems(c: int, kc: int, cs: int, span: bool) -> int:
    """bf16 elements of one staged x row (``x_row_elems`` of the kernel): a
    span of all C channels and its alignment offset, or the gathered columns
    of ``cs`` channels, rounded up to a multiple of 8."""
    n = 7 + span_cols(kc) * c if span else span_cols(kc) * cs
    return -(-n // 8) * 8


def slot_bytes(c: int, kr: int, kc: int, cs: int, span: bool) -> int:
    """One slot of the ring: a dy tile and the box's ``kr`` staged x rows."""
    return DY_TILE_BYTES + 2 * kr * x_row_elems(c, kc, cs, span)


def smem_bytes(c: int, kr: int, kc: int, cs: int, span: bool, stages: int) -> int:
    """Dynamic shared memory of one block (``stem_conv_wgrad_smem_bytes``):
    ``stages`` slots and 1024 bytes to align the ring."""
    return 1024 + stages * slot_bytes(c, kr, kc, cs, span)


def stem_wgrad_box(c: int, k: int) -> Tuple[int, int, int, int, bool]:
    """(nt, kr, kc, cs, span): the kernel's tap box for C channels and a
    k x k kernel.

    The boxes are the fewest of at most ``32 * MAX_NT`` taps whose slot lets
    :data:`MIN_STAGES` slots fit :data:`SMEM_TARGET`, whole-C spans
    preferred to gathered channels; their sizes are balanced.
    """
    cap = 8 * WARPS * MAX_NT
    room = (SMEM_TARGET - 1024) // MIN_STAGES - DY_TILE_BYTES  # x bytes of a slot
    best = None
    for kr in range(k, 0, -1):
        for kc in range(k, 0, -1):
            if kr * kc > cap:
                continue
            cs = min(c, cap // (kr * kc))
            span = 2 * kr * x_row_elems(c, kc, 0, True) <= room
            while not span and cs >= 1 and 2 * kr * x_row_elems(c, kc, cs, False) > room:
                cs -= 1
            if cs < 1:
                continue
            key = (-(-k // kr) * -(-k // kc) * -(-c // cs), not span)
            if best is None or key < best[0]:
                best = (key, kr, kc, cs, span)
    _, kr, kc, cs, span = best
    gh, gw, gc = -(-k // kr), -(-k // kc), -(-c // cs)
    kr, kc, cs = -(-k // gh), -(-k // gw), -(-c // gc)  # balanced boxes
    return -(-(kr * kc * cs) // (8 * WARPS)), kr, kc, cs, span


def ring_stages(c: int, kr: int, kc: int, cs: int, span: bool, per_sm: int) -> int:
    """The deepest ring (at most :data:`MAX_STAGES` slots) with which
    ``per_sm`` blocks share an SM's shared memory."""
    room = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - 1024) - 1024
    return min(MAX_STAGES, room // slot_bytes(c, kr, kc, cs, span))


def stem_wgrad_plan(n: int, ho: int, wo: int, c: int, co: int, k: int, sms: int,
                    per_sm: int) -> StemPlan:
    """The stem kernel's launch for x with C channels and dy (N, Ho, Wo, CO)
    with ``per_sm`` blocks an SM (as many as the kernel's occupancy allows,
    :func:`stem_launch_plan`): the box of :func:`stem_wgrad_box`, a ring as
    deep as ``per_sm`` blocks leave room for, o tiles of :data:`TILE_O`,
    and as many row blocks as fit on the card at once and no more, with the
    partial buffer under :data:`MAX_PARTIAL_FLOATS` and no more row blocks
    than tiles."""
    nt, kr, kc, cs, span = stem_wgrad_box(c, k)
    stages = ring_stages(c, kr, kc, cs, span, per_sm)
    tap_groups = -(-k // kr) * -(-k // kc) * -(-c // cs)
    o_tiles = -(-co // TILE_O)
    if tap_groups > 65535 or o_tiles > 65535:
        raise ValueError(f"stem_conv_wgrad: {tap_groups} tap groups and {o_tiles} o "
                         f"tiles at C={c}, CO={co}, k={k}; the grid takes 65535")
    tiles = n * ho * -(-wo // TILE_P)
    if tiles > 2**31 - 1:
        raise ValueError(f"stem_conv_wgrad: {tiles} pixel tiles; the kernel takes 2^31 - 1")
    row_blocks = max(1, min(sms * per_sm // (tap_groups * o_tiles),
                            MAX_PARTIAL_FLOATS // (k * k * c * co), tiles))
    return StemPlan(nt, kr, kc, cs, span, stages, tap_groups, o_tiles, row_blocks)


def stem_wgrad_tiling(x: torch.Tensor, dy: torch.Tensor, kernel: int,
                      plan: StemPlan) -> torch.Tensor:
    """The kernel's walk in plain PyTorch, float32 on bf16-rounded inputs:
    each row block's contiguous range of pixel tiles (up to :data:`TILE_P`
    pixels of one output row, zero past Wo), for each tap group (taps padded
    to 32 * nt) and o tile (zero past CO), a partial dW summed over its
    tiles in order; then the partials summed in ``stem_wgrad_reduce``'s
    fixed order. For the CPU tests of the plan; it matches
    :func:`stem_conv_wgrad_plain` up to the order of fp32 sums."""
    _check_shapes(x, dy, kernel)
    k, p = kernel, kernel // 2
    n, h, w, c = x.shape
    _, ho, wo, co = dy.shape
    col_tiles = -(-wo // TILE_P)
    tiles = n * ho * col_tiles
    # zero padding wide enough for every column 2(wo0 + i) - p + kw a tile reads
    xp = F.pad(x.to(torch.bfloat16).float(),
               (0, 0, p, 2 * TILE_P * col_tiles + k - w, p, 2 * ho + k - h))
    dyf = F.pad(dy.to(torch.bfloat16).float(),
                (0, TILE_O * plan.o_tiles - co, 0, TILE_P * col_tiles - wo))
    gw, gc = -(-k // plan.kc), -(-c // plan.cs)
    pix = torch.arange(TILE_P)
    partials = torch.zeros(plan.row_blocks, k, k, c, co)
    for grp in range(plan.tap_groups):
        kh0, kw0, c0 = grp // (gw * gc) * plan.kr, grp // gc % gw * plan.kc, grp % gc * plan.cs
        box = (min(plan.kr, k - kh0), min(plan.kc, k - kw0), min(plan.cs, c - c0))
        lh, lw, lc = (t.reshape(-1) for t in torch.meshgrid(
            *(torch.arange(e) for e in box), indexing="ij"))
        taps = lh.numel()
        for o_tile in range(plan.o_tiles):
            o0 = o_tile * TILE_O
            for rb in range(plan.row_blocks):
                acc = torch.zeros(TILE_O, 32 * plan.nt)
                for t in range(rb * tiles // plan.row_blocks,
                               (rb + 1) * tiles // plan.row_blocks):
                    row, wo0 = t // col_tiles, t % col_tiles * TILE_P
                    b, oh = row // ho, row % ho
                    xcol = torch.zeros(TILE_P, 32 * plan.nt)
                    xcol[:, :taps] = xp[b, 2 * oh + kh0 + lh[None, :],
                                        2 * (wo0 + pix[:, None]) + kw0 + lw[None, :],
                                        c0 + lc[None, :]]
                    xcol[pix >= wo - wo0] = 0.0  # pixels past the row's end
                    acc += dyf[b, oh, wo0:wo0 + TILE_P, o0:o0 + TILE_O].T @ xcol
                ow = min(TILE_O, co - o0)
                partials[rb, kh0 + lh, kw0 + lw, c0 + lc, o0:o0 + ow] = acc[:ow, :taps].T
    if plan.row_blocks == 1:
        return partials[0]
    sums = torch.zeros(8, k, k, c, co)
    for v in range(8):  # warp v of the reduction: partials v, v + 8, ...
        for g in range(v, plan.row_blocks, 8):
            sums[v] += partials[g]
    out = sums[0]
    for v in range(1, 8):
        out = out + sums[v]
    return out


@functools.cache
def _lib():
    from segtpu_torch.ops import build

    lib = build.load(_LIB_NAME)
    lib.stem_conv_wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
                                    + [ctypes.c_void_p])
    lib.stem_conv_wgrad.restype = ctypes.c_int
    lib.stem_conv_wgrad_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.stem_conv_wgrad_smem_bytes.restype = ctypes.c_int
    lib.stem_conv_wgrad_occupancy.argtypes = [ctypes.c_int] * 2
    lib.stem_conv_wgrad_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _launch_plan(n, ho, wo, c, co, k, device_index):
    """The most blocks an SM (of :data:`MAX_BLOCKS_PER_SM`, each with a ring
    of at least :data:`MIN_STAGES` slots, or two) that the runtime's
    occupancy of the kernel grants, and the plan for them."""
    lib = _lib()
    nt, kr, kc, cs, span = stem_wgrad_box(c, k)
    for per_sm in range(MAX_BLOCKS_PER_SM, 0, -1):
        stages = ring_stages(c, kr, kc, cs, span, per_sm)
        if stages < (MIN_STAGES if per_sm > 1 else 2):
            continue
        smem = smem_bytes(c, kr, kc, cs, span, stages)
        got = lib.stem_conv_wgrad_occupancy(nt, smem)
        if got < 0:
            raise RuntimeError(f"stem_conv_wgrad: occupancy query failed (CUDA error "
                               f"{-got}, {smem} bytes of shared memory)")
        if got >= per_sm:
            sms = torch.cuda.get_device_properties(device_index).multi_processor_count
            return stem_wgrad_plan(n, ho, wo, c, co, k, sms, per_sm), per_sm, smem
    raise RuntimeError(f"stem_conv_wgrad: no block fits on an SM at C={c}, k={k}")


def stem_launch_plan(x_shape, co: int, k: int, device,
                     pad_h=None) -> Tuple[StemPlan, int, int]:
    """(plan, blocks per SM, shared memory bytes per block) of the stem
    kernel for NHWC x of ``x_shape`` (H padded by ``pad_h``) and CO output
    channels on a CUDA ``device``, as the CUDA runtime reports the kernel's
    occupancy there."""
    n, h, w, c = x_shape
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _launch_plan(n, _out_size(h, k, _pad_h(k, pad_h)), _out_size(w, k), c, co, k,
                        index)


def _launch(lib, xb, dyb, k: int, plan: StemPlan, partial, out, pad_top=None) -> None:
    """Launch the kernel of ``lib`` on bf16 NHWC-contiguous ``xb`` and
    ``dyb`` with ``plan``, into ``out`` (through ``partial``, which holds
    ``plan.row_blocks * k*k*C*CO`` floats where there is more than one row
    block), on the current stream; ``pad_top`` zero rows above x (``k//2``
    by default)."""
    n, h, w, c = xb.shape
    _, ho, wo, co = dyb.shape
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.stem_conv_wgrad(
        xb.data_ptr(), dyb.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, h, w, c, ho, wo, co, k, k // 2 if pad_top is None else pad_top,
        plan.nt, plan.kr, plan.kc, plan.cs,
        int(plan.span), plan.stages, plan.row_blocks, stream)
    if err != 0:
        raise RuntimeError(f"stem_conv_wgrad kernel launch failed: CUDA error {err}")


def stem_conv_wgrad(x: torch.Tensor, dy: torch.Tensor, kernel: int = 7,
                    pad_h=None) -> torch.Tensor:
    """dL/dW (HWIO ``(k, k, C, CO)``, fp32) of conv k x k / stride 2 /
    pad k//2, from NHWC ``x`` and ``dy``; ``pad_h = (top, bottom)`` zero
    rows in H instead (a band of an image sharded over H, x carrying its
    halo rows).

    CPU tensors go to :func:`stem_conv_wgrad_plain`. CUDA tensors launch the
    CUDA kernel, which reads bf16 NHWC-contiguous inputs: other dtypes are
    rounded to bf16, and non-contiguous inputs (or an x whose start is not
    16-byte aligned, where the plan copies its rows by 16 bytes) copied
    first, each copy counted in ``stem_conv_wgrad.copies``. Each launch
    adds one to ``stem_conv_wgrad.launches``.
    """
    _check_shapes(x, dy, kernel, pad_h)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return stem_conv_wgrad_plain(x, dy, kernel, pad_h)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"stem_conv_wgrad: x on {x.device} and dy on "
                         f"{dy.device}; both must be on one CUDA device")
    k, c, co = kernel, x.shape[3], dy.shape[3]
    with torch.cuda.device(x.device):
        lib = _lib()
        plan, _, _ = stem_launch_plan(x.shape, co, k, x.device, pad_h)
        xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        if not xb.is_contiguous() or not dyb.is_contiguous():
            stem_conv_wgrad.copies += 1
            xb, dyb = xb.contiguous(), dyb.contiguous()
        if plan.span and xb.data_ptr() % 16:
            stem_conv_wgrad.copies += 1
            xb = xb.clone()
        out = torch.empty((k, k, c, co), dtype=torch.float32, device=x.device)
        partial = out
        if plan.row_blocks > 1:
            partial = torch.empty((plan.row_blocks, k * k * c, co),
                                  dtype=torch.float32, device=x.device)
        _launch(lib, xb, dyb, k, plan, partial, out, _pad_h(k, pad_h)[0])
        stem_conv_wgrad.launches += 1
    return out


stem_conv_wgrad.launches = 0
stem_conv_wgrad.copies = 0


class StemConv(torch.autograd.Function):
    """Conv k x k / stride 2 / pad k//2 (H padded by ``pad_h``), bias-free,
    NCHW, whose weight gradient is :func:`stem_conv_wgrad`."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, k: int, pad_h=None):
        ctx.save_for_backward(x)
        ctx.k, ctx.pad_h = k, _pad_h(k, pad_h)
        ctx.weight_dtype = weight.dtype
        p = k // 2
        if ctx.pad_h == (p, p):
            return F.conv2d(x, weight.to(x.dtype), stride=2, padding=p)
        return F.conv2d(F.pad(x, (0, 0) + ctx.pad_h), weight.to(x.dtype), stride=2,
                        padding=(0, p))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dw = stem_conv_wgrad(x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1),
                             kernel=ctx.k, pad_h=ctx.pad_h)
        dw = dw.permute(3, 2, 0, 1).to(ctx.weight_dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            # The stem conv's input is the MODEL INPUT (data): its gradient
            # is never used, so a zero dx is free. Do NOT use StemConv
            # mid-network where a real dx is needed.
            dx = torch.zeros_like(x)
        return dx, dw, None, None


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

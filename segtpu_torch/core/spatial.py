"""Spatial sharding: each image's H split over the model axis.

Counterpart of segtpu's ``batch_sharding(spatial=True)`` and of what GSPMD
does with it: there XLA splits H over the mesh's ``model`` axis and writes
the halo exchanges; here each rank of a model group (``core/mesh.py``)
holds a band of rows of the same images, and every op whose window
crosses H is written out:

* :func:`split` puts the band boundaries at multiples of the model's total
  stride (``spatial_stride``: 8 for PSPNet, PSPDenseNet, DeepLab_DUC_HDC,
  UNetResnet and ENet, 16 for UNet, ``output_stride`` for UperNet and
  DeepLab, 32 for SegNet, SegResNet, GCN and FCN8), so every strided
  window and every ceil-mode pool starts on a boundary; the smallest map's
  rows are shared as evenly as they go, the first ranks taking the extra
  row, and the last rank takes the remainder of the input. PSPNet at 769 over 2 ranks:
  392/377 input rows, 196/189 after the stem, 98/95 after the pool, 49/48
  in the feature map.
* Convs and pools with a window over H (:class:`HaloConv2d`,
  :func:`max_pool`, :func:`avg_pool`, :class:`HaloStemConv2d`, SegResNet's
  :func:`max_pool_argmax_flat`) receive the rows they read from the ranks
  that own them (:func:`fetch_rows`); zero (or, for a max pool, -inf)
  padding applies only at the image's global top and bottom (FCN8's first
  conv, padded by 100, leaves all 198 added rows to the last rank). The
  backward returns each halo row's gradient to its owner.
* Transposed convs (:func:`conv_transpose2d`; FCN8's fixed upsamplers,
  :class:`HaloFixedUpsample`) have their halo on the output side: each
  band's windows reach rows that other ranks own, and those rows are
  summed onto their owners (:class:`_SumOnOwners`, :class:`_Fetch` the
  other way round); the backward fetches their gradients.
* :func:`resize_bilinear` works from the global source and target sizes,
  each rank computing its own output rows from its source rows and a
  halo (or from a replicated source); :func:`adaptive_avg_pool_multi`
  sums each bin's partial sums over the model group, so its bins are
  replicated on the model ranks, as is ASPP's :func:`image_mean`.
* :func:`crop` cuts global rows into a registered layout (the model's
  offsets from :func:`global_hw`), :func:`pad_or_crop` moves the image's
  rows down or up onto one (ENet's and GCN's top-left alignment), and
  :func:`pixel_shuffle` multiplies each band's rows; SegNet's and ENet's
  argmax pools and unpools (:func:`max_pool_argmax`, :func:`max_unpool`)
  keep to their bands, and SegResNet's :func:`max_unpool_flat` sends each
  write to the rank that owns its canvas row.

Every exchange is an all-reduce of a buffer that is zero outside what each
rank contributes (gloo carries all-reduces of CUDA tensors; it is the
collective the data axis already uses), so a gathered row is its owner's
bits.

While a sharded forward runs (:func:`sharded`), the layout of each map
(:class:`Rows`) is kept under its local height and its width, which is
not sharded: the input's from the step, every other from the op that made
it. An op that meets a map with no layout raises.

:func:`shard_windows` puts these forms into a model, in place: each conv
and each pool module takes its halo class (same parameters and keys), and
each module that calls an op over H through an attribute (``HALO_OPS``:
``_max_pool``, ``_resize``, ``_pool_bins``, ``_image_pool``, ``_shuffle``,
``_crop``, ``_pad_or_crop``, ``_hw``, ``_pool_argmax``, ``_unpool``,
``_pool_argmax_flat``, ``_unpool_flat``) gets this module's function
there. ``ops/`` keeps one path, and each form here runs the plain op
outside a sharded forward.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from segtpu_torch.core import mesh
from segtpu_torch.models.fcn import FixedUpsample
from segtpu_torch.ops import pooling
from segtpu_torch.ops import resize as plain_resize
from segtpu_torch.ops import shape as plain_shape
from segtpu_torch.ops.conv_wgrad import StemConv, StemConv2d
from segtpu_torch.ops.s2d import S2DStemConv2d, s2d_stem_conv


class Rows(NamedTuple):
    """A map's H over the model group: each model rank's ``[lo, hi)`` and
    the global size."""

    bounds: Tuple[Tuple[int, int], ...]
    size: int

    @property
    def mine(self) -> Tuple[int, int]:
        return self.bounds[mesh.model_index()]

    def count(self, t: int) -> int:
        lo, hi = self.bounds[t]
        return hi - lo


#: the layout of a map that every model rank holds whole (the PSP bins)
REPLICATED = "replicated"


def split(h: int, stride: int, parts: int) -> Rows:
    """The input layout of ``h`` rows over ``parts`` ranks for a model of
    total stride ``stride``: the ``ceil(h / stride)`` rows of the smallest
    map shared as evenly as they go (the first ranks take the extra row),
    each boundary at that multiple of ``stride``. Raises ``ValueError``
    where a rank would hold no row of the smallest map."""
    n = -(-h // stride)
    if n < parts:
        raise ValueError(f"spatial: {h} rows leave {n} rows of the stride-{stride} "
                         f"map for {parts} ranks: some rank would hold none; use a "
                         f"crop of at least {stride * (parts - 1) + 1} rows")
    shares = [n // parts + (1 if t < n % parts else 0) for t in range(parts)]
    edges = [stride * sum(shares[:t]) for t in range(parts)] + [h]
    return Rows(tuple((edges[t], edges[t + 1]) for t in range(parts)), h)


# -- the active layouts -----------------------------------------------------------

_layouts: Optional[Dict[Tuple[int, int], object]] = None


def active() -> bool:
    """Whether a sharded forward (or its backward's recompute) runs."""
    return _layouts is not None


@contextlib.contextmanager
def sharded(x: torch.Tensor, rows: Rows):
    """Layouts are tracked inside: the model input ``x`` (this rank's rows)
    has ``rows``. Wrap the forward and the backward, which may recompute."""
    global _layouts
    if x.shape[-2] != rows.count(mesh.model_index()):
        raise ValueError(f"spatial: the input holds {x.shape[-2]} rows, its layout "
                         f"gives this rank {rows.count(mesh.model_index())}")
    prev, _layouts = _layouts, {}
    register(x, rows)
    try:
        yield
    finally:
        _layouts = prev


def register(y: torch.Tensor, rows) -> None:
    """Record the layout of the map ``y`` (a :class:`Rows` or
    :data:`REPLICATED`); a different layout under the same key raises."""
    key = (int(y.shape[-2]), int(y.shape[-1]))
    have = _layouts.setdefault(key, rows)
    if have != rows:
        raise RuntimeError(f"spatial: two layouts for a {key} map: {have} and {rows}")


def rows_of(x: torch.Tensor):
    """The layout of the map ``x``."""
    key = (int(x.shape[-2]), int(x.shape[-1]))
    if key not in _layouts:
        raise RuntimeError(f"spatial: no layout for a map of {key} rows x columns: an "
                           f"op that changes H is not spatial-aware")
    return _layouts[key]


def rows_of_size(h: int, w: int):
    """The layout registered for maps of ``h`` local rows and ``w`` columns."""
    if (h, w) not in _layouts:
        raise RuntimeError(f"spatial: no layout for a map of {(h, w)} rows x columns")
    return _layouts[(h, w)]


# -- halo exchange ----------------------------------------------------------------

def _segments(rows: Rows, need: Sequence[Tuple[int, int]]):
    """For each rank t, the rows of ``need[t]`` (clipped to the map) that t
    does not own: (t, first global row, count), top then bottom; and the
    buffer offset of each."""
    segs, off = [], 0
    for t, (a, b) in enumerate(need):
        lo, hi = rows.bounds[t]
        for s0, s1 in ((max(a, 0), min(lo, b)), (max(a, hi), min(b, rows.size))):
            if s1 > s0:
                segs.append((t, s0, s1 - s0, off))
                off += s1 - s0
    return segs, off


def _overlap(g0: int, n: int, lo: int, hi: int):
    s0, s1 = max(g0, lo), min(g0 + n, hi)
    return (s0, s1) if s1 > s0 else None


def _gather(x, rows, need, segs, total, group):
    """Rows ``need[me]`` of the global map (clipped to it) on each rank,
    from the ranks that own them (``x``: this rank's rows of ``rows``)."""
    me = mesh.model_index()
    lo, hi = rows.bounds[me]
    buf = None
    if total:
        buf = x.new_zeros(x.shape[:2] + (total,) + x.shape[3:])
        for t, g0, n, off in segs:
            ov = _overlap(g0, n, lo, hi)
            if ov is not None:
                buf[:, :, off + ov[0] - g0:off + ov[1] - g0] = x[:, :, ov[0] - lo:ov[1] - lo]
        dist.all_reduce(buf, group=group)
    a, b = need[me]
    parts = [buf[:, :, off:off + n] for t, g0, n, off in segs if t == me and g0 < lo]
    own0, own1 = max(a, lo), min(b, hi)
    if own1 > own0:
        parts.append(x[:, :, own0 - lo:own1 - lo])
    parts += [buf[:, :, off:off + n] for t, g0, n, off in segs if t == me and g0 >= hi]
    if not parts:  # every asked-for row lies outside the map
        return x.new_zeros(x.shape[:2] + (0,) + x.shape[3:])
    return torch.cat(parts, dim=2) if len(parts) > 1 else parts[0].clone()


def _scatter_add(g, rows, need, segs, total, group):
    """:func:`_gather`'s adjoint: each rank's rows ``need[me]`` (clipped to
    the map) of ``g`` summed onto the ranks that own them; this rank's rows
    of ``rows``."""
    me = mesh.model_index()
    lo, hi = rows.bounds[me]
    a, b = need[me]
    out = g.new_zeros(g.shape[:2] + (hi - lo,) + g.shape[3:])
    at = 0
    buf = g.new_zeros(g.shape[:2] + (total,) + g.shape[3:]) if total else None
    for t, g0, n, off in segs:
        if t == me and g0 < lo:
            buf[:, :, off:off + n] = g[:, :, at:at + n]
            at += n
    own0, own1 = max(a, lo), min(b, hi)
    if own1 > own0:
        out[:, :, own0 - lo:own1 - lo] = g[:, :, at:at + own1 - own0]
        at += own1 - own0
    for t, g0, n, off in segs:
        if t == me and g0 >= hi:
            buf[:, :, off:off + n] = g[:, :, at:at + n]
            at += n
    if total:
        dist.all_reduce(buf, group=group)
        for t, g0, n, off in segs:
            ov = _overlap(g0, n, lo, hi)
            if ov is not None:
                out[:, :, ov[0] - lo:ov[1] - lo] += buf[:, :, off + ov[0] - g0:off + ov[1] - g0]
    return out


class _Fetch(torch.autograd.Function):
    """Rows ``[a, b)`` of the global map (clipped to it) on each rank, from
    the ranks that own them (:func:`_gather`); backward: each row's
    gradient summed back on its owner (:func:`_scatter_add`)."""

    @staticmethod
    def forward(ctx, x, rows, need, group):
        ctx.args = (rows, need, *_segments(rows, need), group)
        return _gather(x, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        return _scatter_add(g, *ctx.args), None, None, None


class _SumOnOwners(torch.autograd.Function):
    """:class:`_Fetch` the other way round: each rank's rows ``[a, b)`` of
    the global map (clipped to it) summed onto the ranks that own them, an
    output-side halo; backward: each row's gradient fetched from its
    owner."""

    @staticmethod
    def forward(ctx, y, rows, need, group):
        ctx.args = (rows, need, *_segments(rows, need), group)
        return _scatter_add(y, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def fetch_rows(x: torch.Tensor, rows: Rows, need: Sequence[Tuple[int, int]]):
    """Global rows ``need[me]`` of the map ``x`` (this rank's rows of
    ``rows``) on this rank, every rank asking for its own ``need[t]`` in
    the same call: ``(ext, top, bottom)``, ``ext`` the rows that lie in the
    map and ``top``/``bottom`` how many asked-for rows lie above and below
    it (the caller's padding)."""
    a, b = need[mesh.model_index()]
    ext = _Fetch.apply(x, rows, tuple(need), mesh.model_group())
    return ext, max(0, min(b, 0) - a), max(0, b - max(a, rows.size))


def _window_rows(rows: Rows, k_eff: int, s: int, p: int, out_size: int):
    """Each rank's output rows ``[lo/s, hi/s)`` (the last rank's up to
    ``out_size``) and the input rows they read."""
    bounds, need = [], []
    m = len(rows.bounds)
    for t, (lo, hi) in enumerate(rows.bounds):
        if t and lo % s:
            raise ValueError(f"spatial: a stride-{s} window at a band boundary {lo} "
                             f"that is not a multiple of {s}")
        o0 = lo // s
        o1 = out_size if t == m - 1 else hi // s
        if o1 <= o0:
            raise ValueError(f"spatial: rank {t} holds no output row of a {out_size}-row "
                             f"map; use a larger crop")
        bounds.append((o0, o1))
        need.append((o0 * s - p, (o1 - 1) * s - p + k_eff))
    return Rows(tuple(bounds), out_size), need


def window_layout(rows: Rows, k: int, s: int, p: int, d: int = 1,
                  ceil_mode: bool = False):
    """For a window of ``k`` taps (dilation ``d``), stride ``s`` and padding
    ``p`` over a map of layout ``rows``: the output's layout and the input
    rows each rank's output rows read."""
    k_eff = d * (k - 1) + 1
    span = rows.size + 2 * p - k_eff
    out = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= rows.size + p:
        out -= 1
    return _window_rows(rows, k_eff, s, p, out)


def window_input(x: torch.Tensor, k: int, s: int, p: int, d: int = 1,
                 ceil_mode: bool = False):
    """:func:`window_layout` of ``x``'s layout: ``(ext, top, bottom,
    out_rows)``, the rows this rank's output rows read (:func:`fetch_rows`)
    and the output's layout."""
    rows = rows_of(x)
    out_rows, need = window_layout(rows, k, s, p, d, ceil_mode)
    ext, top, bottom = fetch_rows(x, rows, need)
    return ext, top, bottom, out_rows


def _pad_rows(x: torch.Tensor, top: int, bottom: int, value: float = 0.0) -> torch.Tensor:
    if not (top or bottom):
        return x
    return F.pad(x, (0, 0, top, bottom), value=value)


def conv2d(x, weight, bias, stride, padding, dilation, groups):
    """``F.conv2d`` over this rank's rows of a sharded map, registering the
    output's layout."""
    ext, top, bottom, out_rows = window_input(x, weight.shape[2], stride[0], padding[0],
                                              dilation[0])
    y = F.conv2d(_pad_rows(ext, top, bottom), weight, bias, stride, (0, padding[1]),
                 dilation, groups)
    register(y, out_rows)
    return y


def conv_transpose2d(x, weight, bias, stride, padding, output_padding, groups, dilation):
    """``F.conv_transpose2d`` over a sharded map, for any kernel, stride,
    padding and output padding over H: the adjoint of the halo fetch. Each
    rank runs the plain transposed conv on its band ``[lo, hi)`` without H
    padding and without bias, which gives global rows ``[s*lo - p, s*(hi -
    1) + k_eff - p)``; the rows above the image and past its ``(n - 1) s -
    2p + k_eff + op`` are cut, the rows another rank owns are summed onto
    their owner (:class:`_SumOnOwners`), and the bias is added once, after
    the sum. The output padding's rows take whatever falls there, as in
    torch. Output rows ``[s*lo, s*hi)`` a rank, the last rank's to the
    end."""
    rows = rows_of(x)
    s, p = stride[0], padding[0]
    k_eff = dilation[0] * (weight.shape[2] - 1) + 1
    size = (rows.size - 1) * s - 2 * p + k_eff + output_padding[0]
    last = len(rows.bounds) - 1
    out_rows = Rows(tuple((s * lo, size if t == last else s * hi)
                          for t, (lo, hi) in enumerate(rows.bounds)), size)
    if out_rows.count(last) <= 0:
        raise ValueError(f"spatial: the last rank holds no row of a {size}-row transposed "
                         f"conv output")
    # the global output rows each band's windows reach
    reach = tuple((s * lo - p, s * (hi - 1) + k_eff - p) for lo, hi in rows.bounds)
    y = F.conv_transpose2d(x, weight, None, (s, stride[1]), (0, padding[1]),
                           (0, output_padding[1]), groups, dilation)
    a, b = reach[mesh.model_index()]
    y = y[:, :, max(0, -a):y.shape[2] - max(0, b - out_rows.size)]
    y = _SumOnOwners.apply(y, out_rows, reach, mesh.model_group())
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    register(y, out_rows)
    return y


class HaloConv2d(nn.Conv2d):
    """``nn.Conv2d`` (its class swapped in place: same parameters and keys)
    whose window over H crosses band boundaries: its input rows come from
    their owners, and its H padding is the image's."""

    def _conv_forward(self, x, weight, bias):
        if not active():
            return super()._conv_forward(x, weight, bias)
        return conv2d(x, weight, bias, self.stride, self.padding, self.dilation,
                      self.groups)


class HaloConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` over a sharded map (:func:`conv_transpose2d`)."""

    def forward(self, x, output_size=None):
        if not active():
            return super().forward(x, output_size)
        return conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                self.output_padding, self.groups, self.dilation)


class HaloFixedUpsample(FixedUpsample):
    """FCN8's fixed bilinear upsampler (its class swapped in place: same
    buffer and keys) over a sharded map (:func:`conv_transpose2d`)."""

    def forward(self, x):
        if not active():
            return super().forward(x)
        s = self.stride
        return conv_transpose2d(x, self.weight, None, (s, s), (0, 0), (0, 0), 1, (1, 1))


class HaloStemConv2d(StemConv2d):
    """The stem kernel's conv over a band: x carries the halo rows, and the
    kernel pads H only at the image's top and bottom (``pad_h``)."""

    def forward(self, x):
        if not active():
            return super().forward(x)
        k = self.kernel_size
        ext, top, bottom, out_rows = window_input(x, k, 2, k // 2)
        y = StemConv.apply(ext, self.weight, k, (top, bottom))
        register(y, out_rows)
        return y


class HaloS2DStemConv2d(S2DStemConv2d):
    """The space-to-depth stem conv over a band, as :class:`HaloStemConv2d`."""

    def forward(self, x):
        if not active():
            return super().forward(x)
        k = self.kernel_size
        ext, top, bottom, out_rows = window_input(x, k, 2, k // 2)
        y = s2d_stem_conv(ext, self.weight, k // 2, (top, bottom))
        register(y, out_rows)
        return y


def max_pool(x: torch.Tensor, window, stride=None, padding=0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch-style max pool over a sharded map (-inf beyond the image)."""
    if not active():
        return pooling.max_pool(x, window, stride, padding, ceil_mode)
    kh, kw = (window, window) if isinstance(window, int) else window
    stride = stride or (kh, kw)
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    ext, top, bottom, out_rows = window_input(x, kh, sh, ph, 1, ceil_mode)
    y = F.max_pool2d(_pad_rows(ext, top, bottom, -torch.inf), (kh, kw), (sh, sw),
                     (0, pw), ceil_mode=ceil_mode)
    register(y, out_rows)
    return y


class HaloMaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` (its class swapped in place) over a sharded map
    (:func:`max_pool`): DenseNet's stem pools."""

    def forward(self, x):
        if not active():
            return super().forward(x)
        if self.return_indices or self.dilation not in (1, (1, 1)):
            raise NotImplementedError("spatial: a module max pool with indices or "
                                      "dilation is not sharded over H")
        return max_pool(x, self.kernel_size, self.stride, self.padding, self.ceil_mode)


def avg_pool(x: torch.Tensor, window, stride=None, padding=0, ceil_mode: bool = False,
             count_include_pad: bool = True, divisor_override=None) -> torch.Tensor:
    """``F.avg_pool2d`` over a sharded map, for windows without padding over
    H (DenseNet's transition pool), registering the output's layout."""
    kh, kw = _pair(window)
    sh, sw = _pair(stride or (kh, kw))
    ph, pw = _pair(padding)
    if ph:
        raise NotImplementedError(f"spatial: an average pool padded by {ph} rows is not "
                                  f"sharded over H")
    ext, _, _, out_rows = window_input(x, kh, sh, 0, 1, ceil_mode)
    y = F.avg_pool2d(ext, (kh, kw), (sh, sw), (0, pw), ceil_mode, count_include_pad,
                     divisor_override)
    register(y, out_rows)
    return y


class HaloAvgPool2d(nn.AvgPool2d):
    """``nn.AvgPool2d`` (its class swapped in place) over a sharded map
    (:func:`avg_pool`)."""

    def forward(self, x):
        if not active():
            return super().forward(x)
        return avg_pool(x, self.kernel_size, self.stride, self.padding, self.ceil_mode,
                        self.count_include_pad, self.divisor_override)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def max_pool_argmax(x: torch.Tensor):
    """SegNet's 2x2/2 ceil-mode argmax pool over a sharded map. The band
    boundaries lie on even rows (the model's stride), so no window crosses
    one and each band pools its own rows; the indices stay local to the
    band (flat positions in the band's plane), which is what
    :func:`max_unpool` on the same band reads. The last band keeps the
    ceil-mode partial window."""
    if not active():
        return pooling.max_pool_argmax(x)
    rows = rows_of(x)
    out_rows, need = window_layout(rows, 2, 2, 0, 1, ceil_mode=True)
    (lo, hi), (a, b) = rows.mine, need[mesh.model_index()]
    if a != lo or min(b, rows.size) != hi:
        raise RuntimeError(f"spatial: a 2x2/2 pool over rows [{lo}, {hi}) reads "
                           f"[{a}, {b})")
    y, idx = F.max_pool2d(x, 2, 2, ceil_mode=True, return_indices=True)
    register(y, out_rows)
    return y, idx


def max_unpool(y: torch.Tensor, idx: torch.Tensor, output_size) -> torch.Tensor:
    """:func:`max_pool_argmax`'s inverse on each band: ``output_size`` is
    the band's pre-pool size, whose layout is registered."""
    if not active():
        return pooling.max_unpool(y, idx, output_size)
    rows_of_size(int(output_size[0]), int(output_size[1]))  # raises where it has none
    return pooling.max_unpool(y, idx, output_size)


def max_pool_argmax_flat(x: torch.Tensor):
    """SegResNet's 3x3/2/pad-1 argmax pool over a sharded map: a band's top
    window reads a halo row from the rank above. The indices are global:
    flat row-major positions ``h*W + w`` in the whole input plane, as the
    unsharded op's, so an index can name a row that another rank owns."""
    if not active():
        return pooling.max_pool_argmax_flat(x)
    ext, top, bottom, out_rows = window_input(x, 3, 2, 1)
    y, idx = F.max_pool2d(_pad_rows(ext, top, bottom, -torch.inf), 3, 2, (0, 1),
                          return_indices=True)
    # row 0 of the padded rows is global row o0*2 - 1
    idx = idx + (2 * out_rows.mine[0] - 1) * x.shape[-1]
    register(y, out_rows)
    return y, idx


def _unpool_reach(n_pooled: int, out_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first and last canvas row (of width ``out_w``) that each pooled
    row's flat indices can name: a 3x3/2/1 window reads input rows 2i-1 to
    2i+1, and the input is ``out_w - 1`` or ``out_w`` columns wide."""
    i = np.arange(n_pooled)
    first = (np.maximum(2 * i - 1, 0) * (out_w - 1)) // out_w
    last = np.minimum(((2 * i + 2) * out_w - 1) // out_w, 2 * n_pooled - 1)
    return first, last


class _BandUnpoolFlat(torch.autograd.Function):
    """:func:`max_unpool_flat` onto one band of the canvas, ``rows`` rows
    from global canvas row ``first``, from consecutive global pooled rows
    (this rank's and fetched ones) in order: their row-major order is the
    global one, so where indices repeat the last pooled pixel wins, as in
    ``ops/pooling.py``. Backward: each pooled pixel reads the cotangent at
    its index where that lies in the band, else 0 (the rank that owns that
    canvas row supplies it)."""

    @staticmethod
    def forward(ctx, y, idx, first, rows, out_w):
        b, c = y.shape[:2]
        n = rows * out_w
        pos = idx.reshape(b, c, -1) - first * out_w
        inside = (pos >= 0) & (pos < n)
        slot = torch.where(inside, pos, torch.full_like(pos, n))  # n: a spill slot
        ordinal = torch.arange(pos.shape[2], device=y.device)
        winner = torch.full((b, c, n + 1), -1, device=y.device, dtype=ordinal.dtype)
        winner.scatter_reduce_(2, slot, ordinal.expand(b, c, -1), "amax")
        winner = winner[:, :, :n]
        values = y.reshape(b, c, -1).gather(2, winner.clamp(min=0))
        out = torch.where(winner >= 0, values,
                          torch.zeros((), dtype=y.dtype, device=y.device))
        ctx.save_for_backward(slot, inside)
        ctx.shape = y.shape
        return out.reshape(b, c, rows, out_w)

    @staticmethod
    def backward(ctx, g):
        slot, inside = ctx.saved_tensors
        b, c = g.shape[:2]
        flat = torch.cat([g.reshape(b, c, -1), g.new_zeros(b, c, 1)], 2)
        grad = flat.gather(2, slot) * inside
        return grad.reshape(ctx.shape), None, None, None, None


def max_unpool_flat(y: torch.Tensor, idx: torch.Tensor, output_hw) -> torch.Tensor:
    """SegResNet's unpool over a sharded map, with the unsharded op's
    semantics (``ops/pooling.py``): the canvas is one row-major plane of
    the global ``2*ih`` x ``output_hw[1]`` read at the global flat indices of
    :func:`max_pool_argmax_flat`; each rank holds the canvas rows twice its
    pooled rows (``output_hw[0]`` is twice this band's pooled rows). Each
    rank fetches the pooled rows whose indices can land in its canvas rows
    (so a write to a row that another rank owns reaches its owner), and
    where indices repeat the pooled pixel of the highest global row-major
    ordinal wins, across the boundary too. The backward gathers the
    cotangent at every index from the rank that owns it."""
    if not active():
        return pooling.max_unpool_flat(y, idx, output_hw)
    src = rows_of(y)
    r = int(output_hw[0]) // y.shape[-2]
    if r * y.shape[-2] != int(output_hw[0]):
        raise ValueError(f"spatial: an unpool of {y.shape[-2]} rows onto {output_hw[0]}")
    out_w = int(output_hw[1])
    canvas = Rows(tuple((r * lo, r * hi) for lo, hi in src.bounds), r * src.size)
    first, last = _unpool_reach(src.size, out_w)
    need = []
    for c0, c1 in canvas.bounds:
        hit = np.nonzero((first < c1) & (last >= c0))[0]
        need.append((int(hit[0]), int(hit[-1]) + 1))
    ext, _, _ = fetch_rows(y, src, need)
    ext_idx, _, _ = fetch_rows(idx, src, need)
    c0, c1 = canvas.mine
    out = _BandUnpoolFlat.apply(ext, ext_idx, c0, c1 - c0, out_w)
    register(out, canvas)
    return out


def image_mean(x: torch.Tensor) -> torch.Tensor:
    """ASPP's image pool over a sharded map: each rank's sum over its rows,
    summed over the model group both ways (each rank's gradient of the mean
    is the part its rows carried), over the global H x W; the 1x1 map is
    replicated on the model ranks."""
    if not active():
        return pooling.image_mean(x)
    rows = rows_of(x)
    acc = torch.promote_types(x.dtype, torch.float32)
    part = x.to(acc).sum(dim=(2, 3), keepdim=True)
    total = mesh.sum_both_ways(part, mesh.model_group())
    y = (total / (rows.size * x.shape[-1])).to(x.dtype)
    register(y, REPLICATED)
    return y


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """``F.pixel_shuffle`` over a sharded map: each band's rows times
    ``r``, the output's layout ``(r*lo, r*hi)`` of ``r`` times the rows."""
    y = F.pixel_shuffle(x, r)
    if active():
        rows = rows_of(x)
        register(y, Rows(tuple((r * lo, r * hi) for lo, hi in rows.bounds), r * rows.size))
    return y


def global_hw(x: torch.Tensor):
    """The global (H, W) of a sharded map."""
    if not active():
        return plain_shape.hw(x)
    return rows_of(x).size, int(x.shape[-1])


def crop(x: torch.Tensor, top: int, left: int, size) -> torch.Tensor:
    """``ops/shape.py``'s crop over a sharded map: global rows ``[top, top +
    n)`` and columns ``[left, left + size[1])``, where ``size`` is the local
    size of a map whose layout (of ``n`` global rows) the cropped map takes.
    Each rank's rows come from their owners: a band that holds rows past
    the cut drops them, and where the cut starts at row 0 and the target's
    bands are the source's, cut short (DeepLab_DUC_HDC's crops), a band
    that holds none of them keeps all of its rows and no row moves."""
    if not active():
        return plain_shape.crop(x, top, left, size)
    src, dst = rows_of(x), rows_of_size(int(size[0]), int(size[1]))
    if top < 0 or top + dst.size > src.size:
        raise ValueError(f"spatial: rows [{top}, {top + dst.size}) of a {src.size}-row map")
    need = [(top + lo, top + hi) for lo, hi in dst.bounds]
    ext, _, _ = fetch_rows(x, src, need)
    y = ext[..., left:left + int(size[1])]
    register(y, dst)
    return y


def pad_or_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``ops/shape.py``'s ``pad_or_crop_tl`` over a sharded map: ``h`` x
    ``w`` is the local size of a map whose layout (of ``n`` global rows) the
    result takes, and the image's rows move down by ``dh = n -`` the
    source's rows: each target band ``[lo, hi)`` holds global rows ``[lo -
    dh, hi - dh)`` of ``x`` from their owners: zeros above global row 0
    where ``dh`` is positive, the top ``-dh`` rows cut where it is negative
    (:func:`crop` at ``-dh``). Columns are padded or cut at the left as in
    the plain op."""
    if not active():
        return plain_shape.pad_or_crop_tl(x, h, w)
    src, dst = rows_of(x), rows_of_size(int(h), int(w))
    dh = dst.size - src.size
    y = x
    if src != dst:
        ext, top, _ = fetch_rows(x, src, [(lo - dh, hi - dh) for lo, hi in dst.bounds])
        y = _pad_rows(ext, top, 0)
    dw = int(w) - x.shape[-1]
    if dw:
        y = F.pad(y, (dw, 0))
    register(y, dst)
    return y


# -- ops in global coordinates ----------------------------------------------------

def _source_rows(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """torch's bilinear source coordinate of each output row (float64)."""
    i = np.arange(n_out, dtype=np.float64)
    if align_corners:
        scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        return scale * i
    return np.maximum(n_in / n_out * (i + 0.5) - 0.5, 0.0)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize from a sharded (or replicated) map to the sharded map
    of local size ``size``, in global coordinates: each rank's output rows
    from the source rows they read, fetched from their owners; the identity
    only where the source's layout is the target's."""
    if not active():
        return plain_resize.resize_bilinear(x, size, align_corners)
    src, dst = rows_of(x), rows_of_size(int(size[0]), int(size[1]))
    n_out = dst.size
    n_in = x.shape[-2] if src == REPLICATED else src.size
    w_out = int(size[1])
    if src == dst and x.shape[-1] == w_out:
        return x
    pos = _source_rows(n_in, n_out, align_corners)
    y0 = np.floor(pos).astype(np.int64)
    y1 = np.minimum(y0 + 1, n_in - 1)
    need = [(int(y0[lo:hi].min()), int(y1[lo:hi].max()) + 1) for lo, hi in dst.bounds]
    if src == REPLICATED:
        ext, base = x, 0
    else:
        ext, _, _ = fetch_rows(x, src, need)
        base = need[mesh.model_index()][0]
    lo, hi = dst.mine
    lam = torch.tensor(pos[lo:hi] - y0[lo:hi], dtype=torch.float64)
    lam = lam.to(x.device, x.dtype if x.is_floating_point() else torch.float32)
    lam = lam.view(1, 1, -1, 1)
    i0 = torch.as_tensor(y0[lo:hi] - base, device=x.device)
    i1 = torch.as_tensor(y1[lo:hi] - base, device=x.device)
    rows = ext.index_select(2, i0) * (1 - lam) + ext.index_select(2, i1) * lam
    if x.shape[-1] == w_out:
        return rows
    # H is already the output's: torch's bilinear over W alone (its H
    # weights are 1 and 0)
    return F.interpolate(rows, size=(hi - lo, w_out), mode="bilinear",
                         align_corners=align_corners)


def adaptive_avg_pool_multi(x: torch.Tensor, sizes: Sequence) -> List[torch.Tensor]:
    """``adaptive_avg_pool2d(x, s)`` of the whole map for every bin size,
    replicated on the model ranks: each bin's partial sum over this rank's
    rows (global bin bounds), summed over the model group both ways (each
    rank's gradient of a bin is the part its rows carried)."""
    if not active():
        return pooling.adaptive_avg_pool_multi(x, sizes)
    rows = rows_of(x)
    lo, hi = rows.mine
    h, w = rows.size, x.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xa = x.to(acc)
    out = []
    for s in sizes:
        s = int(s)
        bins = [(i * h // s, -(-(i + 1) * h // s)) for i in range(s)]
        cols = [(j * w // s, -(-(j + 1) * w // s)) for j in range(s)]
        mh = torch.zeros(s, hi - lo, dtype=torch.float64)
        for i, (b0, b1) in enumerate(bins):
            ov = _overlap(b0, b1 - b0, lo, hi)
            if ov is not None:
                mh[i, ov[0] - lo:ov[1] - lo] = 1.0
        mw = torch.zeros(s, w, dtype=torch.float64)
        for j, (c0, c1) in enumerate(cols):
            mw[j, c0:c1] = 1.0
        area = torch.tensor([[(b1 - b0) * (c1 - c0) for c0, c1 in cols] for b0, b1 in bins],
                            dtype=torch.float64)
        with torch.autocast(x.device.type, enabled=False):
            part = torch.einsum("ih,nchw,jw->ncij", mh.to(x.device, acc), xa,
                                mw.to(x.device, acc))
            pooled = mesh.sum_both_ways(part, mesh.model_group()) / area.to(x.device, acc)
        pooled = pooled.to(x.dtype)
        register(pooled, REPLICATED)
        out.append(pooled)
    return out


# -- whole images -----------------------------------------------------------------

def keep_rows(a: np.ndarray, rows: Rows) -> np.ndarray:
    """This rank's rows of a host batch (NHWC images or NHW labels)."""
    lo, hi = rows.mine
    return a[:, lo:hi]


def gather_image(t: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The whole H of ``t`` (HWC or HW: this rank's rows of ``rows``) on
    every model rank: for the val grid only, which shows full images."""
    lo, hi = rows.mine
    buf = F.pad(t, [0, 0] * (t.dim() - 1) + [lo, rows.size - hi])
    dist.all_reduce(buf, group=mesh.model_group())
    return buf


# -- the models -------------------------------------------------------------------

#: the models that set ``spatial_stride``
SHARDED_MODELS = ("PSPNet", "PSPDenseNet", "UperNet", "DeepLab", "DeepLab_DUC_HDC", "UNet",
                  "UNetResnet", "SegNet", "SegResNet", "ENet", "GCN", "FCN8")


def check_model(model: nn.Module) -> int:
    """The model's total stride over H (``spatial_stride``); a model without
    one raises ``ValueError``: only ``SHARDED_MODELS`` are sharded over H."""
    stride = getattr(model, "spatial_stride", None)
    if stride is None:
        raise ValueError(f"trainer.spatial: {type(model).__name__} has no spatial_stride: "
                         f"only {', '.join(SHARDED_MODELS)} are sharded over H")
    return stride


#: the halo class of each conv class with a window over H
HALO_CLASSES = {nn.ConvTranspose2d: HaloConvTranspose2d, StemConv2d: HaloStemConv2d,
                S2DStemConv2d: HaloS2DStemConv2d, nn.MaxPool2d: HaloMaxPool2d,
                nn.AvgPool2d: HaloAvgPool2d, FixedUpsample: HaloFixedUpsample}
#: the sharded form of each op a module calls through the attribute
HALO_OPS = {"_max_pool": max_pool, "_resize": resize_bilinear,
            "_pool_bins": adaptive_avg_pool_multi, "_image_pool": image_mean,
            "_shuffle": pixel_shuffle, "_crop": crop, "_pad_or_crop": pad_or_crop,
            "_hw": global_hw, "_pool_argmax": max_pool_argmax, "_unpool": max_unpool,
            "_pool_argmax_flat": max_pool_argmax_flat, "_unpool_flat": max_unpool_flat}


def shard_windows(model: nn.Module) -> int:
    """Swap every conv and pool module of ``model`` with a window or a
    stride over H for its halo counterpart, in place (class swap:
    parameters, keys and any tensor-parallel slicing stay), and set the
    sharded ops on the modules that call them through ``HALO_OPS``'
    attributes; returns how many modules were swapped. A conv that already took a sharded class keeps
    its own (``core/tensor_parallel.py`` gives it the halo)."""
    n = 0
    for m in model.modules():
        for name, fn in HALO_OPS.items():
            if hasattr(type(m), name):
                setattr(m, name, fn)
        if type(m) is nn.Conv2d and (m.kernel_size[0] > 1 or m.stride[0] > 1):
            m.__class__ = HaloConv2d
            n += 1
        elif type(m) in HALO_CLASSES:
            m.__class__ = HALO_CLASSES[type(m)]
            n += 1
    return n

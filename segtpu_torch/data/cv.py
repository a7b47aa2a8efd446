"""numpy versions of the six OpenCV calls segtpu's data pipeline makes,
with OpenCV 5.0's results (``segtpu/data/base.py:104,133-172``).

- ``resize_linear`` (``cv2.resize`` INTER_LINEAR, float images of two rows
  or more): source coordinates ``(d + 0.5) * src / dst - 0.5`` in double,
  clamped at both ends, the fraction cast to float32; a horizontal pass, then
  a vertical one, each ``a + w * (b - a)`` in one rounding (a fused
  multiply-add). Bit for bit, exact 2x downscales included.
- ``resize_nearest`` (INTER_NEAREST): source index ``floor(d * (1 / (dst /
  src)))`` in double. Bit for bit.
- ``rotation_matrix`` (``cv2.getRotationMatrix2D``). Bit for bit.
- ``warp_affine_linear`` / ``warp_affine_nearest`` (``cv2.warpAffine``, a
  constant border of 0): the matrix inverted in double and cast to float32;
  source coordinates ``fma(m0, x, m1 * y + m2)`` in float32; NEAREST takes
  ``rint``, LINEAR blends the four neighbours with fused ``a + w * (b - a)``
  steps, pixels outside the frame reading 0. Labels match bit for bit at
  the tests' sizes; images differ from OpenCV's in the last float bits on
  about 1e-5 of their uint8 levels.
- ``gaussian_blur`` (``cv2.GaussianBlur``, BORDER_REFLECT_101, float32,
  ksize 1 or 3): the kernel of ``getGaussianKernel``, a row pass
  ``fma(c, k0, (l + r) * k1)`` then a column pass ``fma(l + r, k1, c * k0)``.
  Bit for bit.

A fused multiply-add is emulated in float64: the product of two float32
values is exact there, so only a sum that lands on a float32 tie could round
twice.

Every output pixel of the resizes and the warps depends only on its own
coordinates, so each takes an output window (``rows``, ``cols``: half-open
ranges) and computes only that; the warps also read their source from a
window of the source frame (``src_origin``). The train
augmentation evaluates its chain only over the crop that it keeps.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

_F32 = np.float32
_BLOCK = 1 << 15  # values per block of _fma's float64 temporary
Range = Optional[Tuple[int, int]]


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, by blocks of rows that keep the
    float64 temporary in cache."""
    a, b, c = (np.asarray(x) for x in (a, b, c))
    shape = np.broadcast_shapes(a.shape, b.shape, c.shape)
    out = np.empty(shape, _F32)
    if out.size == 0:
        return out
    step = max(1, _BLOCK // max(1, out[0].size))
    tmp = np.empty((min(step, shape[0]),) + shape[1:], np.float64)

    def rows(x, i, j):
        return x[i:j] if x.ndim == len(shape) and x.shape[0] != 1 else x

    for i in range(0, shape[0], step):
        j = min(i + step, shape[0])
        t = tmp[:j - i]
        np.multiply(rows(a, i, j), rows(b, i, j), out=t, dtype=np.float64)
        np.add(t, rows(c, i, j), out=t)
        out[i:j] = t
    return out


def _lerp(a, b, w) -> np.ndarray:
    """``a + w * (b - a)`` in float32 with one rounding after the product."""
    return _fma(w, b - a, a)


def _span(r: Range, n: int) -> np.ndarray:
    return np.arange(*(r if r is not None else (0, n)))


def _linear_taps(dst_idx: np.ndarray, dst: int, src: int):
    """(first index, second index, float32 weight of the second) of each
    output index along one axis."""
    f = (dst_idx + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    frac = f - s
    s = s.astype(np.int64)
    frac[(s < 0) | (s >= src - 1)] = 0
    s0 = np.clip(s, 0, src - 1)
    return s0, np.minimum(s0 + 1, src - 1), frac.astype(_F32)


def resize_linear(image: np.ndarray, hw: Tuple[int, int], rows: Range = None,
                  cols: Range = None) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 HW or HWC image, restricted to output ``rows`` x ``cols``."""
    h, w = hw
    src_h, src_w = image.shape[:2]
    ys, xs = _span(rows, h), _span(cols, w)
    y0, y1, wy = _linear_taps(ys, h, src_h)
    x0, x1, wx = _linear_taps(xs, w, src_w)
    if not (len(ys) and len(xs)):
        return np.zeros((len(ys), len(xs)) + image.shape[2:], _F32)
    # horizontal pass over the source rows and columns the window reads
    need = np.union1d(y0, y1)
    c0, c1 = int(x0.min()), int(x1.max()) + 1
    src = np.asarray(np.take(image[need[0]:need[-1] + 1, c0:c1], need - need[0],
                             axis=0), _F32)
    tail = (None,) * (image.ndim - 2)
    t = _lerp(np.take(src, x0 - c0, axis=1), np.take(src, x1 - c0, axis=1),
              wx[(None, slice(None)) + tail])
    pos0, pos1 = np.searchsorted(need, y0), np.searchsorted(need, y1)
    return _lerp(np.take(t, pos0, axis=0), np.take(t, pos1, axis=0),
                 wy[(slice(None), None) + tail])


def resize_nearest(label: np.ndarray, hw: Tuple[int, int], rows: Range = None,
                   cols: Range = None) -> np.ndarray:
    """``cv2.resize(label, (w, h), interpolation=cv2.INTER_NEAREST)``,
    restricted to output ``rows`` x ``cols``."""
    h, w = hw
    src_h, src_w = label.shape[:2]
    ys = np.minimum(np.floor(_span(rows, h) * (1.0 / (h / src_h))).astype(np.int64),
                    src_h - 1)
    xs = np.minimum(np.floor(_span(cols, w) * (1.0 / (w / src_w))).astype(np.int64),
                    src_w - 1)
    return label[ys[:, None], xs[None, :]]


def rotation_matrix(center: Sequence[float], angle: float,
                    scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: 2x3 float64; the
    centre is rounded to float32 as OpenCV's Point2f does."""
    cx, cy = (float(_F32(c)) for c in center)
    angle = angle * (math.pi / 180)  # OpenCV: angle *= CV_PI/180
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_f32(matrix: np.ndarray) -> np.ndarray:
    """The inverse affine map, as ``cv2.warpAffine`` inverts it (double),
    cast to float32: [m0, m1, m2, m3, m4, m5]."""
    m = np.asarray(matrix, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m1, m3 = -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - m1 * m[5]
    b2 = -m3 * m[2] - a22 * m[5]
    return np.array([a11, m1, b1, m3, a22, b2], _F32)


def warp_coords(matrix: np.ndarray, hw: Tuple[int, int], rows: Range = None,
                cols: Range = None):
    """float32 source coordinates (sx, sy) of the output pixels ``rows`` x
    ``cols`` of ``cv2.warpAffine(src, matrix, (w, h))``."""
    m = _inverse_f32(matrix)
    y = _span(rows, hw[0]).astype(_F32)[:, None]
    x = _span(cols, hw[1]).astype(_F32)[None, :]
    sx = _fma(m[0], x, m[1] * y + m[2])
    sy = _fma(m[3], x, m[4] * y + m[5])
    return sx, sy


def warp_source_box(matrix: np.ndarray, hw: Tuple[int, int], src_hw: Tuple[int, int],
                    rows: Range = None, cols: Range = None):
    """(y0, y1, x0, x1): the box of source pixels, inside the source frame,
    that the linear and the nearest warp of the output window read."""
    sx, sy = warp_coords(matrix, hw, rows, cols)

    def extent(s, n):
        lo, hi = np.floor(s.min()), np.floor(s.max()) + 2
        return int(min(max(lo, 0), n)), int(min(max(hi, 0), n))

    (y0, y1), (x0, x1) = extent(sy, src_hw[0]), extent(sx, src_hw[1])
    return y0, max(y0, y1), x0, max(x0, x1)


def _sampler(src, src_origin):
    """(flat source, rows, cols): ``flat[rows(iy) + cols(ix)]`` is the
    source pixel at frame coordinates (iy, ix), and 0 outside the frame.
    ``src`` is the window at ``src_origin`` of the source frame that holds
    every in-frame pixel read; a zero border around it takes every read
    outside the frame."""
    bh, bw = src.shape[:2]
    pad = np.zeros((bh + 2, bw + 2) + src.shape[2:], src.dtype)
    pad[1:-1, 1:-1] = src
    oy, ox = src_origin[0] - 1, src_origin[1] - 1

    def rows(iy):
        return np.clip(iy - oy, 0, bh + 1) * (bw + 2)

    def cols(ix):
        return np.clip(ix - ox, 0, bw + 1)

    return pad.reshape((-1,) + src.shape[2:]), rows, cols


def warp_affine_linear(src: np.ndarray, matrix: np.ndarray, hw: Tuple[int, int],
                       rows: Range = None, cols: Range = None,
                       src_origin=(0, 0)) -> np.ndarray:
    """``cv2.warpAffine(src, matrix, (w, h), flags=cv2.INTER_LINEAR)`` of a
    float32 image, restricted to output ``rows`` x ``cols``. ``src`` may be
    the window at ``src_origin`` of the source frame that holds every
    in-frame pixel the output reads (``warp_source_box``)."""
    flat, row_of, col_of = _sampler(np.asarray(src, _F32), src_origin)
    sx, sy = warp_coords(matrix, hw, rows, cols)
    fx0, fy0 = np.floor(sx), np.floor(sy)
    tail = (slice(None), slice(None)) + (None,) * (src.ndim - 2)
    ax, ay = (sx - fx0)[tail], (sy - fy0)[tail]
    r0, c0 = row_of(fy0.astype(np.int64)), col_of(fx0.astype(np.int64))
    r1, c1 = row_of(fy0.astype(np.int64) + 1), col_of(fx0.astype(np.int64) + 1)

    def at(r, c):
        return np.take(flat, r + c, axis=0)

    # plain float32 steps a + w * (b - a): OpenCV's own rounding is not
    # reproduced here (fused steps came no closer), so the cheaper form serves
    top, bottom = at(r0, c0), at(r1, c0)
    top_next, bottom_next = at(r0, c1), at(r1, c1)
    for near, far in ((top, top_next), (bottom, bottom_next)):
        far -= near
        far *= ax
        far += near
    bottom_next -= top_next
    bottom_next *= ay
    bottom_next += top_next
    return bottom_next


def warp_affine_nearest(src: np.ndarray, matrix: np.ndarray, hw: Tuple[int, int],
                        rows: Range = None, cols: Range = None,
                        src_origin=(0, 0)) -> np.ndarray:
    """``cv2.warpAffine(src, matrix, (w, h), flags=cv2.INTER_NEAREST)``,
    restricted to output ``rows`` x ``cols`` (window source as in
    ``warp_affine_linear``)."""
    flat, row_of, col_of = _sampler(src, src_origin)
    sx, sy = warp_coords(matrix, hw, rows, cols)
    return np.take(flat, row_of(np.rint(sy).astype(np.int64))
                   + col_of(np.rint(sx).astype(np.int64)), axis=0)


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(image, (ksize, ksize), sigmaX=sigma, sigmaY=sigma,
    borderType=cv2.BORDER_REFLECT_101)`` of a float32 HWC image, for the
    ksize 1 and 3 that ``rng.random()`` sigmas give."""
    if ksize == 1:
        return np.array(image, _F32)
    if ksize != 3:
        raise NotImplementedError(f"gaussian_blur: ksize {ksize} (1 or 3 only)")
    # getGaussianKernel(3, sigma, CV_32F): exp(-x^2 / (2 sigma^2)) at x = -1,
    # 0, 1 in double, normalised to sum 1, then rounded to float32
    edge = np.exp(-0.5 / (sigma * sigma))
    side, mid = _F32(edge / (2 * edge + 1)), _F32(1 / (2 * edge + 1))
    image = np.asarray(image, _F32)
    p = np.pad(image, ((0, 0), (1, 1)) + ((0, 0),) * (image.ndim - 2), mode="reflect")
    left, centre, right = p[:, :-2], p[:, 1:-1], p[:, 2:]
    rows = _fma(centre, mid, (left + right) * side)
    if image[0].size % 2:
        # OpenCV's row filter takes the last value of a row that holds an
        # odd count of values in the other order
        last = (slice(None), -1) + (-1,) * (image.ndim - 2)
        rows[last] = _fma(left[last] + right[last], side, centre[last] * mid)
    p = np.pad(rows, ((1, 1),) + ((0, 0),) * (image.ndim - 1), mode="reflect")
    return _fma(p[:-2] + p[2:], side, p[1:-1] * mid)

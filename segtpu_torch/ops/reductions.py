"""Argmax for the prediction paths.

Counterparts of ``segtpu/ops/reductions.py``. segtpu rewrites
``jnp.argmax`` for the TPU's vector unit in three ways, each the same
function where its inputs allow:

* ``fast_argmax``: two monoid reduces. On the GPU ``torch.argmax`` is that
  reduction already.
* ``packed_argmax``: one max over an int32 packing of a bfloat16 key and
  the reversed index. It rounds its input to bfloat16 first, so on float16
  or float32 logits it can pick another index than ``torch.argmax``; the
  port computes the same bits, since segtpu's seg stats take it on 16-bit
  logits (``metrics.py``).
* ``onehot_first_max``: the first maximum's one-hot with no index
  reduction (segtpu counts the maxima up to each class with a triangular
  matmul; here a cumulative sum counts them).
"""

from __future__ import annotations

import torch

#: the longest axis ``packed_argmax`` takes: its index field is 16 bits
PACKED_MAX_SIZE = 0x10000


def fast_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the maximum along ``dim``; the first one wins on ties, as in
    ``jnp.argmax``, for inputs that are not NaN."""
    return torch.argmax(x, dim=dim)


def packed_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """segtpu's ``packed_argmax`` along ``dim`` (int64 indices). ``x`` is
    rounded to bfloat16; its bits become a key that orders as the values do
    (negative: the bits inverted; non-negative: the sign bit set; -0.0 ties
    with +0.0), packed as ``(key - 0x8000) * 2**16 + (size - 1 - index)``,
    and one max over ``dim`` gives the largest key and, of its ties, the
    first index. Exact against ``torch.argmax`` for bfloat16 input; float16
    and float32 inputs are compared as their bfloat16 roundings. Assumes no
    NaN. An axis longer than 65536 raises: its indices would not fit the
    16-bit field (segtpu's returns wrong indices there)."""
    dim = dim % x.dim()
    size = x.shape[dim]
    if size > PACKED_MAX_SIZE:
        raise ValueError(f"packed_argmax: an axis of {size} does not fit its 16-bit "
                         f"index field (at most {PACKED_MAX_SIZE}); use fast_argmax")
    b = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    key = torch.where(b >= 0x8000, 0xFFFF - b, b + 0x8000)
    key = torch.where(b == 0x8000, 0x8000, key)  # -0.0 ties with +0.0
    shape = [1] * x.dim()
    shape[dim] = size
    iota = torch.arange(size, dtype=torch.int32, device=x.device).view(shape)
    packed = (key - 0x8000) * 0x10000 + (size - 1 - iota)
    return ((size - 1) - (packed.amax(dim=dim) & 0xFFFF)).long()


def onehot_first_max(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 one-hot along ``dim`` of the first maximum of ``x`` (the
    position of ``torch.argmax``), for inputs that are not NaN: the
    positions equal to the maximum whose running count of such positions
    is 1."""
    eq = x == x.amax(dim=dim, keepdim=True)
    return ((eq.cumsum(dim=dim) == 1) & eq).float()

"""Argmax for the prediction paths.

Counterpart of ``segtpu/ops/reductions.py::fast_argmax``, which rewrites
``jnp.argmax`` as two monoid reduces for the TPU's vector unit. On the GPU
``torch.argmax`` is that reduction already. segtpu's ``packed_argmax`` is not
ported: it rounds to bfloat16 and can pick another index (ROADMAP).
"""

from __future__ import annotations

import torch


def fast_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the maximum along ``dim``; the first one wins on ties, as in
    ``jnp.argmax``, for inputs that are not NaN."""
    return torch.argmax(x, dim=dim)

"""Threshold histograms for the binned Lovász-Softmax.

Counterpart of ``segtpu/ops/lovasz_hist.py``. For every class c and
descending error threshold ``t_k = 1 - k/bins`` (``err = |onehot(y) - p|``
on valid pixels, 0 elsewhere) the binned loss needs

    cum_fg[c,k]  = sum_p fg[p,c]  * (err[p,c] >= t_k)
    cum_all[c,k] = sum_p valid[p] * (err[p,c] >= t_k)
    cum_err[c,k] = sum_p err[p,c] * (err[p,c] >= t_k)

The indicator is a step in k: it holds from the first k whose threshold the
error reaches, ``kmin``, on. So each form finds ``kmin`` per (p, c), adds
fg, valid and err into bin ``kmin`` of a (C, bins) histogram and takes the
prefix sum over k; no (P, C, bins) array is made, which at a batch of 8
769x769 crops would hold 11.5e9 elements. The two forms differ in how they
find ``kmin``, as segtpu's do:

* :func:`histograms_compare` (the default) compares each error with the
  float32 thresholds ``1 - k/bins`` themselves, so every decision is the
  broadcast compare's;
* :func:`histograms_onehot` takes ``kmin = ceil((1 - err) * bins)``, which
  equals it except where rounding puts an error on the other side of a
  threshold.

The bin assignment is a constant under autodiff: gradients flow through the
summed errors only, as the exact form's sort permutation is a constant.
Plain PyTorch: segtpu has no kernel here.
"""

from __future__ import annotations

import torch


def _fg_valid_errors(probs, target, num_classes: int, ignore_index: int):
    tflat = target.reshape(-1).long()
    valid = (tflat != ignore_index) & (tflat >= 0) & (tflat < num_classes)
    dtype = probs.dtype if probs.dtype == torch.float64 else torch.float32
    safe = torch.where(valid, tflat, -1)
    classes = torch.arange(num_classes, device=probs.device)
    fg = (safe[:, None] == classes[None, :]).to(dtype)
    vmask = valid.to(dtype)
    errors = (fg - probs.to(dtype)).abs() * vmask[:, None]
    return fg, vmask, errors


def _prefix_histograms(kmin, fg, vmask, errors, bins: int):
    """(cum_fg, cum_all, cum_err), each (C, bins): fg, valid and err added
    into bin ``kmin`` (bins and above drop out), prefix-summed over k."""
    p, c = errors.shape
    kmin = kmin.clamp(max=bins)
    idx = (torch.arange(c, device=errors.device)[None, :] * (bins + 1) + kmin).reshape(-1)
    out = []
    for w in (fg, vmask[:, None].expand(p, c), errors):
        hist = torch.zeros(c * (bins + 1), dtype=errors.dtype, device=errors.device)
        hist = hist.index_add(0, idx, w.reshape(-1))
        out.append(hist.view(c, bins + 1)[:, :bins].cumsum(1))
    return tuple(out)


def histograms_compare(probs, target, bins: int = 128, ignore_index: int = 255):
    """(cum_fg, cum_all, cum_err), each (C, bins), from softmax
    probabilities (P, C) and integer labels (P,); ``err >= t_k`` decided
    against the float32 thresholds, as the broadcast compare does."""
    _, c = probs.shape
    fg, vmask, errors = _fg_valid_errors(probs, target, c, ignore_index)
    k = torch.arange(bins, dtype=torch.float32, device=probs.device)
    edges = (1.0 - k / bins).to(errors.dtype)
    # kmin = how many thresholds lie above the error (they descend in k)
    kmin = bins - torch.searchsorted(edges.flip(0), errors.detach().contiguous(),
                                     right=True)
    return _prefix_histograms(kmin, fg, vmask, errors, bins)


def histograms_onehot(probs, target, bins: int = 128, ignore_index: int = 255):
    """As :func:`histograms_compare`, with each error's first bin taken as
    ``ceil((1 - err) * bins)``. Invalid pixels have err 0 and land in bin
    ``bins``, which drops out."""
    _, c = probs.shape
    fg, vmask, errors = _fg_valid_errors(probs, target, c, ignore_index)
    kmin = torch.ceil((1.0 - errors.detach()) * bins).long()
    return _prefix_histograms(kmin, fg, vmask, errors, bins)

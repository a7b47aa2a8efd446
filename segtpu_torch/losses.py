"""Segmentation losses on NCHW logits.

Counterpart of ``segtpu/losses.py``: every name of its ``LOSSES`` registry
(cross-entropy, Dice, focal, CE + Dice, and the Lovász-Softmax in its exact
and binned forms), plus the binary Lovász hinge, the binary cross-entropy
and the median-frequency class weights. Logits are (B, C, H, W), labels
(B, H, W) integers with an ``ignore_index`` sentinel. Ignored pixels are
masked, never filtered, so shapes do not depend on the labels.

Each loss computes in at least float32 (bf16 logits are upcast, float64
stays float64) and returns a scalar of that dtype.

Under a process group each loss is segtpu's over the global batch, as
segtpu's losses are under its mesh: sums and denominators are summed over
the ranks (``core/mesh.py``: :func:`~segtpu_torch.core.mesh.global_sums`
carries the local terms' gradient, one collective a loss), the binned
Lovász's histograms too, and the exact Lovász sorts the errors of every
rank's pixels, gathered in rank order. Every rank then holds the same loss,
and the gradient of its own logits; the train step scales the loss by the
world size before ``backward``, so that the data-parallel wrap's mean of
the ranks' gradients is the gradient of the global loss. Outside a group
every helper is the identity.

With a model axis (``core/mesh.py``) the sums run over the ranks whose
pixels differ (:func:`~segtpu_torch.core.mesh.pixel_group`: the data group
under tensor parallelism, whose model ranks hold the same rows; the world
under spatial sharding), and a per-image loss first gathers each image's
rows over its model group, then averages the images over the data group.
"""

from __future__ import annotations

import numpy as np
import torch

from segtpu_torch.core import mesh
from segtpu_torch.ops.lovasz_hist import histograms_compare


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _image_mean(per_image: torch.Tensor) -> torch.Tensor:
    """The mean of per-image losses over the global batch's images."""
    if not mesh.initialized():
        return per_image.mean()
    total, count = mesh.global_sums(per_image.sum(), per_image.new_tensor(
        float(per_image.numel())), group=mesh.image_group())
    return total / count


def _sums(*terms):
    """``terms`` summed over the ranks whose pixels differ."""
    return mesh.global_sums(*terms, group=mesh.pixel_group())


def _all_pixels(t: torch.Tensor) -> torch.Tensor:
    """(..., P) -> (..., every rank's P): the pixels of the ranks whose
    pixels differ, in rank order (their counts may differ under spatial
    sharding)."""
    if mesh.spatial():
        return mesh.gather_cat(t, -1)
    g = mesh.gather_rows(t, mesh.pixel_group())
    return g.movedim(0, -2).flatten(-2)


def _image_pixels(t: torch.Tensor) -> torch.Tensor:
    """(B, ..., P) -> each image's pixels of every rank of its model group,
    under spatial sharding; ``t`` otherwise."""
    return mesh.gather_cat(t, -1, mesh.model_group()) if mesh.spatial() else t


def _valid_mask(target: torch.Tensor, num_classes: int, ignore_index: int):
    """True where the pixel takes part in the loss."""
    return (target != ignore_index) & (target >= 0) & (target < num_classes)


def _per_pixel_ce(lf, target, valid, weight=None):
    """(B, H, W) cross-entropy, zero at ignored pixels, and the per-pixel
    weight of the mean (the picked class weight, or 1, on valid pixels)."""
    safe = torch.where(valid, target.long(), torch.zeros_like(target, dtype=torch.long))
    picked = lf.gather(1, safe.unsqueeze(1)).squeeze(1)
    mask = valid.to(lf.dtype)
    ce = (torch.logsumexp(lf, dim=1) - picked) * mask
    if weight is None:
        return ce, mask
    w_pick = torch.as_tensor(weight, dtype=torch.float32).to(lf.device)[safe]
    return ce * w_pick, w_pick * mask


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = 255, weight=None) -> torch.Tensor:
    """Mean CE over the pixels whose label is in ``[0, C)`` and is not
    ``ignore_index``. With per-class ``weight`` the mean is torch's
    weighted mean (divided by the sum of the picked weights); the
    denominator is at least 1."""
    lf = _at_least_f32(logits)
    valid = _valid_mask(target, logits.shape[1], ignore_index)
    ce, w = _per_pixel_ce(lf, target, valid, weight)
    ce_sum, w_sum = _sums(ce.sum(), w.sum().detach())
    return ce_sum / w_sum.clamp(min=1.0)


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              ignore_index: int = 255, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice of the softmax against the one-hot labels, with ignored
    pixels left out of both the intersection and the sums."""
    lf = _at_least_f32(logits)
    valid = _valid_mask(target, logits.shape[1], ignore_index)
    mask = valid.to(lf.dtype)
    probs = torch.softmax(lf, dim=1)
    safe = torch.where(valid, target.long(), torch.zeros_like(target, dtype=torch.long))
    intersection = (probs.gather(1, safe.unsqueeze(1)).squeeze(1) * mask).sum()
    denom = (probs * mask.unsqueeze(1)).sum() + mask.sum()
    intersection, denom = _sums(intersection, denom)
    return 1.0 - (2.0 * intersection + smooth) / (denom + smooth)


def focal_loss(logits: torch.Tensor, target: torch.Tensor,
               ignore_index: int = 255, gamma: float = 2.0,
               alpha=None) -> torch.Tensor:
    """``(1 - p)^gamma * CE``, the mean taken over ALL pixels: ignored ones
    add zero to the sum and still count in the denominator, as segtpu's and
    the original's do."""
    lf = _at_least_f32(logits)
    valid = _valid_mask(target, logits.shape[1], ignore_index)
    ce, _ = _per_pixel_ce(lf, target, valid, alpha)
    pt = torch.exp(-ce)
    focal = (1.0 - pt) ** gamma * ce * valid.to(lf.dtype)
    if not mesh.initialized():
        return focal.mean()
    total, count = _sums(focal.sum(), lf.new_tensor(float(focal.numel())))
    return total / count


def ce_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                 ignore_index: int = 255, smooth: float = 1.0,
                 weight=None) -> torch.Tensor:
    """Cross-entropy plus Dice."""
    return (cross_entropy(logits, target, ignore_index, weight)
            + dice_loss(logits, target, ignore_index, smooth))


def _jaccard_increments(fg_sorted, valid_sorted):
    """The Lovász extension's gradient along each sorted row: the discrete
    derivative of the Jaccard loss of the prefix."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + ((1.0 - fg_sorted) * valid_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1), gts


def lovasz_softmax(logits: torch.Tensor, target: torch.Tensor,
                   ignore_index: int = 255, per_image: bool = False) -> torch.Tensor:
    """Exact Lovász-Softmax over the classes present in the labels.

    Each class's errors ``|fg - p|`` (zero at ignored pixels) are sorted in
    descending order, with the foreground and validity indicators carried
    along; the loss of a class is the sorted errors against the Jaccard
    increments, averaged over the present classes. The permutation is a
    constant under autodiff. ``per_image`` averages the loss of each image
    of the batch; otherwise the batch's pixels form one set.
    """
    b, c = logits.shape[:2]
    lf = _at_least_f32(logits)
    probs = torch.softmax(lf, dim=1).reshape(b, c, -1)
    valid = _valid_mask(target, c, ignore_index).reshape(b, 1, -1)
    safe = torch.where(valid, target.reshape(b, 1, -1).long(), -1)
    classes = torch.arange(c, device=logits.device).view(1, c, 1)
    fg = (safe == classes).to(lf.dtype)
    vmask = valid.to(lf.dtype).expand(b, c, -1)
    errors = (fg - probs).abs() * vmask
    if not per_image:
        errors, fg, vmask = (t.transpose(0, 1).reshape(1, c, -1)
                             for t in (errors, fg, vmask))
        if mesh.initialized():
            # every rank's pixels, in rank order: the global batch's columns
            errors, fg, vmask = _all_pixels(torch.stack([errors, fg, vmask.detach()]))
    elif mesh.initialized():
        errors, fg, vmask = _image_pixels(torch.stack([errors, fg, vmask.detach()]))
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_sorted, valid_sorted = fg.gather(-1, perm), vmask.gather(-1, perm)
    grad, gts = _jaccard_increments(fg_sorted, valid_sorted)
    per_class = (errors_sorted * grad * valid_sorted).sum(-1)
    present = (gts[..., 0] > 0).to(lf.dtype)
    per_set = (per_class * present).sum(-1) / present.sum(-1).clamp(min=1.0)
    return _image_mean(per_set) if per_image else per_set[0]


def lovasz_softmax_binned(logits: torch.Tensor, target: torch.Tensor,
                          ignore_index: int = 255, bins: int = 128) -> torch.Tensor:
    """Lovász-Softmax with the sort replaced by prefix statistics at
    ``bins`` descending error thresholds ``1 - k/bins``
    (:func:`segtpu_torch.ops.lovasz_hist.histograms_compare`): each bin's
    mean error against the Jaccard increment at its lower edge. Equal to the
    exact form when the pixels of a bin share one error; otherwise off by
    at most the bin width. The bin counts are constants under autodiff."""
    c = logits.shape[1]
    lf = _at_least_f32(logits)
    probs = torch.softmax(lf, dim=1).permute(0, 2, 3, 1).reshape(-1, c)
    tflat = target.reshape(-1).long()
    cum_fg, cum_all, cum_err = histograms_compare(probs, tflat, bins, ignore_index)
    valid = _valid_mask(tflat, c, ignore_index)
    gts = torch.bincount(torch.where(valid, tflat, c), minlength=c + 1)[:c].to(lf.dtype)
    # the global batch's histograms
    cum_fg, cum_all, cum_err, gts = _sums(cum_fg, cum_all, cum_err, gts)
    inter = gts[:, None] - cum_fg
    union = gts[:, None] + (cum_all - cum_fg)
    jacc = 1.0 - inter / union.clamp(min=1e-12)
    # J of the empty prefix is 0
    grad = jacc - torch.cat([torch.zeros_like(jacc[:, :1]), jacc[:, :-1]], 1)
    bin_err = cum_err - torch.cat([torch.zeros_like(cum_err[:, :1]), cum_err[:, :-1]], 1)
    bin_cnt = (cum_all - torch.cat([torch.zeros_like(cum_all[:, :1]),
                                    cum_all[:, :-1]], 1)).detach()
    mean_err = bin_err / bin_cnt.clamp(min=1.0)
    per_class = (mean_err * grad * (bin_cnt > 0)).sum(1)
    present = (gts > 0).to(lf.dtype)
    return (per_class * present).sum() / present.sum().clamp(min=1.0)


def lovasz_hinge(logits: torch.Tensor, target: torch.Tensor,
                 ignore_index: int = 255, per_image: bool = True) -> torch.Tensor:
    """Binary Lovász hinge. ``logits`` (B, H, W) real-valued, ``target``
    binary {0, 1} with an ignore sentinel. Ignored pixels sort last (error
    -inf) and add nothing."""
    b = logits.shape[0]
    lf = _at_least_f32(logits).reshape(b, -1)
    tg = target.reshape(b, -1)
    if not per_image:
        lf, tg = lf.reshape(1, -1), tg.reshape(1, -1)
        if mesh.initialized():  # every rank's pixels, in rank order
            lf, tg = _all_pixels(lf), _all_pixels(tg)
    elif mesh.initialized():
        lf, tg = _image_pixels(lf), _image_pixels(tg)
    valid = tg != ignore_index
    vmask = valid.to(lf.dtype)
    tgf = torch.where(valid, tg, torch.zeros_like(tg)).to(lf.dtype)
    errors = 1.0 - lf * (2.0 * tgf - 1.0)
    errors = torch.where(valid, errors, torch.full_like(errors, -torch.inf))
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    fg_sorted, valid_sorted = (tgf * vmask).gather(-1, perm), vmask.gather(-1, perm)
    grad, _ = _jaccard_increments(fg_sorted, valid_sorted)
    relu_err = torch.where(valid_sorted > 0, errors_sorted,
                           torch.zeros_like(errors_sorted)).clamp(min=0.0)
    per_set = (relu_err * grad * valid_sorted).sum(-1)
    return _image_mean(per_set) if per_image else per_set[0]


def binary_xloss(logits: torch.Tensor, target: torch.Tensor,
                 ignore_index: int = 255) -> torch.Tensor:
    """Numerically stable binary cross-entropy, averaged over the pixels
    that are not ``ignore_index``."""
    lf = _at_least_f32(logits).reshape(-1)
    tg = target.reshape(-1)
    valid = (tg != ignore_index).to(lf.dtype)
    tgf = torch.where(tg != ignore_index, tg, torch.zeros_like(tg)).to(lf.dtype)
    loss = lf.clamp(min=0.0) - lf * tgf + torch.log1p(torch.exp(-lf.abs()))
    total, count = _sums((loss * valid).sum(), valid.sum())
    return total / count.clamp(min=1.0)


def get_weights(target, num_classes: int) -> np.ndarray:
    """Median-frequency class weights from a label batch (numpy, on the
    host): ``median(counts) / count`` for the classes present, 1 for the
    others. Labels outside ``[0, num_classes)`` are left out."""
    t = np.asarray(target).reshape(-1)
    t = t[(t >= 0) & (t < num_classes)]
    classes, counts = np.unique(t, return_counts=True)
    weights = np.ones(num_classes, np.float32)
    weights[classes] = np.median(counts) / counts
    return weights


#: segtpu's config names. ``LovaszSoftmax`` is the exact form: segtpu
#: resolves it to the binned form on the TPU only, and always to the exact
#: form when ``per_image`` is set; ``LovaszSoftmaxFast`` names the binned one.
LOSSES = {
    "CrossEntropyLoss2d": cross_entropy,
    "DiceLoss": dice_loss,
    "FocalLoss": focal_loss,
    "CE_DiceLoss": ce_dice_loss,
    "LovaszSoftmax": lovasz_softmax,
    "LovaszSoftmaxExact": lovasz_softmax,
    "LovaszSoftmaxFast": lovasz_softmax_binned,
}


def get_loss(name: str):
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    return LOSSES[name]

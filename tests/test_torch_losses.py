"""The port's losses against segtpu's on the same seeded inputs, on the CPU:
every name of segtpu's ``LOSSES``, ``lovasz_hinge``, ``binary_xloss``,
``get_weights`` and both threshold-histogram forms, value and gradient with
respect to the logits.

float64 runs hold both sides to 1e-10 relative. segtpu casts the logits of
Dice, the Lovász losses and the binary losses to float32 itself, so its
float64 runs here see those casts made float64 (``_segtpu_float64``; nothing
in segtpu changes). float32 runs hold the two to 1e-5 relative: fp32 sums in
other orders.

The logits are continuous draws, so no two valid errors tie: the Lovász
losses' gradients depend on the order within ties.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segtpu import losses as seg_losses
from segtpu.ops import lovasz_hist as seg_hist
from segtpu_torch import losses
from segtpu_torch.ops import lovasz_hist
from torch_parity import rel_max

torch.set_num_threads(1)

B, C, H, W = 2, 5, 9, 11
TOL = {np.float64: 1e-10, np.float32: 1e-5}
DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` meaning ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _segtpu_float64():
    """segtpu's losses in float64: x64 on, and their float32 casts made
    float64."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(seg_losses, "jnp", _Float64Numpy())
        mp.setattr(seg_hist, "jnp", _Float64Numpy())
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", prev)


def _precision(dtype):
    return _segtpu_float64() if dtype == np.float64 else contextlib.nullcontext()


def _inputs(seed, ignore_index=255, classes=C, shape=(B, H, W)):
    """NHWC logits and labels with about a tenth of the pixels ignored."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 1.5, size=shape + (classes,))
    labels = rng.integers(0, classes, size=shape)
    labels[rng.random(shape) < 0.1] = ignore_index
    return logits, labels.astype(np.int32)


def _segtpu_value_grad(fn, logits, labels, dtype, **kw):
    with _precision(dtype):
        x = jnp.asarray(logits.astype(dtype))
        value, grad = jax.value_and_grad(
            lambda lg: fn(lg, jnp.asarray(labels), **kw))(x)
        return np.asarray(value), np.asarray(grad)


def _port_value_grad(fn, logits, labels, dtype, channel_axis=True, **kw):
    x = torch.from_numpy(logits.astype(dtype))
    if channel_axis:
        x = x.permute(0, 3, 1, 2)
    x = x.detach().requires_grad_()
    value = fn(x, torch.from_numpy(labels), **kw)
    value.backward()
    grad = x.grad.permute(0, 2, 3, 1) if channel_axis else x.grad
    return value.detach().numpy(), grad.numpy()


def _assert_match(port, want, dtype):
    tol = TOL[dtype]
    assert port[0].dtype == np.dtype(dtype)
    assert rel_max(port[0], want[0]) < tol, (port[0], want[0])
    assert rel_max(port[1], want[1]) < tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ignore_index", [255, -1])
@pytest.mark.parametrize("name", sorted(seg_losses.LOSSES))
def test_registry_loss_matches_segtpu(name, ignore_index, dtype):
    logits, labels = _inputs(sorted(seg_losses.LOSSES).index(name), ignore_index)
    kw = {"ignore_index": ignore_index}
    want = _segtpu_value_grad(seg_losses.get_loss(name), logits, labels, dtype, **kw)
    got = _port_value_grad(losses.get_loss(name), logits, labels, dtype, **kw)
    _assert_match(got, want, dtype)


def test_registry_has_segtpus_names():
    assert set(losses.LOSSES) == set(seg_losses.LOSSES)
    assert losses.get_loss("CrossEntropyLoss2d") is losses.cross_entropy
    # the port never runs on a TPU: the config name is the exact form
    assert losses.get_loss("LovaszSoftmax") is losses.lovasz_softmax
    with pytest.raises(KeyError, match="available"):
        losses.get_loss("NoSuchLoss")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["LovaszSoftmax", "LovaszSoftmaxExact"])
def test_lovasz_per_image_matches_segtpu(name, dtype):
    logits, labels = _inputs(20)
    labels[1, :4] = 255  # the images differ in their ignored share
    want = _segtpu_value_grad(seg_losses.get_loss(name), logits, labels, dtype,
                              per_image=True)
    got = _port_value_grad(losses.get_loss(name), logits, labels, dtype,
                           per_image=True)
    _assert_match(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,key", [("CrossEntropyLoss2d", "weight"),
                                      ("CE_DiceLoss", "weight"),
                                      ("FocalLoss", "alpha")])
def test_class_weights_match_segtpu(name, key, dtype):
    logits, labels = _inputs(30)
    weights = losses.get_weights(labels, C)
    assert not np.allclose(weights, 1.0)
    want = _segtpu_value_grad(seg_losses.get_loss(name), logits, labels, dtype,
                              **{key: weights})
    got = _port_value_grad(losses.get_loss(name), logits, labels, dtype,
                           **{key: weights})
    _assert_match(got, want, dtype)


def test_focal_divides_by_every_pixel():
    logits, labels = _inputs(31)
    x = torch.from_numpy(logits).permute(0, 3, 1, 2)
    t = torch.from_numpy(labels)
    all_ignored = torch.full_like(t, 255)
    assert float(losses.focal_loss(x, all_ignored)) == 0.0
    # half the pixels ignored: the mean over all pixels halves the valid mean
    half = t.clone()
    half[:, :, : W // 2 + 1] = 255
    valid = half != 255
    ce = (torch.logsumexp(x, 1) - x.gather(1, torch.where(valid, half, 0)
                                           .long().unsqueeze(1)).squeeze(1))
    pt = torch.exp(-ce)
    want = (((1 - pt) ** 2 * ce)[valid]).sum() / half.numel()
    assert float(losses.focal_loss(x, half)) == pytest.approx(float(want), rel=1e-12)


def test_dice_leaves_ignored_pixels_out():
    logits, labels = _inputs(32)
    x = torch.from_numpy(logits).permute(0, 3, 1, 2)
    t = torch.from_numpy(labels).long()
    keep = t != 255
    # the same pixels without the ignored ones, as one row of valid pixels
    xv = x.permute(0, 2, 3, 1)[keep].T.reshape(1, C, 1, -1)
    tv = t[keep].reshape(1, 1, -1)
    assert float(losses.dice_loss(x, t)) == pytest.approx(
        float(losses.dice_loss(xv, tv)), rel=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("per_image", [True, False])
def test_lovasz_hinge_matches_segtpu(per_image, dtype):
    rng = np.random.default_rng(40)
    logits = rng.normal(size=(B, H, W))
    labels = rng.integers(0, 2, size=(B, H, W)).astype(np.int32)
    labels[rng.random((B, H, W)) < 0.1] = 255
    want = _segtpu_value_grad(seg_losses.lovasz_hinge, logits, labels, dtype,
                              per_image=per_image)
    got = _port_value_grad(losses.lovasz_hinge, logits, labels, dtype,
                           channel_axis=False, per_image=per_image)
    _assert_match(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_binary_xloss_matches_segtpu(dtype):
    rng = np.random.default_rng(41)
    logits = rng.normal(0.0, 4.0, size=(B, H, W))
    labels = rng.integers(0, 2, size=(B, H, W)).astype(np.int32)
    labels[rng.random((B, H, W)) < 0.1] = 255
    want = _segtpu_value_grad(seg_losses.binary_xloss, logits, labels, dtype)
    got = _port_value_grad(losses.binary_xloss, logits, labels, dtype,
                           channel_axis=False)
    _assert_match(got, want, dtype)


def test_get_weights_matches_segtpu():
    rng = np.random.default_rng(42)
    labels = rng.choice([0, 0, 0, 1, 3, 3, 255, -1], size=(4, 13, 13))
    got = losses.get_weights(labels, 5)
    want = seg_losses.get_weights(labels, 5)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[2] == got[4] == 1.0  # absent classes


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("form", ["histograms_compare", "histograms_onehot"])
def test_histograms_match_segtpu(form, dtype):
    """Both forms' three prefix histograms, and their vector-Jacobian
    product with a seeded cotangent."""
    rng = np.random.default_rng(50)
    logits, labels = _inputs(51, classes=C, shape=(3, 8, 8))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.reshape(-1, C)
    tflat = labels.reshape(-1)
    bins = 16
    cot = [rng.normal(size=(C, bins)) for _ in range(3)]
    with _precision(dtype):
        fn = getattr(seg_hist, form)
        p = jnp.asarray(probs.astype(dtype))
        want, vjp = jax.vjp(lambda q: fn(q, jnp.asarray(tflat), bins), p)
        want_grad = vjp(tuple(jnp.asarray(c.astype(dtype)) for c in cot))[0]
        want = [np.asarray(w) for w in want]
        want_grad = np.asarray(want_grad)
    q = torch.from_numpy(probs.astype(dtype)).requires_grad_()
    got = getattr(lovasz_hist, form)(q, torch.from_numpy(tflat), bins)
    sum(torch.sum(g * torch.from_numpy(c.astype(dtype))) for g, c in zip(got, cot)).backward()
    for g, w in zip(got, want):
        assert g.shape == (C, bins)
        assert rel_max(g.detach().numpy(), w) < TOL[dtype]
    assert rel_max(q.grad.numpy(), want_grad) < TOL[dtype]


def test_histogram_forms_agree_and_never_build_the_indicator():
    logits, labels = _inputs(52, shape=(2, 16, 16))
    probs = torch.softmax(torch.from_numpy(logits), -1).reshape(-1, C).float()
    t = torch.from_numpy(labels).reshape(-1)
    a = lovasz_hist.histograms_compare(probs, t, 128)
    b = lovasz_hist.histograms_onehot(probs, t, 128)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-5)
    # the cumulative counts end at the class's pixels with an error of at
    # least 1/bins, and never decrease
    assert bool((a[1][:, 1:] >= a[1][:, :-1]).all())
    assert float(a[1][:, -1].max()) <= int((t != 255).sum())


def test_binned_lovasz_is_within_a_bin_of_the_exact():
    logits, labels = _inputs(53, shape=(2, 24, 24))
    x = torch.from_numpy(logits).permute(0, 3, 1, 2)
    t = torch.from_numpy(labels)
    exact = float(losses.lovasz_softmax(x, t))
    for bins in (64, 256):
        binned = float(losses.lovasz_softmax_binned(x, t, bins=bins))
        assert abs(binned - exact) <= 1.0 / bins

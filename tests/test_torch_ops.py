"""The port's ops, loss, metrics, schedule and optimizer against segtpu's, on
the CPU in fp32. Inputs come from numpy and go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from segtpu import losses as seg_losses
from segtpu import metrics as seg_metrics
from segtpu import schedules as seg_schedules
from segtpu.backbones import resnet as seg_resnet
from segtpu.core import state as seg_state
from segtpu.nn import layers as seg_layers
from segtpu.ops import pixelshuffle as seg_pixelshuffle
from segtpu.ops import pooling as seg_pooling
from segtpu.ops import resize as seg_resize
from segtpu_torch import losses, metrics, schedules
from segtpu_torch.backbones import resnet
from segtpu_torch.core.state import TrainState, make_optimizer, partition_labels
from segtpu_torch.nn import layers
from segtpu_torch.ops import pooling, resize
from torch_parity import nchw, nhwc

torch.set_num_threads(1)

# fp32 with the same arithmetic up to summation order: rtol 1e-5, and an
# atol of 1e-6 for values near zero (inputs are of order 1)
RTOL, ATOL = 1e-5, 1e-6
# resize: segtpu rounds fp64 interpolation weights to fp32, torch computes
# them in fp32; a few fp32 ulps of an O(1) value near zero
RESIZE_ATOL = 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((5, 7), (33, 33)), ((9, 9), (65, 40)),
                                     ((33, 17), (8, 8)), ((6, 6), (6, 13))])
def test_resize_bilinear_matches_segtpu(src, dst, align_corners):
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(seg_resize.resize_bilinear(jnp.asarray(x), dst,
                                                 align_corners=align_corners))
    got = nhwc(resize.resize_bilinear(nchw(x), dst, align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RESIZE_ATOL)


@pytest.mark.parametrize("shape", [(2, 17, 17, 4), (1, 33, 20, 3), (2, 8, 9, 2)])
def test_max_pool_matches_segtpu(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(seg_pooling.max_pool(jnp.asarray(x), 3, 2, padding=1))
    got = nhwc(pooling.max_pool(nchw(x), 3, 2, padding=1))
    np.testing.assert_array_equal(got, want)  # a max is exact


@pytest.mark.parametrize("hw", [(9, 9), (13, 7), (5, 5), (17, 11)])
def test_adaptive_avg_pool_multi_matches_segtpu(hw):
    """Includes bins that do not divide the size and bins larger than it."""
    x = np.random.default_rng(2).normal(size=(2, *hw, 6)).astype(np.float32)
    sizes = (1, 2, 3, 6)
    want = seg_pooling.adaptive_avg_pool_multi(jnp.asarray(x), sizes)
    got = pooling.adaptive_avg_pool_multi(nchw(x), sizes)
    for w_, g_ in zip(want, got):
        np.testing.assert_allclose(nhwc(g_), np.asarray(w_), rtol=RTOL, atol=ATOL)


_PLANS = [("encoding", 8, False, None), ("encoding", 8, True, None),
          ("torchvision", 8, False, None), ("torchvision", 16, False, None),
          ("torchvision", 32, False, None), ("torchvision", 32, False, "rf"),
          ("torchvision", 32, False, "bigger")]


@pytest.mark.parametrize("arch", sorted(seg_resnet.RESNET_LAYERS))
@pytest.mark.parametrize("style,output_stride,multi_grid,hdc", _PLANS)
def test_layer_plan_matches_segtpu(arch, style, output_stride, multi_grid, hdc):
    assert resnet.RESNET_LAYERS[arch] == seg_resnet.RESNET_LAYERS[arch]
    args = (arch, style, output_stride, multi_grid, hdc)
    assert resnet._layer_plan(*args) == seg_resnet._layer_plan(*args)


def _labels(rng, shape, num_classes):
    lbl = rng.integers(0, num_classes, size=shape).astype(np.int32)
    lbl[:, :3, :3] = 255   # ignore index
    lbl[:, -2:, :] = -100  # loader padding, also outside [0, C)
    return lbl


def test_cross_entropy_matches_segtpu():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, 11, 5)).astype(np.float32) * 3
    lbl = _labels(rng, (2, 9, 11), 5)
    want = float(seg_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(lbl),
                                          ignore_index=255))
    got = float(losses.cross_entropy(nchw(logits), torch.from_numpy(lbl),
                                     ignore_index=255))
    assert got == pytest.approx(want, rel=1e-6)  # one fp32 mean
    assert losses.get_loss("CrossEntropyLoss2d") is losses.cross_entropy


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(1, 3, 4, 4)
    assert float(losses.cross_entropy(logits, torch.full((1, 4, 4), 255))) == 0.0


@pytest.mark.parametrize("num_classes", [2, 5])
def test_seg_stats_from_logits_matches_segtpu(num_classes):
    """Exact: integer counts in fp32, first-max argmax on both sides (ties
    are made on purpose)."""
    rng = np.random.default_rng(4)
    logits = rng.integers(-2, 3, size=(2, 13, 7, num_classes)).astype(np.float32)
    lbl = _labels(rng, (2, 13, 7), num_classes)
    want = seg_metrics.seg_stats_from_logits(jnp.asarray(logits), jnp.asarray(lbl))
    got = metrics.seg_stats_from_logits(nchw(logits), torch.from_numpy(lbl))
    for w_, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    s_want, s_got = seg_metrics.summarize(want), metrics.summarize(got + got)
    assert s_got["Mean_IoU"] == s_want["Mean_IoU"]
    assert s_got["Pixel_Accuracy"] == s_want["Pixel_Accuracy"]


def test_average_meter():
    m = metrics.AverageMeter()
    m.update(2.0, 3)
    m.update(4.0, 1)
    assert m.average == pytest.approx(2.5) and m.val == 4.0


@pytest.mark.parametrize("warmup", [0, 1])
def test_poly_matches_segtpu(warmup):
    args = (0.01, 3, 7, warmup)
    want, got = seg_schedules.poly(*args), schedules.poly(*args)
    for t in range(3 * 7 + 2):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-6, abs=1e-12)
    assert schedules.get_schedule("Poly") is schedules.poly


class _Tiny(torch.nn.Module):
    backbone_modules = ("layer1",)

    def __init__(self):
        super().__init__()
        self.layer1 = torch.nn.Linear(3, 4)
        self.head = torch.nn.Linear(4, 2)


def test_sgd_two_groups_match_segtpu_optax():
    """Five SGD updates (momentum 0.9, wd 1e-4, Poly, backbone at lr/10) on
    one gradient stream. Tolerance 1e-6 relative: fp32 on both sides."""
    rng = np.random.default_rng(5)
    model = _Tiny()
    assert partition_labels(model) == {"layer1.weight": "backbone",
                                       "layer1.bias": "backbone",
                                       "head.weight": "decoder",
                                       "head.bias": "decoder"}
    opt, scheds = make_optimizer(model, lr=0.05, num_epochs=1, iters_per_epoch=6)
    state = TrainState(model, opt, scheds)
    tx = seg_state.make_optimizer(lr=0.05, num_epochs=1, iters_per_epoch=6)
    names = [n for n, _ in model.named_parameters()]

    def tree(values):
        return {"backbone": {n: values[n] for n in names if n.startswith("layer1")},
                "head": {n: values[n] for n in names if n.startswith("head")}}

    # copies: jnp.asarray may alias a numpy buffer that torch updates in place
    params = tree({n: jnp.array(p.detach().numpy(), copy=True)
                   for n, p in model.named_parameters()})
    opt_state = tx.init(params)
    for _ in range(5):
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        state.apply_gradients()
        updates, opt_state = tx.update(
            tree({n: jnp.asarray(g) for n, g in grads.items()}), opt_state, params)
        params = optax.apply_updates(params, updates)
    for n, p in model.named_parameters():
        group = "backbone" if n.startswith("layer1") else "head"
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[group][n]),
                                   rtol=1e-6, atol=1e-7)
    assert state.step == 5
    assert state.current_lrs() == pytest.approx([scheds[0](4), scheds[0](4) * 0.1])


@pytest.mark.parametrize("factor,shape", [(2, (2, 5, 7, 12)), (4, (1, 3, 4, 32))])
def test_pixel_shuffle_matches_segtpu(factor, shape):
    """segtpu's NHWC channel order (c, rh, rw) is torch's NCHW one, so the
    port's ``DUC`` calls ``F.pixel_shuffle``."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(seg_pixelshuffle.pixel_shuffle(jnp.asarray(x), factor))
    got = nhwc(F.pixel_shuffle(nchw(x), factor))
    np.testing.assert_array_equal(got, want)  # a permutation is exact


@pytest.mark.parametrize("shape", [(2, 33, 17, 3), (1, 8, 9, 2), (2, 5, 5, 4)])
def test_max_pool_ceil_mode_matches_segtpu(shape):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(seg_pooling.max_pool(jnp.asarray(x), 2, ceil_mode=True))
    got = nhwc(pooling.max_pool(nchw(x), 2, ceil_mode=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (4, 2, 1)])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
@pytest.mark.parametrize("bias", [True, False])
def test_conv_transpose_matches_segtpu(k, s, p, hw, bias):
    """The port's (in, out, k, k) weight is segtpu's HWIO kernel transposed
    by (2, 3, 0, 1), with no flip: an asymmetric kernel tells the two
    apart."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    mod = seg_layers.ConvTranspose(3, k, s, p, use_bias=bias)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    conv = layers.conv_transpose2d(5, 3, k, s, p, bias=bias)
    kernel = np.array(variables["params"]["kernel"])
    assert not np.array_equal(kernel, kernel[::-1, ::-1])
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
        got = nhwc(conv(nchw(x)))
    assert got.shape == want.shape == (2, (hw[0] - 1) * s - 2 * p + k,
                                       (hw[1] - 1) * s - 2 * p + k, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_conv_transpose_init_draws_segtpus_fan_in():
    """Weight U(+-1/sqrt(k*k*in)) and bias U(+-1/sqrt(k*k*out)), segtpu's
    bounds (torch's own default weight bound reads k*k*out)."""
    conv = layers.conv_transpose2d(64, 4, 2, 2)
    layers.init_parameters(conv, torch.Generator().manual_seed(0))
    w_bound, b_bound = 1 / np.sqrt(2 * 2 * 64), 1 / np.sqrt(2 * 2 * 4)
    assert 0.95 * w_bound < conv.weight.abs().max().item() <= w_bound
    assert conv.bias.abs().max().item() <= b_bound
    seg = seg_layers.ConvTranspose(4, 2, 2).init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 3, 3, 64)))["params"]
    assert 0.95 * w_bound < float(jnp.abs(seg["kernel"]).max()) <= w_bound
    assert float(jnp.abs(seg["bias"]).max()) <= b_bound


def _tied(rng, shape):
    """Integer values and ReLU zeros: windows with tied maxima."""
    return np.maximum(rng.integers(-3, 3, size=shape), 0).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 9, 7, 3), (1, 8, 8, 2), (2, 33, 33, 4)])
def test_max_pool_argmax_and_unpool_match_segtpu(shape):
    """Pooled values, the unpooled plane, and the window position each
    index names (segtpu's int8 position inside the 2x2 window): the first
    row-major tap wins ties on both."""
    x = _tied(np.random.default_rng(7), shape)
    pooled_w, idx_w = seg_pooling.max_pool_argmax(jnp.asarray(x))
    pooled, idx = pooling.max_pool_argmax(nchw(x))
    np.testing.assert_array_equal(nhwc(pooled), np.asarray(pooled_w))
    w = shape[2]
    pos = (idx // w % 2) * 2 + idx % w % 2
    np.testing.assert_array_equal(pos.numpy().transpose(0, 2, 3, 1), np.asarray(idx_w))
    ties = (x[:, :shape[1] // 2 * 2:2, :shape[2] // 2 * 2:2] ==
            x[:, 1:shape[1] // 2 * 2:2, 1:shape[2] // 2 * 2:2]).sum()
    assert ties > 0
    y = np.random.default_rng(8).normal(size=np.asarray(pooled_w).shape).astype(np.float32)
    want = np.asarray(seg_pooling.max_unpool(jnp.asarray(y), idx_w, output_size=shape[1:3]))
    got = nhwc(pooling.max_unpool(nchw(y), idx, shape[1:3]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 33, 33, 3), (1, 36, 36, 2), (2, 17, 12, 3)])
def test_max_pool_argmax_flat_matches_segtpu(shape):
    x = _tied(np.random.default_rng(9), shape)
    pooled_w, idx_w = seg_pooling.max_pool_argmax_flat(jnp.asarray(x))
    pooled, idx = pooling.max_pool_argmax_flat(nchw(x))
    np.testing.assert_array_equal(nhwc(pooled), np.asarray(pooled_w))
    np.testing.assert_array_equal(idx.numpy().transpose(0, 2, 3, 1), np.asarray(idx_w))


@pytest.mark.parametrize("shape", [(2, 33, 33, 3), (1, 36, 36, 2), (2, 17, 12, 3)])
def test_max_unpool_flat_matches_segtpu_where_indices_repeat(shape):
    """Overlapping 3x3/2 windows pick one position several times; the values
    put back there (the decoder's, not the pooled maxima) differ, and the
    highest row-major pooled pixel's wins. Backward: every pooled pixel
    reads the cotangent at its index, as segtpu's custom VJP."""
    rng = np.random.default_rng(10)
    x = _tied(rng, shape)
    _, idx_w = seg_pooling.max_pool_argmax_flat(jnp.asarray(x))
    _, idx = pooling.max_pool_argmax_flat(nchw(x))
    b, ho, wo, c = np.asarray(idx_w).shape
    flat = np.asarray(idx_w).transpose(0, 3, 1, 2).reshape(b * c, ho * wo)
    repeats = sum(ho * wo - len(np.unique(row)) for row in flat)
    assert repeats > 0
    out_hw = (2 * ho, 2 * wo)
    y = rng.normal(size=(b, ho, wo, c)).astype(np.float32)
    g = rng.normal(size=(b, *out_hw, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: seg_pooling.max_unpool_flat(
        v, idx_w, out_hw, input_hw=shape[1:3]), jnp.asarray(y))
    (want_gy,) = vjp(jnp.asarray(g))
    yt = nchw(y).requires_grad_()
    got = pooling.max_unpool_flat(yt, idx, out_hw)
    got.backward(nchw(g))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(nhwc(yt.grad), np.asarray(want_gy))

"""The stem weight-gradient module of the port: its plain version against
segtpu's Pallas kernel (interpret mode) and its autograd Function against
autograd through a plain conv. Its CUDA kernel is held against the plain
version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu.ops import conv_wgrad as seg_cw
from segtpu_torch.backbones.resnet import ResNetFeatures
from segtpu_torch.ops import conv_wgrad as cw
from torch_parity import rel_max

torch.set_num_threads(1)

# the shapes of tests/test_conv_wgrad.py: n, h, w, c, co, k
SHAPES = [
    (2, 65, 65, 3, 64, 7),
    (1, 32, 48, 3, 16, 7),
    (2, 64, 64, 4, 32, 7),
    (2, 65, 65, 3, 64, 3),
    (2, 33, 47, 5, 16, 3),
    # shapes the card kernel once refused: C >= 6 at k = 7, CO = 48, CO = 19
    (1, 33, 33, 6, 64, 7),
    (1, 33, 33, 3, 48, 3),
    (2, 33, 47, 5, 19, 3),
]
# segtpu's own kernel tolerance: bf16-rounded inputs, fp32 sums in other orders
REL_TOL = 5e-3


def _inputs(shape):
    n, h, w, c, co, k = shape
    ho = (h + 2 * (k // 2) - k) // 2 + 1
    wo = (w + 2 * (k // 2) - k) // 2 + 1
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    dy = rng.normal(size=(n, ho, wo, co)).astype(np.float32)
    return x, dy, k


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_segtpu_pallas_kernel(shape):
    x, dy, k = _inputs(shape)
    want = np.asarray(seg_cw.stem_conv_wgrad(jnp.asarray(x), jnp.asarray(dy),
                                             kernel=k, interpret=True))
    got = cw.stem_conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy), k)
    assert got.shape == (k, k, shape[3], shape[4]) and got.dtype == torch.float32
    assert rel_max(got.numpy(), want) < REL_TOL


def _out(size, k):
    return (size + 2 * (k // 2) - k) // 2 + 1


@pytest.mark.parametrize("shape", [
    (8, 769, 769, 3, 64, 3), (1, 33, 33, 6, 64, 7), (1, 33, 33, 3, 48, 3),
    (2, 33, 47, 5, 19, 3), (1, 17, 17, 64, 64, 7), (1, 9, 9, 3, 600, 3)])
def test_stem_plan_covers_every_tap_and_o_once_and_bounds_the_partials(shape):
    """Walk the grid as the kernel does: every (kh, kw, c, o) of dW is owned
    by exactly one tap group and o tile, every pixel tile by one row block;
    each box fits its warps' n8 tiles, the ring fits a block's share of an
    SM, the grid is one wave, and the partial buffer stays under its cap
    (or is not used)."""
    n, h, w, c, co, k = shape
    ho, wo = _out(h, k), _out(w, k)
    plan = cw.stem_wgrad_plan(n, ho, wo, c, co, k, sms=132, per_sm=4)
    assert 1 <= plan.nt <= cw.MAX_NT
    assert plan.o_tiles * cw.TILE_O >= co > (plan.o_tiles - 1) * cw.TILE_O
    gh, gw, gc = -(-k // plan.kr), -(-k // plan.kc), -(-c // plan.cs)
    assert plan.tap_groups == gh * gw * gc
    owned = np.zeros((k, k, c, co), np.int64)
    for grp in range(plan.tap_groups):
        kh0 = grp // (gw * gc) * plan.kr
        kw0 = grp // gc % gw * plan.kc
        c0 = grp % gc * plan.cs
        box = (min(plan.kr, k - kh0), min(plan.kc, k - kw0), min(plan.cs, c - c0))
        assert np.prod(box) <= 8 * cw.WARPS * plan.nt
        for o_tile in range(plan.o_tiles):
            o0 = o_tile * cw.TILE_O
            owned[kh0:kh0 + box[0], kw0:kw0 + box[1], c0:c0 + box[2],
                  o0:o0 + cw.TILE_O] += 1
    assert (owned == 1).all()
    assert 2 <= plan.stages <= cw.MAX_STAGES
    smem = cw.smem_bytes(c, plan.kr, plan.kc, plan.cs, plan.span, plan.stages)
    assert 4 * (smem + 1024) <= cw.SMEM_PER_SM
    # the box fits a ring of MIN_STAGES slots in a two-block share
    ring = cw.smem_bytes(c, plan.kr, plan.kc, plan.cs, plan.span, cw.MIN_STAGES)
    assert ring <= cw.SMEM_TARGET <= cw.SMEM_LIMIT
    tiles = n * ho * -(-wo // cw.TILE_P)
    walked = [t for rb in range(plan.row_blocks)
              for t in range(rb * tiles // plan.row_blocks,
                             (rb + 1) * tiles // plan.row_blocks)]
    assert walked == list(range(tiles))
    assert plan.row_blocks == 1 or (
        plan.row_blocks * plan.tap_groups * plan.o_tiles <= 132 * 4
        and plan.row_blocks * k * k * c * co <= cw.MAX_PARTIAL_FLOATS)
    if shape == (8, 769, 769, 3, 64, 3):
        # the main path: one box of all 27 taps (one n8 tile a warp), whole-C
        # spans, four blocks an SM, each with a ring of five 10.6 KB slots
        assert plan == (1, 3, 3, 3, True, 5, 1, 1, 528)
        assert smem == 53984


@pytest.mark.parametrize("shape", SHAPES + [(1, 9, 9, 3, 600, 3)])
def test_stem_wgrad_tiling_matches_plain(shape):
    """The kernel's walk of its plan (pixel tiles, tap groups, o tiles, the
    padding of taps and of CO, the fixed-order sum of the partials), in
    float32 on bf16-rounded inputs, is the plain version up to the order of
    fp32 sums."""
    x, dy, k = _inputs(shape)
    n, h, w, c, co, _ = shape
    plan = cw.stem_wgrad_plan(n, _out(h, k), _out(w, k), c, co, k, sms=132, per_sm=4)
    got = cw.stem_wgrad_tiling(torch.from_numpy(x), torch.from_numpy(dy), k, plan)
    want = cw.stem_conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy), k)
    assert got.shape == want.shape
    assert rel_max(got.numpy(), want.numpy()) <= 1e-5


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x, dy, k = _inputs(SHAPES[3])
    before = cw.stem_conv_wgrad.launches
    got = cw.stem_conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy), kernel=k)
    want = cw.stem_conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy), k)
    assert torch.equal(got, want)
    assert cw.stem_conv_wgrad.launches == before


@pytest.mark.parametrize("bad", ["even_k", "dy_shape", "int_dtype", "ndim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 9, 9, 3)
    dy = torch.zeros(1, 5, 5, 8)
    k = 3
    if bad == "even_k":
        k = 4
    elif bad == "dy_shape":
        dy = torch.zeros(1, 4, 5, 8)
    elif bad == "int_dtype":
        x = x.long()
    else:
        x = x[0]
    with pytest.raises((ValueError, TypeError)):
        cw.stem_conv_wgrad(x, dy, kernel=k)


@pytest.mark.parametrize("k", [3, 7])
def test_stem_conv_weight_grad_matches_plain_conv_autograd(k):
    """Port of test_custom_vjp_weight_grad: the gradient through StemConv
    equals autograd through F.conv2d, within the bf16 tolerance."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 3, 33, 33)).astype(np.float32))
    w0 = rng.normal(size=(8, 3, k, k)).astype(np.float32) * 0.1
    w_k = torch.tensor(w0, requires_grad=True)
    w_r = torch.tensor(w0, requires_grad=True)
    torch.tanh(cw.StemConv.apply(x, w_k, k)).sum().backward()
    torch.tanh(F.conv2d(x, w_r, stride=2, padding=k // 2)).sum().backward()
    assert w_k.grad.dtype == torch.float32
    assert rel_max(w_k.grad.numpy(), w_r.grad.numpy()) < REL_TOL


def test_stem_conv_input_grad_is_zero_or_none():
    """segtpu's VJP returns a zero input cotangent (valid at the model input
    only); the port returns zeros when asked and None otherwise."""
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    x = torch.randn(1, 3, 9, 9, requires_grad=True)
    cw.StemConv.apply(x, w, 3).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    x2 = torch.randn(1, 3, 9, 9)
    y = cw.StemConv.apply(x2, w, 3)
    grads = torch.autograd.grad(y.sum(), [w])
    assert grads[0].shape == w.shape


def _stem_conv(feats):
    first = feats.initial[0]
    return first[0] if isinstance(first, torch.nn.Sequential) else first


@pytest.mark.parametrize("arch,style,k", [("resnet50", "encoding", 3),
                                          ("resnet18", "encoding", 7),
                                          ("resnet18", "torchvision", 7)])
def test_backbone_flag_always_routes_the_stem_through_the_kernel(arch, style, k):
    """pallas_stem_wgrad=True makes the stem's first conv a StemConv2d (k x k,
    stride 2) in every style; off, it is a plain stride-2 conv."""
    on = ResNetFeatures(arch=arch, style=style, pallas_stem_wgrad=True)
    off = ResNetFeatures(arch=arch, style=style, pallas_stem_wgrad=False)
    assert isinstance(_stem_conv(on), cw.StemConv2d)
    assert _stem_conv(on).kernel_size == k
    assert isinstance(_stem_conv(off), torch.nn.Conv2d)
    assert _stem_conv(off).stride == (2, 2)
    assert on.state_dict().keys() == off.state_dict().keys()


@pytest.mark.parametrize("style", ["encoding", "torchvision"])
def test_backbone_stem_grad_flag_on_matches_flag_off(style):
    """A ResNet-18 backbone's stem weight gradient with the flag on equals the
    flag-off (library conv) gradient from the same weights, within the bf16
    kernel tolerance: the flag only rounds x and dy to bf16."""
    torch.manual_seed(0)
    on = ResNetFeatures(arch="resnet18", style=style, pallas_stem_wgrad=True)
    off = ResNetFeatures(arch="resnet18", style=style, pallas_stem_wgrad=False)
    off.load_state_dict(on.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 33, 33)).astype(np.float32))
    grads = []
    for feats in (on, off):
        feats.train()
        feats(x)[-1].square().mean().backward()
        grads.append(_stem_conv(feats).weight.grad.numpy())
    assert rel_max(*grads) < REL_TOL

"""The flat-row conv backward module of the port: its plain versions against
segtpu's Pallas kernels (interpret mode), its wrappers on the CPU and on bad
input, and its autograd Function against segtpu's custom VJP and against
autograd through ``F.conv2d``. Its CUDA kernels are held against the plain
versions on the card in tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu.ops import flatconv as seg_fc
from segtpu_torch.ops import flatconv as fc
from torch_parity import rel_max

torch.set_num_threads(1)

# the cases of tests/test_flatconv.py: (n, h, w, c, o, k, p, d)
CASES = [
    (2, 33, 33, 64, 64, 3, 1, 1),    # stem_conv2-like
    (2, 33, 33, 64, 128, 3, 1, 1),   # stem_conv3-like
    (1, 25, 25, 512, 19, 3, 1, 1),   # classifier-like
    (2, 17, 29, 8, 16, 3, 1, 1),     # non-square, ragged tiles
    (2, 21, 21, 32, 48, 1, 0, 1),    # 1x1: no halo
    (1, 27, 27, 16, 24, 3, 2, 2),    # dilation 2
    (3, 15, 15, 24, 8, 5, 2, 1),     # 5x5, three images
]
# wgrad: segtpu's own tolerance; both sides sum bf16-rounded products in
# fp32, in other orders
WGRAD_TOL = 5e-3
# dgrad: both sides round their fp32 sums to bf16, so an element may land one
# bf16 ulp apart; one ulp of a value is at most 2**-7 of it, hence of the
# largest value (held with <=)
DGRAD_TOL = 2.0 ** -7
# autograd through the kernels against an fp32 conv: segtpu's 2e-2, the
# bf16 rounding of x, dy and w
GRAD_TOL = 2e-2


def _inputs(case, seed):
    n, h, w, c, o, k, p, d = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    dy = rng.normal(size=(n, h, w, o)).astype(np.float32)
    wk = (rng.normal(size=(k, k, c, o)) * 0.1).astype(np.float32)
    return x, dy, wk


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_wgrad_matches_segtpu_pallas_kernel(i):
    n, h, w, c, o, k, p, d = CASES[i]
    x, dy, _ = _inputs(CASES[i], i)
    want = np.asarray(seg_fc.flat_conv_wgrad(
        jnp.asarray(x), jnp.asarray(dy), kernel_hw=(k, k), padding=p,
        dilation=d, interpret=True))
    got = fc.flat_conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                   (k, k), p, d)
    assert got.shape == (k, k, c, o) and got.dtype == torch.float32
    assert rel_max(got.numpy(), want) < WGRAD_TOL


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_dgrad_matches_segtpu_pallas_kernel(i):
    n, h, w, c, o, k, p, d = CASES[i]
    _, dy, wk = _inputs(CASES[i], i)
    want = np.asarray(seg_fc.flat_conv_dgrad(
        jnp.asarray(dy), jnp.asarray(wk), kernel_hw=(k, k), padding=p,
        dilation=d, interpret=True)).astype(np.float32)
    got = fc.flat_conv_dgrad_plain(torch.from_numpy(dy), torch.from_numpy(wk),
                                   (k, k), p, d)
    assert got.shape == (n, h, w, c) and got.dtype == torch.bfloat16
    assert rel_max(got.float().numpy(), want) <= DGRAD_TOL


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    n, h, w, c, o, k, p, d = CASES[5]
    x, dy, wk = (torch.from_numpy(a) for a in _inputs(CASES[5], 5))
    launches = fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches
    assert torch.equal(fc.flat_conv_wgrad(x, dy, (k, k), p, d),
                       fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d))
    assert torch.equal(fc.flat_conv_dgrad(dy, wk, (k, k), p, d),
                       fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d))
    assert (fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches) == launches


def _bad(kind):
    """(function, args) of a call the kernels do not take."""
    x, dy, w = torch.zeros(1, 9, 9, 8), torch.zeros(1, 9, 9, 16), torch.zeros(3, 3, 8, 16)
    wgrad, dgrad = fc.flat_conv_wgrad, fc.flat_conv_dgrad
    return {
        "not_same_size": (wgrad, (x, dy, (3, 3), 2, 1)),
        "dilation_pad": (dgrad, (dy, w, (3, 3), 1, 2)),
        "non_square": (wgrad, (x, dy, (3, 5), 1, 1)),
        "ndim": (wgrad, (x[0], dy[0], (3, 3), 1, 1)),
        "int_dtype": (dgrad, (dy.long(), w, (3, 3), 1, 1)),
        "spatial_mismatch": (wgrad, (x, dy[:, :8], (3, 3), 1, 1)),
        "weight_shape": (dgrad, (dy, w[:, :, :, :8], (3, 3), 1, 1)),
        "kernel_vs_weight": (dgrad, (dy, w, (1, 1), 0, 1)),
        "groups": (fc.flat_conv, (torch.zeros(1, 8, 9, 9), torch.zeros(16, 4, 3, 3),
                                  (3, 3), 1, 1)),
        "conv_kernel_vs_weight": (fc.flat_conv, (torch.zeros(1, 8, 9, 9),
                                                 torch.zeros(16, 8, 3, 3), (5, 5), 2, 1)),
    }[kind]


@pytest.mark.parametrize("kind", [
    "not_same_size", "dilation_pad", "non_square", "ndim", "int_dtype",
    "spatial_mismatch", "weight_shape", "kernel_vs_weight",
    "groups", "conv_kernel_vs_weight"])
def test_wrappers_reject_what_the_kernels_do_not_take(kind):
    fn, args = _bad(kind)
    with pytest.raises((ValueError, TypeError)):
        fn(*args)


def test_wgrad_past_the_old_partial_bound_matches_segtpu():
    """A dW of more than 2**24 floats (3x3x1400x1400), which the kernel once
    refused: the wrapper computes it, as segtpu does, and the plan runs it as
    one split with no partial buffer."""
    n, h, w, c, o, k, p, d = 1, 2, 2, 1400, 1400, 3, 1, 1
    assert k * k * c * o > fc.MAX_PARTIAL_FLOATS
    x, dy, _ = _inputs((n, h, w, c, o, k, p, d), 11)
    want = np.asarray(seg_fc.flat_conv_wgrad(
        jnp.asarray(x), jnp.asarray(dy), kernel_hw=(k, k), padding=p,
        dilation=d, interpret=True))
    got = fc.flat_conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy), (k, k), p, d)
    assert got.shape == (k, k, c, o) and got.dtype == torch.float32
    assert rel_max(got.numpy(), want) < WGRAD_TOL
    assert fc.wgrad_plan(n * h * w, k, k, c, o, d, sms=132, blocks_per_sm=3).splits == 1


@pytest.mark.parametrize("shape", [
    (8, 385, 385, 64, 64, 3, 1), (8, 385, 385, 64, 128, 3, 1), (8, 97, 97, 512, 512, 3, 4),
    (8, 193, 193, 256, 19, 3, 1), (8, 193, 193, 256, 256, 3, 1), (1, 25, 25, 512, 19, 3, 1),
    (3, 15, 15, 24, 8, 5, 1), (1, 9, 9, 1536, 1536, 3, 1)])
def test_wgrad_plan_covers_every_row_once_and_bounds_the_partials(shape):
    n, h, w, c, o, k, d = shape
    rows = n * h * w
    for blocks_per_sm in (1, 3, 4):
        plan = fc.wgrad_plan(rows, k, k, c, o, d, sms=132, blocks_per_sm=blocks_per_sm)
        # split s takes chunks s, s + splits, ...: every chunk, hence every
        # row, once; each split starts at a multiple of the chunk
        chunks = -(-rows // fc.WGRAD_CHUNK)
        taken = [q for s in range(plan.splits) for q in range(s, chunks, plan.splits)]
        assert 1 <= plan.splits <= chunks and sorted(taken) == list(range(chunks))
        assert plan.splits == 1 or plan.splits * k * k * c * o <= fc.MAX_PARTIAL_FLOATS
        assert (plan.tile_o <= 32) == (o <= 32)  # the narrow o tile
        assert o > 32 or plan.tile_o >= o  # ... covers O
        assert plan.taps == min(k, 3)
        tiles = k * -(-k // plan.taps) * -(-c // fc.WGRAD_TILE_C) * -(-o // plan.tile_o)
        assert plan.splits == 1 or tiles * plan.splits <= blocks_per_sm * 132


@pytest.mark.parametrize("case", [
    (8, 385, 385, 64, 64, 3, 1, 1), (8, 385, 385, 64, 128, 3, 1, 1),
    (8, 97, 97, 512, 512, 3, 4, 4), (8, 193, 193, 256, 19, 3, 1, 1),
    (8, 193, 193, 256, 256, 3, 1, 1)] + CASES)
def test_dgrad_plan_covers_every_row_and_c_tile_once(case):
    """Walk the grid as the dgrad kernel does: block b takes the tiles b, b +
    blocks, ...; every (row tile, c tile) once, each block on one c tile,
    every tap of a tap row in exactly one stage, and the block within the
    shared memory an SM has."""
    n, h, w, c, o, k, p, d = case
    rows = n * h * w
    for blocks_per_sm in (1, 2):
        plan = fc.dgrad_plan(rows, c, o, k, k, d, sms=132, blocks_per_sm=blocks_per_sm)
        ctiles = -(-c // plan.tile_c)
        tiles = -(-rows // fc.DGRAD_ROWS) * ctiles
        walks = [list(range(b, tiles, plan.blocks)) for b in range(plan.blocks)]
        assert sorted(t for walk in walks for t in walk) == list(range(tiles))
        assert all(len({t % ctiles for t in walk}) == 1 for walk in walks)
        assert plan.blocks <= max(ctiles, blocks_per_sm * 132)
        assert plan.tile_c >= min(c, 256) and plan.ko in (32, 64)
        groups = -(-k // plan.taps)
        assert sorted(b for g in range(groups)
                      for b in range(g * plan.taps, min(k, (g + 1) * plan.taps))) == list(range(k))
        assert plan.taps == 1 or (plan.taps - 1) * d <= fc.DGRAD_MAX_SHIFT
        assert not plan.resident or ctiles == 1
        assert fc.dgrad_smem_bytes(plan.tile_c, plan.ko, plan.taps, d, o, k, k,
                                   plan.resident) <= fc.SMEM_PER_BLOCK
        assert plan.taps == k  # a stage holds its whole tap row: dy staged kh times


def _loss_grads_torch(x, wk, k, p, d, conv):
    """(dL/dx, dL/dw) NHWC / HWIO of sum(tanh(conv(x, w))) in torch."""
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    wt = torch.tensor(wk.transpose(3, 2, 0, 1), requires_grad=True)
    torch.tanh(conv(xt, wt, (k, k), p, d)).sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.float32
    return (xt.grad.numpy().transpose(0, 2, 3, 1),
            wt.grad.numpy().transpose(2, 3, 1, 0))


def _conv2d(x, w, kernel_hw, p, d):
    return F.conv2d(x, w, padding=p, dilation=d)


@pytest.mark.parametrize("case", [(1, 19, 19, 6, 10, 3, 1, 1), (2, 15, 15, 8, 12, 3, 2, 2)])
def test_flat_conv_grads_match_segtpu_custom_vjp(case, monkeypatch):
    """The port of test_custom_vjp_grads: the gradient through FlatConv
    against jax.grad through segtpu's flat_conv, its kernels in interpret
    mode."""
    n, h, w, c, o, k, p, d = case
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(k, k, c, o)) * 0.2).astype(np.float32)
    monkeypatch.setattr(seg_fc, "flat_conv_wgrad",
                        functools.partial(seg_fc.flat_conv_wgrad, interpret=True))
    monkeypatch.setattr(seg_fc, "flat_conv_dgrad",
                        functools.partial(seg_fc.flat_conv_dgrad, interpret=True))
    want = jax.grad(lambda x_, w_: jnp.sum(jnp.tanh(
        seg_fc.flat_conv(x_, w_, (k, k), p, d))), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(wk))
    got = _loss_grads_torch(x, wk, k, p, d, fc.flat_conv)
    for g, wnt in zip(got, want):
        assert rel_max(g, np.asarray(wnt)) < GRAD_TOL


@pytest.mark.parametrize("case", [(1, 19, 19, 6, 10, 3, 1, 1), (2, 13, 17, 4, 6, 5, 2, 1)])
def test_flat_conv_grads_match_conv2d_autograd(case):
    n, h, w, c, o, k, p, d = case
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    wk = (rng.normal(size=(k, k, c, o)) * 0.2).astype(np.float32)
    got = _loss_grads_torch(x, wk, k, p, d, fc.flat_conv)
    want = _loss_grads_torch(x, wk, k, p, d, _conv2d)
    for g, wnt in zip(got, want):
        assert rel_max(g, wnt) < GRAD_TOL


def test_flat_conv_forward_is_the_library_conv():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 8, 11, 11)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 8, 3, 3)).astype(np.float32))
    assert torch.equal(fc.flat_conv(x, w, (3, 3), 2, 2),
                       F.conv2d(x, w, padding=2, dilation=2))

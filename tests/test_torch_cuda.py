"""The port's CUDA kernels against their plain versions on the card, and the
port's checkpoints and sliding inference between the card and the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX (nor tests/torch_parity.py, which does), so that it runs on a
GPU machine that has none, without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Inputs are drawn with numpy from a seed, as in the CPU tests, whose shapes
and tolerances these reuse (tests/test_torch_kernels.py,
tests/test_torch_flatconv.py).
"""

import numpy as np
import pytest
import torch

from segtpu_torch.ops import conv_wgrad as cw
from segtpu_torch.ops import flatconv as fc

# stem weight gradient: n, h, w, c, co, k (tests/test_conv_wgrad.py's shapes
# and the main path's, then shapes that take tap groups, a padded o tile,
# dy by plain loads (CO = 19: CO * 2 is no multiple of 16), gathered
# channels (C = 64 at k = 7), several o tiles, Wo < 64, and Wo = 129, where
# 64-pixel tiles end short at a width like the main path's)
STEM_SHAPES = [(2, 65, 65, 3, 64, 7), (1, 32, 48, 3, 16, 7), (2, 64, 64, 4, 32, 7),
               (2, 65, 65, 3, 64, 3), (2, 33, 47, 5, 16, 3), (8, 769, 769, 3, 64, 3),
               (1, 33, 33, 6, 64, 7), (1, 33, 33, 3, 48, 3), (2, 33, 47, 5, 19, 3),
               (1, 17, 17, 64, 64, 7), (1, 9, 9, 3, 600, 3), (2, 257, 257, 3, 64, 3)]
# flat-row conv: n, h, w, c, o, k, p, d (tests/test_flatconv.py's cases)
FLAT_CASES = [
    (2, 33, 33, 64, 64, 3, 1, 1), (2, 33, 33, 64, 128, 3, 1, 1),
    (1, 25, 25, 512, 19, 3, 1, 1), (2, 17, 29, 8, 16, 3, 1, 1),
    (2, 21, 21, 32, 48, 1, 0, 1), (1, 27, 27, 16, 24, 3, 2, 2),
    (3, 15, 15, 24, 8, 5, 2, 1)]
# bf16-rounded inputs, fp32 sums in other orders (segtpu's kernel tolerance)
WGRAD_TOL = 5e-3
# both sides round fp32 sums to bf16: at most one bf16 ulp, 2**-7 of the
# largest value
DGRAD_TOL = 2.0 ** -7


def _rel_max(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_wgrad_kernel_matches_plain(shape, cuda_device):
    n, h, w, c, co, k = shape
    ho, wo = (h + 2 * (k // 2) - k) // 2 + 1, (w + 2 * (k // 2) - k) // 2 + 1
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(n, ho, wo, co)).astype(np.float32)).to(cuda_device)
    before = cw.stem_conv_wgrad.launches
    got = cw.stem_conv_wgrad(x, dy, kernel=k)
    want = cw.stem_conv_wgrad_plain(x, dy, k)
    torch.cuda.synchronize()
    assert cw.stem_conv_wgrad.launches == before + 1
    assert _rel_max(got, want) < WGRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 65, 65, 3, 64, 3), (8, 769, 769, 3, 64, 3)])
def test_stem_wgrad_kernel_on_float16_matches_plain(shape, cuda_device):
    """``trainer.compute_dtype: float16``: the stem conv under float16
    autocast gets float16 x and dy (dy at a cross-entropy gradient's scale,
    partly subnormal in float16). The kernel rounds both to bf16, as
    segtpu's does, and matches its plain version on them; the conv's
    float32 weight gradient is the kernel's dW, bit for bit."""
    n, h, w, c, co, k = shape
    rng = np.random.default_rng(sum(shape) + 16)
    x = torch.from_numpy(rng.normal(size=(n, c, h, w)).astype(np.float32)).to(
        cuda_device).half().contiguous(memory_format=torch.channels_last)
    conv = cw.StemConv2d(c, co, k, lambda t, _: t.normal_(0, 0.1)).to(cuda_device)
    with torch.autocast("cuda", dtype=torch.float16):
        y = conv(x)
    assert y.dtype == torch.float16
    up = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32)).to(cuda_device)
    dy = (up * 2e-7).half().contiguous(memory_format=torch.channels_last)
    before = cw.stem_conv_wgrad.launches
    y.backward(dy)
    torch.cuda.synchronize()
    assert cw.stem_conv_wgrad.launches == before + 1
    assert conv.weight.grad.dtype == torch.float32
    x_nhwc, dy_nhwc = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
    got = cw.stem_conv_wgrad(x_nhwc, dy_nhwc, kernel=k)
    assert torch.equal(conv.weight.grad, got.permute(3, 2, 0, 1))
    assert _rel_max(got, cw.stem_conv_wgrad_plain(x_nhwc, dy_nhwc, k)) < WGRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_plan_shared_memory_is_the_kernels(shape, cuda_device):
    n, h, w, c, co, k = shape
    plan, per_sm, smem = cw.stem_launch_plan((n, h, w, c), co, k, cuda_device)
    ring = (c, plan.kr, plan.kc, plan.cs, int(plan.span), plan.stages)
    assert cw._lib().stem_conv_wgrad_smem_bytes(*ring) == cw.smem_bytes(*ring) == smem
    assert per_sm >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 769, 769, 3, 64, 3), (2, 33, 47, 5, 19, 3),
                                   (1, 17, 17, 64, 64, 7)])
def test_stem_wgrad_two_launches_are_bit_identical(shape, cuda_device):
    """Fixed-order sums and no atomics: the same inputs give the same bits."""
    n, h, w, c, co, k = shape
    ho, wo = (h + 2 * (k // 2) - k) // 2 + 1, (w + 2 * (k // 2) - k) // 2 + 1
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(n, ho, wo, co)).astype(np.float32)).to(cuda_device)
    first = cw.stem_conv_wgrad(x, dy, kernel=k)
    second = cw.stem_conv_wgrad(x, dy, kernel=k)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# a band of an image sharded over H: (n, h, w, c, co, k, first output row,
# output rows), x carrying the halo rows the band's windows read; the top
# band pads k//2 zero rows above, the bottom one below, a middle one none
# (the PSPNet-R50 stem at 769 over 2 ranks: 196 / 189 output rows)
STEM_BANDS = [(2, 769, 769, 3, 64, 3, 0, 196), (2, 769, 769, 3, 64, 3, 196, 189),
              (2, 65, 65, 3, 64, 7, 8, 10), (2, 65, 65, 3, 64, 7, 0, 8),
              (2, 65, 65, 3, 64, 7, 25, 8), (1, 33, 47, 5, 19, 3, 6, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("band", STEM_BANDS)
def test_stem_wgrad_kernel_on_a_band_matches_plain(band, cuda_device):
    """Explicit H padding: the kernel against its plain version on the band,
    and the plain version of the band against the whole image's rows."""
    n, h, w, c, co, k, o0, rows = band
    p = k // 2
    ho, wo = (h + 2 * p - k) // 2 + 1, (w + 2 * p - k) // 2 + 1
    rng = np.random.default_rng(sum(band))
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(n, ho, wo, co)).astype(np.float32)).to(cuda_device)
    a, b = 2 * o0 - p, 2 * (o0 + rows - 1) - p + k
    xb, dyb = x[:, max(a, 0):min(b, h)], dy[:, o0:o0 + rows]
    pad = (max(0, -a), max(0, b - h))
    before = cw.stem_conv_wgrad.launches
    got = cw.stem_conv_wgrad(xb, dyb, kernel=k, pad_h=pad)
    want = cw.stem_conv_wgrad_plain(xb, dyb, k, pad_h=pad)
    torch.cuda.synchronize()
    assert cw.stem_conv_wgrad.launches == before + 1
    assert _rel_max(got, want) < WGRAD_TOL
    # the whole image's dW with dy zero outside the band's rows
    masked = torch.zeros_like(dy)
    masked[:, o0:o0 + rows] = dyb
    assert _rel_max(want, cw.stem_conv_wgrad_plain(x, masked, k)) < WGRAD_TOL


@pytest.mark.cuda
def test_stem_wgrad_takes_inputs_that_start_off_16_bytes(cuda_device):
    """x and dy that start 2 bytes past a 16-byte boundary: x (whose rows the
    kernel copies by 16 bytes) is copied once, dy (no tensor map fits it)
    goes through the producer's 2-byte loads."""
    n, h, w, c, co, k = 2, 65, 65, 3, 64, 3
    rng = np.random.default_rng(7)

    def off_by_one(shape):
        flat = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bfloat16, device=cuda_device)
        t = flat[1:].view(shape)
        t.copy_(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
        return t

    x, dy = off_by_one((n, h, w, c)), off_by_one((n, 33, 33, co))
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    before = cw.stem_conv_wgrad.copies
    got = cw.stem_conv_wgrad(x, dy, kernel=k)
    torch.cuda.synchronize()
    assert cw.stem_conv_wgrad.copies == before + 1
    assert _rel_max(got, cw.stem_conv_wgrad_plain(x, dy, k)) < WGRAD_TOL


def _flat_inputs(case, seed, device):
    n, h, w, c, o, k, p, d = case
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.normal(size=(n, h, w, c)), rng.normal(size=(n, h, w, o)),
        rng.normal(size=(k, k, c, o)) * 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(FLAT_CASES)))
def test_flat_kernels_match_plain(i, cuda_device):
    n, h, w, c, o, k, p, d = FLAT_CASES[i]
    x, dy, wk = _flat_inputs(FLAT_CASES[i], i, cuda_device)
    launches = fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches
    got_w = fc.flat_conv_wgrad(x, dy, (k, k), p, d)
    got_d = fc.flat_conv_dgrad(dy, wk, (k, k), p, d)
    torch.cuda.synchronize()
    assert (fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert got_d.dtype == torch.bfloat16
    assert _rel_max(got_w, fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)) < WGRAD_TOL
    assert _rel_max(got_d, fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)) <= DGRAD_TOL


# flat-row wgrad cases that reach each path of the kernel: n, h, w, c, o, k, p, d
WGRAD_CASES = [
    (2, 17, 29, 5, 19, 3, 1, 1),      # C, O not multiples of 8: scalar x, dy span
    (2, 13, 11, 16, 24, 3, 4, 4),     # dilation 4: the x window crosses images
    (3, 19, 23, 64, 64, 3, 1, 1),     # 1311 rows: a ragged chunk, splits mid-row
    (1, 9, 9, 1536, 1536, 3, 1, 1),   # dW past 2**24 floats: one split, no partial
    (2, 15, 15, 32, 45, 3, 1, 1),     # dy span under the 64-wide o tile
    (1, 15, 17, 16, 70, 3, 1, 1),     # O past the tile, not a multiple of 8: scalar dy
    (1, 16, 16, 16, 16, 7, 3, 1),     # 7x7: tap groups of 3, 3 and 1
    (1, 10, 12, 8, 8, 3, 80, 80),     # window past 64 + 128 rows: one tap a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGRAD_CASES)
def test_flat_wgrad_kernel_matches_plain(case, cuda_device):
    n, h, w, c, o, k, p, d = case
    x, dy, _ = _flat_inputs(case, sum(case), cuda_device)
    launches = fc.flat_conv_wgrad.launches
    got = fc.flat_conv_wgrad(x, dy, (k, k), p, d)
    torch.cuda.synchronize()
    assert fc.flat_conv_wgrad.launches == launches + 1
    assert got.shape == (k, k, c, o) and got.dtype == torch.float32
    assert _rel_max(got, fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)) < WGRAD_TOL


# flat-row dgrad cases that reach each path of the kernel: n, h, w, c, o, k, p, d
DGRAD_CASES = [
    (2, 17, 29, 40, 19, 3, 1, 1),      # O = 19: the dy span, resident weight
    (2, 17, 29, 5, 19, 3, 1, 1),       # C and O not multiples of 8: masked stores
    (1, 15, 17, 13, 70, 3, 1, 1),      # O past one chunk, not a multiple of 8: 2-byte dy
    (1, 19, 23, 300, 64, 3, 1, 1),     # C past one c tile: two tiles, weight staged
    (2, 13, 11, 16, 24, 3, 4, 4),      # dilation 4: the window crosses images
    (3, 19, 23, 64, 64, 3, 1, 1),      # 1311 rows: a ragged last row tile
    (1, 12, 14, 100, 200, 3, 1, 1),    # 128-wide c tile, four o chunks, weight staged
    (3, 15, 15, 24, 8, 5, 2, 1),       # 5x5: one stage of 5 taps
    (1, 16, 16, 16, 16, 7, 3, 1),      # 7x7: taps in sub-groups of 3, 3 and 1
    (1, 10, 12, 8, 8, 3, 80, 80),      # window past the ring's row budget: 2 + 1 taps
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DGRAD_CASES)
def test_flat_dgrad_kernel_matches_plain(case, cuda_device):
    n, h, w, c, o, k, p, d = case
    _, dy, wk = _flat_inputs(case, sum(case), cuda_device)
    launches = fc.flat_conv_dgrad.launches
    got = fc.flat_conv_dgrad(dy, wk, (k, k), p, d)
    torch.cuda.synchronize()
    assert fc.flat_conv_dgrad.launches == launches + 1
    assert got.shape == (n, h, w, c) and got.dtype == torch.bfloat16
    assert _rel_max(got, fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)) <= DGRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case,blocks", [
    ((3, 19, 23, 64, 64, 3, 1, 1), 3), ((1, 19, 23, 300, 64, 3, 1, 1), 2),
    ((2, 17, 29, 40, 19, 3, 1, 1), 3), ((1, 12, 14, 100, 200, 3, 1, 1), 1)])
def test_flat_dgrad_blocks_that_walk_several_tiles(case, blocks, cuda_device):
    """Fewer blocks than tiles, as at full width: block b walks the tiles b,
    b + blocks, ..., its ring running on from one tile into the next."""
    n, h, w, c, o, k, p, d = case
    _, dy, wk = _flat_inputs(case, sum(case), cuda_device)
    tile_c, ko, taps, resident = fc.dgrad_tiling(c, o, k, k, d)
    ow = -(-o // 8) * 8
    wb = torch.nn.functional.pad(wk, (0, ow - o)).bfloat16().contiguous()
    dyb = dy.bfloat16()
    dx = torch.empty((n, h, w, c), dtype=torch.bfloat16, device=cuda_device)
    err = fc._lib().flat_conv_dgrad(
        dyb.data_ptr(), wb.data_ptr(), dx.data_ptr(), n, h, w, c, o, ow, k, k, p, d,
        tile_c, ko, taps, int(resident), blocks, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert _rel_max(dx, fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)) <= DGRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLAT_CASES + DGRAD_CASES)
def test_dgrad_plan_shared_memory_is_the_kernels(case, cuda_device):
    n, h, w, c, o, k, p, d = case
    plan, _, smem = fc.dgrad_launch_plan((n, h, w, o), c, (k, k), d, cuda_device)
    assert smem == fc.dgrad_smem_bytes(plan.tile_c, plan.ko, plan.taps, d, o, k, k,
                                       plan.resident)


@pytest.mark.cuda
def test_flat_kernels_ignore_nan_outside_the_image(cuda_device):
    """Select, not multiply: NaN in the rows just before and after x and dy
    in memory (bf16 slices of NaN-padded tensors, read in place) reaches
    neither dW nor dx."""
    n, h, w, c, o, k, p, d = FLAT_CASES[3]
    x, dy, wk = _flat_inputs(FLAT_CASES[3], 3, cuda_device)

    def nan_padded(t):
        big = torch.full((t.shape[0] + 2,) + t.shape[1:], float("nan"),
                         dtype=torch.bfloat16, device=cuda_device)
        big[1:-1] = t
        return big[1:-1]

    copies = fc.flat_conv_wgrad.copies, fc.flat_conv_dgrad.copies
    got_w = fc.flat_conv_wgrad(nan_padded(x), nan_padded(dy), (k, k), p, d)
    got_d = fc.flat_conv_dgrad(nan_padded(dy), wk, (k, k), p, d)
    assert (fc.flat_conv_wgrad.copies, fc.flat_conv_dgrad.copies) == copies
    assert torch.isfinite(got_w).all() and torch.isfinite(got_d).all()
    assert _rel_max(got_w, fc.flat_conv_wgrad_plain(x, dy, (k, k), p, d)) < WGRAD_TOL
    assert _rel_max(got_d, fc.flat_conv_dgrad_plain(dy, wk, (k, k), p, d)) <= DGRAD_TOL


@pytest.mark.cuda
def test_flat_conv_backward_launches_each_kernel_once(cuda_device):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 16, 21, 21)).astype(np.float32)).to(
        cuda_device).to(memory_format=torch.channels_last).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(24, 16, 3, 3)).astype(np.float32) * 0.1).to(
        cuda_device).requires_grad_()
    launches = fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches
    torch.tanh(fc.flat_conv(x, w, (3, 3), 1, 1)).sum().backward()
    torch.cuda.synchronize()
    assert (fc.flat_conv_wgrad.launches, fc.flat_conv_dgrad.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert x.grad.shape == x.shape and x.grad.dtype == torch.float32
    assert w.grad.shape == w.shape and w.grad.dtype == torch.float32


def _tiny_state(device, seed):
    from segtpu_torch.core.state import TrainState, make_optimizer
    from segtpu_torch.models import get_model

    model = get_model("PSPNet", device=device, seed=seed, num_classes=3,
                      backbone="resnet18", pallas_stem_wgrad=True)
    opt, schedules = make_optimizer(model, num_epochs=1, iters_per_epoch=2)
    return TrainState(model, opt, schedules)


@pytest.mark.cuda
def test_checkpoint_moves_between_the_card_and_the_cpu(cuda_device, tmp_path):
    """A checkpoint of a channels_last model trained one step on the card
    loads into a CPU model with the same bits, and that model's checkpoint
    loads back into a card model with the same bits again."""
    from segtpu_torch import losses
    from segtpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from segtpu_torch.core.steps import make_train_step

    state = _tiny_state("cuda", 0)
    kernel = next(p for p in state.model.parameters() if p.dim() == 4)
    assert not kernel.is_contiguous()  # channels_last on the card
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 33, 33, 3), np.uint8))
    labels = torch.from_numpy(rng.integers(0, 3, (2, 33, 33), np.int64))
    step = make_train_step(losses.cross_entropy, compute_dtype=torch.float32,
                           norm_stats=([0.5] * 3, [0.25] * 3))
    step(state, images.to(cuda_device), labels.to(cuda_device))

    def snapshot(s):
        opt = s.optimizer
        return ([v.cpu() for v in s.model.state_dict().values()]
                + [opt.state[p]["momentum_buffer"].cpu()
                   for g in opt.param_groups for p in g["params"]], s.step)

    want = snapshot(state)
    save_checkpoint(str(tmp_path), "card", state, 1, 0.5, {}, "PSPNet")
    on_cpu = _tiny_state("cpu", 1)
    load_checkpoint(str(tmp_path / "card"), on_cpu)
    save_checkpoint(str(tmp_path), "cpu", on_cpu, 1, 0.5, {}, "PSPNet")
    back = _tiny_state("cuda", 2)
    load_checkpoint(str(tmp_path / "cpu"), back)
    for got in (snapshot(on_cpu), snapshot(back)):
        assert got[1] == want[1]
        assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))


@pytest.mark.cuda
def test_sliding_predict_on_the_card_matches_the_cpu(cuda_device):
    """fp32 (TF32 off): the card's canvas within 1e-4 of the canvas maximum of
    the CPU's on the same weights (the CPU tests' tolerance against segtpu)."""
    from segtpu_torch.inference_lib import make_predictor, sliding_predict

    image = np.random.default_rng(1).normal(size=(40, 56, 3)).astype(np.float32)
    canvases = []
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", "cuda"):
            predict = make_predictor(_tiny_state(device, 3).model, device=device)
            canvases.append(sliding_predict(predict, image, 3, max_tile_batch=16))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu, card = canvases
    assert card.shape == cpu.shape == (40, 56, 3)
    assert np.abs(card - cpu).max() <= 1e-4 * np.abs(cpu).max()


@pytest.mark.cuda
def test_prefetched_batches_on_the_card_equal_the_host_batches(cuda_device):
    """The prefetcher's side-stream copies, consumed on the current stream
    while a kernel there still runs, give the host batches bit for bit; an
    early exit ends the producer."""
    from segtpu_torch.data import DevicePrefetcher

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (4, 97, 97, 3)).astype(np.uint8),
                rng.integers(0, 19, (4, 97, 97)).astype(np.int32)) for _ in range(6)]
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for images, labels in DevicePrefetcher(batches, cuda_device):
        busy = busy @ busy / 2048  # work queued on the current stream
        assert images.device.type == "cuda" and labels.dtype == torch.int32
        got.append((images.cpu().numpy(), labels.cpu().numpy()))
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for (gi, gl), (wi, wl) in zip(got, batches):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    it = iter(DevicePrefetcher(batches, cuda_device, depth=1))
    next(it)
    it.close()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 65, 65), (8, 64, 385, 385)])
def test_max_unpool_flat_on_the_card_equals_the_cpu(shape, cuda_device):
    """The card's winner among repeated indices is the CPU's (the highest
    row-major pooled pixel), bit for bit on one bf16 input, forward and
    backward; the second shape is SegResNet's stem at 769."""
    from segtpu_torch.ops.pooling import max_pool_argmax_flat, max_unpool_flat

    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.maximum(rng.integers(-3, 3, size=shape), 0)).bfloat16()
    _, idx = max_pool_argmax_flat(x)
    flat = idx.flatten(2)
    assert (flat.sort(dim=2).values.diff(dim=2) == 0).any()  # repeats exist
    ho, wo = idx.shape[-2:]
    y = torch.from_numpy(rng.normal(size=idx.shape)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(*idx.shape[:2], 2 * ho, 2 * wo))).bfloat16()
    outs = []
    for dev in ("cpu", cuda_device):
        yd = y.to(dev).detach().requires_grad_()
        out = max_unpool_flat(yd, idx.to(dev), (2 * ho, 2 * wo))
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), yd.grad.cpu()))
    (cpu_out, cpu_grad), (card_out, card_grad) = outs
    assert torch.equal(card_out, cpu_out) and torch.equal(card_grad, cpu_grad)

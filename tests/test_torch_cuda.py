"""The port's CUDA kernels against their plain versions on the card.

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
# and the main path's)
STEM_SHAPES = [(2, 65, 65, 3, 64, 7), (1, 32, 48, 3, 16, 7), (2, 64, 64, 4, 32, 7),
               (2, 65, 65, 3, 64, 3), (2, 33, 47, 5, 16, 3), (8, 769, 769, 3, 64, 3)]
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

"""The control (the reference computed in float8 in the program's place)
comes out not correct under each cell's limits: at a small size on the CPU,
and at the cell's own size on a card on three seeds (``cuda``)."""

from __future__ import annotations

import pytest
import torch

from segbench import calibrate, check
from segbench.cells import ROOT, Cell
from segbench.tests.bench_helpers import small_cell

CELLS = sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_size(name, tmp_path):
    cell = small_cell(name, tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        numbers, _ = calibrate.reading(cell, 2**31 + 11, torch.device("cpu"), "control")
    finally:
        torch.set_num_threads(n)
    correct, table = check.judge(numbers, cell.limits)
    assert not correct, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda_device):
    cell = Cell(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers, _ = calibrate.reading(cell, seed, cuda_device, "control")
        correct, table = check.judge(numbers, cell.limits)
        assert not correct, (seed, table)

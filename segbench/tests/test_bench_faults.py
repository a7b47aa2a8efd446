"""Whole runs of each cell at a small size on the CPU (the look for a chip
skipped): a sound run comes out correct under the cell's own limits, and a
run with a fault planted in the program underneath comes out not correct,
for each fault the cell's kind can have."""

from __future__ import annotations

import time

import pytest
import torch

from segbench import run
from segbench.cells import ROOT, read_json
from segbench.faults import FAULTS
from segbench.tests.bench_helpers import small_cell

CELLS = sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
CASES = [(c, f) for c in CELLS
         for f in [None] + sorted(FAULTS[read_json(
             ROOT / "traffic" / f"{read_json(ROOT / 'workloads' / f'{c}.json')['traffic']}.json")
             ["kind"]])]


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_run_is_correct_only_without_a_fault(name, fault, tmp_path):
    cell = small_cell(name, tmp_path)
    kind = cell.traffic["kind"]
    start = time.perf_counter()
    if fault is None:
        result = run.run_cell(cell, 2**31 + 7, 0.5, False, torch.device("cpu"), t_start=start)
        assert result["correct"], result["check"]
        assert result["attempted"] >= 1 and result["failed"] == 0
        assert list(result)[-1] == "check"
    else:
        with FAULTS[kind][fault]():
            result = run.run_cell(cell, 2**31 + 7, 0.5, False, torch.device("cpu"),
                                  t_start=start)
        assert result["correct"] is False, result["check"]

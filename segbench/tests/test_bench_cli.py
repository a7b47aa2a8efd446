"""The command without a card: it exits non-zero and prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from segbench.cells import ROOT

COMMAND = [sys.executable, "-m", "segbench.run", "--workload", "pspnet_r50.train_b8_769",
           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the command would run")


def test_exits_without_a_card(no_card):
    out = subprocess.run(COMMAND, cwd=ROOT.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_exits_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT, tmp_path / "segbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(COMMAND, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

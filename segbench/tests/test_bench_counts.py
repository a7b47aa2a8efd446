"""The benchmark's counts of work: FLOPs from the reference on the meta
device, and the stem kernel's bytes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from segbench import counts
from segbench.cells import Cell
from segbench.reference.layers import Conv2d


def test_one_conv_against_a_hand_count():
    conv = Conv2d(64, 128, 3, stride=2, padding=1, dilation=1)
    with torch.device("meta"):
        conv = conv.to("meta")
        x = torch.empty(2, 64, 33, 47)
        with FlopCounterMode(display=False) as fc:
            y = conv(x)
    assert tuple(y.shape) == (2, 128, 17, 24)
    assert fc.get_total_flops() == 2 * 2 * 128 * 17 * 24 * 64 * 3 * 3


def test_stem_kernel_bytes():
    # x 8x769x769x3 and dy 8x385x385x64 in bf16, read once; dW 3x3x3x64 fp32
    nbytes = counts.stem_wgrad_bytes(8, 769, 769, 3, 64, 3)
    assert nbytes == 2 * (8 * 769 * 769 * 3 + 8 * 385 * 385 * 64) + 4 * 3 * 3 * 3 * 64
    assert round(nbytes / 1e6, 1) == 180.2
    assert counts.bound_s(nbytes) == pytest.approx(180.2e6 / 3.35e12, rel=1e-3)


def test_training_step_counts():
    psp = Cell("pspnet_r50.train_b8_769").config
    upn = Cell("upernet_r101.train_b8_769").config
    step = counts.model_flops(psp, 8, 769, 769, train=True)
    # an eval forward has no aux head: 0.845 TFLOP an image
    assert counts.model_flops(psp, 1, 769, 769, train=False) == pytest.approx(0.84517e12, rel=1e-4)
    # recorded in PERF.md beside XLA's 22.32 TFLOP for segtpu's step (a cross-check)
    assert step == pytest.approx(22.4154e12, rel=1e-4)
    assert counts.model_flops(upn, 8, 769, 769, train=True) == pytest.approx(20.3206e12, rel=1e-4)

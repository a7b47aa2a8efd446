"""The port's spans (``segtpu_torch/tracing.py``) on the CPU, on a tiny model:
off without a profiler, the same numbers with one, nested per step and per
frame, on the profiler's clock, once per batch taken from the prefetcher,
and a record bounded at its limit."""

import numpy as np
import pytest
import torch
from torch import nn
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from segtpu_torch import inference_lib, losses, tracing
from segtpu_torch.core.state import TrainState, make_optimizer
from segtpu_torch.core.steps import make_train_step
from segtpu_torch.data import DevicePrefetcher

CLASSES, HW, BATCH = 3, 33, 2
NORM = ([0.5, 0.5, 0.5], [0.25, 0.25, 0.25])
STEP = "segtpu_torch.step"
STEP_CHILDREN = {f"{STEP}.{p}" for p in ("prep", "forward", "backward", "optimizer",
                                          "seg_stats")}
SLIDING = "segtpu_torch.sliding"
SLIDING_CHILDREN = {f"{SLIDING}.{p}" for p in ("upload", "tiles", "forward", "canvas")}


class Tiny(nn.Module):
    """conv-BN-ReLU, a head and an aux head: the outputs a zoo model gives."""

    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8), nn.ReLU())
        self.head = nn.Conv2d(8, CLASSES, 1)
        self.aux = nn.Conv2d(8, CLASSES, 1)

    def forward(self, x):
        f = self.body(x)
        return {"out": self.head(f), "aux": self.aux(f)} if self.training else {
            "out": self.head(f)}


def _state():
    torch.manual_seed(3)
    model = Tiny()
    opt, schedules = make_optimizer(model, differential_lr=False, num_epochs=1,
                                    iters_per_epoch=4)
    return TrainState(model, opt, schedules)


def _batch():
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, HW, HW, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.integers(0, CLASSES, (BATCH, HW, HW)).astype(np.int32))
    return images, labels


def _train_step(state):
    step = make_train_step(losses.get_loss("CrossEntropyLoss2d"), compute_dtype=torch.float32,
                           norm_stats=NORM)
    return step(state, *_batch())


def _sliding(model):
    predict = inference_lib.make_predictor(model, device="cpu")
    image = np.random.default_rng(9).standard_normal((48, 64, 3)).astype(np.float32)
    return inference_lib.sliding_predict(predict, image, CLASSES, max_tile_batch=4,
                                         class_map=True)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _parents(recs):
    return {r.name: r.parent for r in recs}


def test_off_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.clear()
    state = _state()
    _train_step(state)
    _sliding(state.model)
    assert tracing.span("a") is tracing.span("b")
    assert tracing.records() == []


def test_the_same_numbers_with_a_profiler():
    off = _state()
    loss_off, _ = _train_step(off)
    map_off = _sliding(off.model)
    on = _state()
    with _cpu_profile():
        loss_on, _ = _train_step(on)
        map_on = _sliding(on.model)
    assert torch.equal(loss_on, loss_off)
    for (name, p_on), p_off in zip(on.model.named_parameters(), off.model.parameters()):
        assert torch.equal(p_on, p_off), name
    np.testing.assert_array_equal(map_on, map_off)


@pytest.fixture(scope="module")
def traced():
    """One step and one frame under a CPU profiler: the record and the
    profiler's events."""
    state = _state()
    tracing.clear()
    with _cpu_profile() as prof:
        _train_step(state)
        _sliding(state.model)
    return tracing.records(), prof.profiler.kineto_results.events()


@pytest.mark.parametrize("outer,children", [(STEP, STEP_CHILDREN),
                                            (SLIDING, SLIDING_CHILDREN)])
def test_a_unit_nests_its_spans(traced, outer, children):
    recs = [r for r in traced[0] if r.name == outer or r.name in children]
    assert sorted(r.name for r in recs) == sorted({outer} | children)
    assert _parents(recs) == {outer: None, **dict.fromkeys(children, outer)}
    assert len({r.unit for r in recs}) == 1
    parent = next(r for r in recs if r.name == outer)
    for r in recs:
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns, r.name
        assert r.device_ms is None  # no timing events on the CPU
    assert len({r.unit for r in traced[0]}) == 2  # the step's and the frame's


def test_host_times_are_on_the_profilers_clock(traced):
    """Each span's host interval lies within 1 ms of its ``record_function``
    event's, matched by name in order."""
    recs, events = traced
    ranges = {}
    for ev in sorted(events, key=lambda e: e.start_ns()):
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("segtpu_torch."):
            ranges.setdefault(ev.name(), []).append(ev)
    slack = 1_000_000
    for name in {r.name for r in recs}:
        mine = [r for r in recs if r.name == name]
        assert len(ranges[name]) == len(mine), name
        for r, ev in zip(mine, ranges[name]):
            assert ev.start_ns() - slack <= r.start_ns, name
            assert r.end_ns <= ev.start_ns() + ev.duration_ns() + slack, name


class _Loader:
    def __init__(self, n):
        self.batches = [(np.full((2, 4), i, np.float32),) for i in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_data_wait_once_per_batch_taken():
    """A span a take from the queue: one a batch, and one more where the
    consumer waits for the loader's end."""
    def waits(taken, loader):
        tracing.clear()
        with _cpu_profile():
            got = []
            for (batch,) in DevicePrefetcher(loader, "cpu"):
                got.append(batch)
                if len(got) == taken:
                    break
        recs = tracing.records()
        assert all(r.name == "segtpu_torch.data.wait" and r.parent is None for r in recs)
        return len(recs), len({r.unit for r in recs})

    assert waits(2, _Loader(4)) == (2, 2)
    assert waits(None, _Loader(3)) == (4, 4)


def test_the_record_stops_growing_at_its_limit():
    tracing.clear()
    with _cpu_profile():
        for _ in range(tracing.LIMIT + 5):
            with tracing.span("segtpu_torch.x"):
                pass
    recs = tracing.records()
    assert len(recs) == tracing.LIMIT
    assert recs[-1].unit - recs[0].unit == tracing.LIMIT - 1
    tracing.clear()
    assert tracing.records() == []

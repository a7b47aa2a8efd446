"""The readers of the port's spans (``program_spans.py``) on a synthetic
record: the first traced slice's mean a unit, nothing for the other traffic
kind or a program without spans, and a count mismatch said and refused."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from segbench import cells, program_spans
from segtpu_torch.tracing import Record

UNITS = 2
#: reader -> (traffic kind, the spans it reads)
READERS = {
    "prep_ms.train": ("train_step", ["segtpu_torch.step.prep"]),
    "forward_ms.train": ("train_step", ["segtpu_torch.step.forward"]),
    "backward_ms.train": ("train_step", ["segtpu_torch.step.backward"]),
    "optimizer_ms.train": ("train_step", ["segtpu_torch.step.optimizer"]),
    "seg_stats_ms.train": ("train_step", ["segtpu_torch.step.seg_stats"]),
    "upload_ms.eval": ("sliding_eval", ["segtpu_torch.sliding.upload"]),
    "forward_ms.eval": ("sliding_eval", ["segtpu_torch.sliding.forward"]),
    "canvas_ms.eval": ("sliding_eval", ["segtpu_torch.sliding.tiles",
                                        "segtpu_torch.sliding.canvas"]),
}
CHILDREN = {
    "train_step": ["prep", "forward", "backward", "optimizer", "seg_stats"],
    "sliding_eval": ["upload", "tiles", "forward", "canvas"],
}


def synthetic(kind: str, slices: int = program_spans.SLICES):
    """``slices`` of :data:`UNITS` units; a child's device ms is 1 + its
    place among the children, plus 10 in the first slice's second unit and
    100 in every later slice, so that another slice's units would show."""
    outer = program_spans.OUTER[kind]
    recs = []
    for u in range(slices * UNITS):
        extra = 100.0 if u >= UNITS else 10.0 * u
        recs.append(Record(outer, None, 7 + u, 0, 1, 50.0))
        for i, child in enumerate(CHILDREN[kind]):
            recs.append(Record(f"{outer}.{child}", outer, 7 + u, 0, 1, 1.0 + i + extra))
    return recs


def ctx(kind: str):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"kind": kind}),
                           trace=SimpleNamespace(units=UNITS))


def expected(kind: str, spans) -> float:
    places = [CHILDREN[kind].index(s.rsplit(".", 1)[1]) for s in spans]
    return sum(2 * (1.0 + p) + 10.0 for p in places) / UNITS


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_the_first_slices_mean(name, monkeypatch):
    kind, spans = READERS[name]
    monkeypatch.setattr(program_spans, "records", lambda: synthetic(kind))
    reader = cells.layer_readers([name])[name]
    assert reader.UNIT == "ms"
    assert reader.read(ctx(kind)) == pytest.approx(expected(kind, spans))
    other = next(k for k in CHILDREN if k != kind)
    assert reader.read(ctx(other)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_count_mismatch_is_said_and_read_as_nothing(name, monkeypatch, capsys):
    kind, _ = READERS[name]
    monkeypatch.setattr(program_spans, "records", lambda: synthetic(kind, slices=1))
    reader = cells.layer_readers([name])[name]
    assert reader.read(ctx(kind)) is None
    assert name in capsys.readouterr().err


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert program_spans.mean_ms(ctx("train_step"), "train_step",
                                 ["segtpu_torch.step.prep"], "prep_ms.train") is None


def test_spans_without_device_times_give_nothing(monkeypatch):
    recs = [r._replace(device_ms=None) for r in synthetic("train_step")]
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    assert program_spans.mean_ms(ctx("train_step"), "train_step",
                                 ["segtpu_torch.step.prep"], "prep_ms.train") is None

"""The benchmark's files load and resolve by name, and agree with
BENCHMARK.json."""

from __future__ import annotations

import json
import textwrap

import pytest
import torch

from segbench import cells, run
from segbench.cells import ROOT, Cell, read_json

CELLS = sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = Cell(name)
    assert cell.chips in (1, 4)
    assert cell.name == f"{cell.spec['config']}.{cell.spec['traffic']}"
    kind = cell.kind_module()
    assert hasattr(kind, "Session")
    assert cell.config["reference"]
    assert cell.limits, "every cell states the limits of its check"


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_config_files_load(path):
    config = read_json(path)
    for key in ("source", "reduced", "arch", "num_classes", "reference", "norm_stats"):
        assert key in config


@pytest.mark.parametrize("path", sorted((ROOT / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_files_name_a_kind_module(path):
    assert (ROOT / "traffic" / f"{read_json(path)['kind']}.py").exists()


def test_every_layer_metric_has_a_reader():
    readers = cells.layer_readers()
    assert readers
    for name, module in readers.items():
        assert callable(module.read) and module.UNIT, name


def test_a_cell_in_another_directory_is_found(tmp_path):
    spec = read_json(ROOT / "workloads" / f"{CELLS[0]}.json")
    (tmp_path / "extra.json").write_text(json.dumps(spec))
    cell = Cell("extra", tmp_path)
    assert cell.config == Cell(CELLS[0]).config
    with pytest.raises(FileNotFoundError):
        Cell("no_such_cell", tmp_path)


#: a traffic kind of its own, with an end-to-end metric no other kind has
COUNTING_KIND = textwrap.dedent('''
    import time

    UNITS = {"counted_ops_per_s": "ops/s"}


    class Session:
        unit = "op"

        def __init__(self, cell, seed, device, subject="program"):
            self.n = cell.traffic["ops"]
            self.window_units, self.window_s = 0, 0.0
            self.memory_peak_bytes, self.attempted = 0, 0

        def window(self, seconds):
            t0 = time.perf_counter()
            total = sum(range(self.n))
            self.window_units, self.window_s = self.n, time.perf_counter() - t0
            self.attempted, self.total = self.n, total
            return {"counted_ops_per_s": self.n / max(self.window_s, 1e-9)}

        def release(self):
            pass

        def check(self):
            return {"sum_gap": abs(self.total - self.n * (self.n - 1) // 2)}
    ''')


@pytest.mark.parametrize("name", CELLS)
def test_traffic_units_agree_with_benchmark_json(name):
    bench = {m["name"]: m["unit"] for m in read_json(BENCHMARK)["end_to_end"]}
    units = Cell(name).kind_module().UNITS
    chosen = cells.benchmark_metrics(name, ROOT.parent)["end_to_end"]
    assert {m["name"] for m in chosen} - {"setup_s"} == set(units)
    assert all(bench[n] == u for n, u in units.items())


def test_a_new_traffic_kind_runs_without_an_edit(tmp_path, monkeypatch):
    """A cell of a new kind, with a metric no file names, runs from new
    files alone: its units come from its module."""
    for sub in ("configs", "traffic", "workloads", "layer_metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps({"num_classes": 2}))
    (tmp_path / "traffic" / "counting.py").write_text(COUNTING_KIND)
    (tmp_path / "traffic" / "count_100.json").write_text(
        json.dumps({"kind": "counting", "ops": 100}))
    (tmp_path / "workloads" / "tiny.count_100.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "count_100", "chips": 1, "why": "a test",
         "limits": {"sum_gap": 0}}))
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    result = run.run_cell(Cell("tiny.count_100"), 2**31 + 5, 0.1, False, torch.device("cpu"))
    assert result["correct"] and result["attempted"] == 100
    assert result["metrics"]["counted_ops_per_s"]["unit"] == "ops/s"
    assert result["metrics"]["setup_s"]["unit"] == "s"


def test_benchmark_json_agrees_with_the_files():
    bench = read_json(BENCHMARK)
    assert bench["paths"] == ["segbench"]
    for config in bench["configs"]:
        assert (ROOT.parent / config["file"]).exists()
        assert read_json(ROOT.parent / config["file"])["reduced"] == config["reduced"]
    names = {w["name"] for w in bench["workloads"]}
    assert names == set(CELLS)
    for w in bench["workloads"]:
        spec = read_json(ROOT / "workloads" / f"{w['name']}.json")
        assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    readers = cells.layer_readers()
    for metric in bench["per_layer"]:
        assert metric["name"] in readers
        assert set(metric["workloads"]) <= names
    for name in names:
        chosen = cells.benchmark_metrics(name, ROOT.parent)
        e2e = {m["name"] for m in chosen["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and chosen["per_layer"]

"""Finding a cell's files by name.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json``: its
configuration's name, its traffic mix's name, the chips it needs, why it
exists and the limits of its check. The configuration is
``configs/<config>.json`` and the traffic mix ``traffic/<traffic>.json``,
whose ``kind`` names the module ``traffic/<kind>.py``. A per-layer metric
``<name>`` is read by ``layer_metrics/<name>.py``. Which metrics a cell
reports is ``BENCHMARK.json``'s word, at the root of the checkout: its
``end_to_end`` and ``per_layer`` entries whose ``workloads`` list the cell,
or that have no such list and move (per layer) an end-to-end metric the
cell reports. A cell that ``BENCHMARK.json`` does not list reports every
metric its traffic module and the readers give.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

ROOT = Path(__file__).resolve().parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell's files, resolved. ``workloads_dir`` holds the cell file
    (``segbench/workloads`` unless a caller names another)."""

    def __init__(self, name: str, workloads_dir: Optional[Path] = None):
        path = Path(workloads_dir or ROOT / "workloads") / f"{name}.json"
        if not path.exists():
            raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
        self.name = name
        self.spec = read_json(path)
        self.config = read_json(ROOT / "configs" / f"{self.spec['config']}.json")
        self.traffic = read_json(ROOT / "traffic" / f"{self.spec['traffic']}.json")
        self.chips = int(self.spec["chips"])
        self.limits = dict(self.spec.get("limits", {}))

    def kind_module(self) -> ModuleType:
        kind = self.traffic["kind"]
        return load_module(ROOT / "traffic" / f"{kind}.py", f"segbench.traffic.{kind}")


def benchmark_metrics(cell: str, root: Path) -> Optional[dict]:
    """``{"end_to_end": [...], "per_layer": [...]}``: the entries of
    ``root/BENCHMARK.json`` that ``cell`` reports, or None where the file
    is absent or does not list the cell."""
    path = root / "BENCHMARK.json"
    if not path.exists():
        return None
    bench = read_json(path)
    if cell not in {w["name"] for w in bench["workloads"]}:
        return None

    def listed(metric):
        return "workloads" not in metric or cell in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if listed(m) and m["moves"] in names]
    return {"end_to_end": e2e, "per_layer": layer}


def layer_readers(names: Optional[List[str]] = None) -> dict:
    """``{metric: reader module}`` of ``layer_metrics/``, all of them or
    those ``names``. A reader has ``UNIT`` and ``read(ctx)``, which returns
    the metric's value or None where the run gives it nothing to read."""
    found = sorted(p.stem for p in (ROOT / "layer_metrics").glob("*.py"))
    if names is not None:
        missing = set(names) - set(found)
        if missing:
            raise FileNotFoundError(f"no reader for {sorted(missing)} in layer_metrics/")
        found = [n for n in found if n in names]
    return {n: load_module(ROOT / "layer_metrics" / f"{n}.py",
                           f"segbench.layer_metrics.{n}") for n in found}

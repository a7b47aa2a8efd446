"""What a run loads: no module whose top-level name is jax, jaxlib, flax,
optax or segtpu; and the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from segbench.cells import ROOT

LOAD_ALL = """
import json, sys
from segbench import calibrate, cells, check, counts, faults, program, run, trace, weights
from segbench.reference import precision, pspnet, sliding, train, upernet
for name in sorted(p.stem for p in (cells.ROOT / "workloads").glob("*.json")):
    cells.Cell(name).kind_module()
cells.layer_readers()
import segtpu_torch.inference_lib, segtpu_torch.core.steps, segtpu_torch.core.state
import segtpu_torch.losses, segtpu_torch.models, segtpu_torch.ops.conv_wgrad
print(json.dumps(run.banned_modules()))
"""

REFERENCE_ONLY = """
import json, sys
import segbench.reference
from segbench.reference import layers, precision, pspnet, resnet, sliding, train, upernet
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "segtpu_torch")))
"""


def _run(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_nothing_banned_is_loaded():
    assert _run(LOAD_ALL) == []


def test_reference_loads_nothing_of_the_port():
    assert _run(REFERENCE_ONLY) == []


def test_banned_names_are_whole_top_level_names(monkeypatch):
    from segbench import run

    monkeypatch.setitem(sys.modules, "segtpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.x", sys)
    assert "segtpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in run.banned_modules()

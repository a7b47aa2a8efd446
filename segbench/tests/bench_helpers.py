"""Small cells for the CPU tests: the benchmark's cells at a crop, batch and
frame a test run can hold, written to a temporary directory."""

from __future__ import annotations

from pathlib import Path

from segbench.cells import ROOT, Cell

SMALL = {
    "train_step": {"batch": 4, "crop": 65, "label_block": 8, "trace_steps": 1},
    "sliding_eval": {"frame": [64, 160], "pool": 2, "max_tile_batch": 4, "warmup_frames": 1,
                     "sampled_answers": 2, "trace_frames": 1},
}


def small_cell(name: str, tmp: Path, compute_dtype: str = "float32") -> Cell:
    """The cell ``name`` at a small size in ``compute_dtype``, with its own
    limits, from a cell file in ``tmp``."""
    small = f"small_{name}"
    (Path(tmp) / f"{small}.json").write_text((ROOT / "workloads" / f"{name}.json").read_text())
    cell = Cell(small, tmp)
    cell.traffic.update(SMALL[cell.traffic["kind"]], compute_dtype=compute_dtype)
    return cell

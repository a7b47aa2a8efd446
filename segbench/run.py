"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m segbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA GPUs as the
cell asks for (``segbench/workloads/<cell>.json``); without them it exits
with code 2 and prints no result. The run makes its inputs and weights from
``--seed`` (set-up, timed as ``setup_s`` from the start of the process),
measures for ``--seconds`` (the cell's end-to-end metrics), and with
``--trace 1`` then traces a fixed slice of units for the per-layer metrics
(``layer_metrics/``), the device's busy time and a breakdown. Then it frees
the program's state and checks its outputs against the plain reference:
each number compared is printed beside its limit on standard error and
under ``check``, the last key of the result. A run in which ``jax``,
``jaxlib``, ``flax``, ``optax`` or ``segtpu`` (whole top-level module
names) was imported exits with code 3 and prints no result.

Build and kernel caches go to fixed directories under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "segtpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache under ``build/`` of the checkout."""
    base = CHECKOUT / "build" / "segbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")


def banned_modules() -> list:
    """The loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def chip_problem(chips: int):
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "segbench: no CUDA device is visible"
    if torch.cuda.device_count() < chips:
        return f"segbench: the cell needs {chips} GPUs, {torch.cuda.device_count()} visible"
    return None


class LayerContext:
    """What a per-layer reader sees: the cell, the traced slice and the
    window's units and seconds."""

    def __init__(self, cell, trace, session):
        self.cell = cell
        self.trace = trace
        self.units = session.window_units
        self.seconds = session.window_s


def _units(chosen, kind: str) -> dict:
    return {m["name"]: m["unit"] for m in chosen[kind]} if chosen else {}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``; the result line's object."""
    from segbench import check
    from segbench.cells import benchmark_metrics, layer_readers

    chosen = benchmark_metrics(cell.name, CHECKOUT)
    kind = cell.kind_module()
    session = kind.Session(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    print(f"segbench: {cell.name} seed {seed} set-up {setup_s:.3f} s", file=sys.stderr)
    e2e = session.window(seconds)
    e2e["setup_s"] = setup_s
    print(f"segbench: window {session.window_units} {session.unit}s in "
          f"{session.window_s:.3f} s: {e2e}", file=sys.stderr)
    dev = device_info(device, cell.chips, session.memory_peak_bytes)
    metrics, breakdown = {}, None
    if trace:
        tr = session.traced()
        units = _units(chosen, "per_layer")
        readers = layer_readers(list(units) if chosen else None)
        ctx = LayerContext(cell, tr, session)
        for name, read in readers.items():
            value = read.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units.get(name, read.UNIT)}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        print(f"segbench: traced {tr.units} {session.unit}s, {len(tr.ops)} device ops "
              f"({sum(1 for op in tr.ops if op.host_op)} with their host op), "
              f"counters {tr.counters}", file=sys.stderr)
        breakdown = {"device_ops": [[n, s] for n, s in tr.top_ops()],
                     "idle_gaps": [[n, s] for n, s in tr.idle_gaps()]}
        for cat, s in sorted(tr.by_category().items(), key=lambda kv: -kv[1]):
            print(f"segbench: traced {1e3 * s / tr.units:.4f} ms/{session.unit} {cat}",
                  file=sys.stderr)
    else:
        # BENCHMARK.json's units, or for a cell it does not list the traffic
        # module's own
        units = _units(chosen, "end_to_end") if chosen else {**kind.UNITS, "setup_s": "s"}
        names = list(units) if chosen else list(e2e)
        metrics = {n: {"value": e2e[n], "unit": units[n]} for n in names}
    session.release()
    numbers = session.check()
    correct, table = check.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": session.attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    banned = banned_modules()
    if banned:
        print(f"segbench: the run imported {', '.join(banned)}", file=sys.stderr)
        raise SystemExit(3)
    check.print_table(numbers, table)
    return result


def device_info(device, count: int, peak: int) -> dict:
    import torch

    from segbench import devices

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak, "power_limit_w": devices.power_limit_w()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    import torch

    from segbench.cells import Cell

    cell = Cell(args.workload)
    problem = chip_problem(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

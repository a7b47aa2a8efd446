"""Readings of a cell's check over many seeds, for setting its limits.

    python3 -m segbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--faults a,b] [--out FILE]

On a card, at the cell's own size, in one process: for each of ``--seeds``
the program's checked work (a training cell's checked steps; an evaluation
cell's ``sampled_answers`` frames) held against the reference; for each of
``--control-seeds`` the control (the reference in float8 in the program's
place); for each of ``--witness-seeds`` the program computing in float32, a
second witness of where its gaps come from; for each of ``--fault-seeds``
each fault of ``faults.py`` that the cell's kind can have (or those of
``--faults``), planted in the program. No window is measured. Each
reading is a JSON line on standard output (and appended to ``--out``): the
subject, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def reading(cell, seed: int, device, subject: str = "program"):
    """(the numbers compared, the check's diagnostics) of one seed."""
    session = cell.kind_module().Session(cell, seed, device, subject=subject)
    if session.unit == "frame":
        for _ in range(cell.traffic["sampled_answers"]):
            session._unit()
    session.release()
    numbers = session.check()
    return numbers, getattr(session, "diagnostics", {})


def main(argv=None) -> int:
    from segbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", type=lambda t: [s for s in t.split(",") if s],
                   help="the faults to plant (all the kind's by default)")
    p.add_argument("--witness-seeds", type=_ints, default=[],
                   help="seeds of the program run in float32, a second witness")
    p.add_argument("--out")
    args = p.parse_args(argv)
    run.set_cache_dirs()
    import torch

    from segbench.cells import Cell
    from segbench.faults import FAULTS

    cell = Cell(args.workload)
    problem = run.chip_problem(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    device = torch.device("cuda")
    faults = FAULTS[cell.traffic["kind"]]
    faults = {n: faults[n] for n in args.faults} if args.faults else faults
    plan = ([("program", s, None) for s in args.seeds]
            + [("program:float32", s, None) for s in args.witness_seeds]
            + [("control", s, None) for s in args.control_seeds]
            + [(f"fault:{n}", s, f) for n, f in faults.items()
               for s in args.fault_seeds])
    for subject, seed, fault in plan:
        t0 = time.perf_counter()
        if fault is not None:
            with fault():
                numbers, diagnostics = reading(cell, seed, device)
        elif subject == "program:float32":
            witness = Cell(args.workload)
            witness.traffic["compute_dtype"] = "float32"
            numbers, diagnostics = reading(witness, seed, device)
        else:
            numbers, diagnostics = reading(cell, seed, device, subject)
        line = json.dumps({"cell": cell.name, "subject": subject, "seed": seed,
                           "numbers": numbers, "diagnostics": diagnostics,
                           "seconds": time.perf_counter() - t0,
                           "card": torch.cuda.get_device_name(device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

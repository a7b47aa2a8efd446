"""The numbers that decide ``correct``, and how they are judged.

A training cell compares the program's first steps with the reference's
(``traffic/train_step.py``): each step's loss, the first step's outputs,
the norm of each leaf's first gradient, and the norm of each leaf's change
over the checked steps; and the widest gap of a dropout call's drop rate
from the rate the traffic states (the reference takes the program's masks,
so only this holds the rate they were drawn at).
A norm is compared by its gap, ``|program - reference|`` over the larger of
the reference's norm of that leaf and of the median leaf, and a number is
the worst leaf's gap. Leaves whose reference gradient is under a
thousandth of the median leaf's move by rounding alone (a bias that a
batch norm cancels); their change is left out.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, Optional, Tuple

#: leaves whose first reference gradient is under this share of the median
#: leaf's are left out of the change
NEGLIGIBLE_GRADIENT = 1e-3


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap over ``leaves`` (all of the reference's by default);
    the median leaf is taken over all of them."""
    median = statistics.median(reference.values())
    return {name: abs(program.get(name, math.nan) - reference[name])
            / max(reference[name], median, 1e-30)
            for name in (reference if leaves is None else leaves)}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """(the largest gap, its leaf); NaN wins."""
    name = max(gaps, key=lambda n: (math.isnan(gaps[n]), gaps[n]))
    return gaps[name], name


def moving_leaves(first_grads: Dict[str, float]) -> list:
    """The leaves whose first gradient is at least
    :data:`NEGLIGIBLE_GRADIENT` of the median leaf's."""
    median = statistics.median(first_grads.values())
    return [n for n, g in first_grads.items() if g >= NEGLIGIBLE_GRADIENT * median]


def output_gap(program: Dict[str, "torch.Tensor"], reference: Dict[str, "torch.Tensor"]) -> float:
    """The largest ``|program - reference| / |reference|`` (Euclidean norms)
    over the outputs (``out``, ``aux``); NaN where the program lacks one or
    gives another shape."""
    gaps = []
    for name, ref in reference.items():
        got = program.get(name)
        if got is None or got.shape != ref.shape:
            return math.nan
        gaps.append(float((got.double() - ref.double()).norm() / ref.double().norm()))
    return max(gaps)


def rate_gap(rates, p: float) -> float:
    """The largest ``|rate - p|`` over the dropout calls; NaN where there
    were none."""
    return max((abs(r - p) for r in rates), default=math.nan)


def loss_gap(program, reference) -> float:
    """The largest relative gap of the steps' losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit"}}``) over the numbers the cell
    states a limit for: correct when each is finite and at most its limit.
    The others are not compared (printed beside the table); a cell that
    states no limit for any number raises."""
    table = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items() if n in limits}
    if not table:
        raise KeyError(f"the cell states no limit for any of {sorted(numbers)}")
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in table.values())
    return ok, table


def print_table(numbers: Dict[str, float], table: dict, stream=sys.stderr) -> None:
    """The numbers not compared, then each compared number beside its
    limit, one a line."""
    for name, value in numbers.items():
        if name not in table:
            print(f"check {name} {value!r} not compared", file=stream, flush=True)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=stream,
              flush=True)

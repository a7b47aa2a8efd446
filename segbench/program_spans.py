"""The port's own spans over a traced run, for the per-layer metrics that
read them.

While ``torch.profiler`` records, the port's train step and sliding window
run in spans (``segtpu_torch/tracing.py``): the outer span
``segtpu_torch.step`` or ``segtpu_torch.sliding`` of each unit, step or
frame, and its children, each with its device milliseconds between two
timing events on the stream. Both of ``trace.profile``'s slices record them
(the device-only slice turns the profiler on as well), so a traced run's
record holds :data:`SLICES` times the slice's units. A reader takes the
first slice's units, whose host the profiling of host ops did not slow.

A program without the spans (no ``segtpu_torch.tracing``) gives nothing to
read.
"""

from __future__ import annotations

import sys
from typing import Iterable, Optional

#: each traffic kind's outer span
OUTER = {"train_step": "segtpu_torch.step", "sliding_eval": "segtpu_torch.sliding"}
#: the traced slices whose units the record holds
SLICES = 2


def records():
    """The port's record of finished spans, or None where the program has
    no spans."""
    try:
        from segtpu_torch import tracing
    except ImportError:
        return None
    return tracing.records()


def mean_ms(ctx, kind: str, names: Iterable[str], metric: str) -> Optional[float]:
    """Device ms a unit inside the spans ``names``, over the first traced
    slice's units of a ``kind`` cell; None for another kind, a program
    without spans, or a record that holds another count of units (said on
    standard error)."""
    if ctx.cell.traffic["kind"] != kind:
        return None
    recs = records()
    if recs is None:
        return None
    outer, units = OUTER[kind], ctx.trace.units
    ids = sorted(r.unit for r in recs if r.name == outer and r.parent is None)
    if len(ids) != SLICES * units:
        print(f"{metric}: the record holds {len(ids)} {outer} spans, "
              f"{SLICES} slices of {units} expected", file=sys.stderr)
        return None
    first, names = set(ids[:units]), set(names)
    picked = [r.device_ms for r in recs if r.unit in first and r.name in names]
    if not picked or None in picked:
        return None
    return sum(picked) / units

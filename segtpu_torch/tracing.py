"""The port's spans: named ranges of its train step, sliding window and
loader, on while ``torch.profiler`` records and free otherwise.

``span(name)`` is a context manager. Without a profiler (the
``torch.autograd._profiler_enabled()`` check at each entry) it is one shared
null context: no ``record_function``, no event, nothing recorded. While a
profiler records, it enters ``torch.profiler.record_function(name)``, so the
span sits in the profiler's trace, on its clock, above the operations it
launched, and it appends an entry to an in-memory record:

- ``name``; ``parent``, the enclosing port span's name on this thread (or
  None); ``unit``, the sequence number of the outermost enclosing port
  span, shared by every span of one step or frame;
- ``start_ns`` and ``end_ns``, the host's entry and exit in Unix
  nanoseconds (``time.time_ns``, the clock to which the profiler turns its
  events' stamps), taken inside the ``record_function`` range;
- on a CUDA device, two timing events recorded on the current stream at the
  span's edges: ``device_ms``, their distance. The stream runs in order, so
  the edges divide the device's timeline among the spans: a device gap
  inside a span's interval is time the device waited while the host was in
  that span or blocked in it, and a gap between two children falls in the
  parent's self time.

:func:`records` returns the finished entries, oldest first, each span's
``device_ms`` resolved (waiting on its end event); :func:`clear` empties the
record. The record keeps the last :data:`LIMIT` entries, so a long profile
cannot grow it without end.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

#: entries the record keeps (the newest)
LIMIT = 4096

_OFF = contextlib.nullcontext()
_record: collections.deque = collections.deque(maxlen=LIMIT)
_units = itertools.count()
_open = threading.local()  # .stack: this thread's open entries, innermost last
_enabled = torch.autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    unit: int
    start_ns: int  # host, Unix ns
    end_ns: int
    device_ms: Optional[float]  # None off a CUDA device


class _Entry:
    __slots__ = ("name", "parent", "unit", "start", "end", "events", "device_ms")

    def __init__(self, name, parent, unit):
        self.name, self.parent, self.unit = name, parent, unit
        self.start = self.end = self.events = self.device_ms = None


class _Span:
    __slots__ = ("name", "entry", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        entry = (_Entry(self.name, outer.name, outer.unit) if outer
                 else _Entry(self.name, None, next(_units)))
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        entry.start = time.time_ns()
        if torch.cuda.is_initialized():
            entry.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            entry.events[0].record()
        stack.append(entry)
        _record.append(entry)
        self.entry = entry
        return self

    def __exit__(self, *exc):
        entry = self.entry
        if entry.events is not None:
            entry.events[1].record()
        entry.end = time.time_ns()
        _open.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around a part of the port: the profiler's range
    ``name`` and an entry of the record while a profiler records, nothing
    otherwise."""
    if not _enabled():
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """The record's finished spans, oldest first, with their device ms."""
    done = [e for e in list(_record) if e.end is not None]
    for e in done:
        if e.events is not None:
            e.events[1].synchronize()
            e.device_ms = e.events[0].elapsed_time(e.events[1])
            e.events = None
    return [Record(e.name, e.parent, e.unit, e.start, e.end, e.device_ms) for e in done]


def clear() -> None:
    """Empty the record."""
    _record.clear()

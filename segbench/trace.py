"""Traced slices: ``torch.profiler`` over a fixed number of the window's
units (steps or frames), after the window, reduced to what the per-layer
readers need.

A first slice traces the device alone: the device was busy for the union
of its operations' intervals (kernels, copies and fills; not annotation
ranges), out of the slice's length on the host's clock. Profiling the
host's ops as well slows the host, which would show as idle device time,
so a second slice does that: its device operations come with their names,
intervals, the host op that launched each (the profiler's correlation) and
the innermost of the benchmark's spans (``torch.profiler.record_function``
names starting with ``segbench.``) that held that op. An idle gap of the
second slice is named by the span and the host op that launched the
operation ending it. Kernel categories, by name, first match wins, are those of
``chip_smoke.py`` (copied, not imported).
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

#: kernel-name substring -> category of the traced step, first match wins
CATEGORIES = [
    ("stem_wgrad", "stem weight gradient (segtpu_torch CUDA kernel)"),
    ("Sort", "sort (Lovász)"),
    ("sort", "sort (Lovász)"),
    ("Scan", "cumsum (Lovász)"),
    ("scan", "cumsum (Lovász)"),
    ("scatter_gather", "gather (Lovász, CE)"),
    ("flat_wgrad", "flat-row conv wgrad (segtpu_torch CUDA kernel)"),
    ("flat_dgrad", "flat-row conv dgrad (segtpu_torch CUDA kernel)"),
    ("adaptive_average", "adaptive average pool (PSP pyramid)"),
    ("upsample", "bilinear resize"),
    ("batch_norm", "batch norm"),
    ("max_pool", "max pool"),
    ("xmma", "convolution (cuDNN)"),
    ("conv", "convolution (cuDNN)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("gemm", "matmul (cuBLAS)"),
    ("reduce_kernel", "reductions (loss, stats)"),
    ("CatArray", "concat"),
    ("cat", "concat"),
    ("elementwise", "elementwise and copies"),
    ("copy", "elementwise and copies"),
]
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
SPAN_PREFIX = "segbench."


def category(name: str) -> str:
    if name.startswith(COPY_PREFIXES):
        return "host-device copies and fills"
    return next((cat for key, cat in CATEGORIES if key in name), "other")


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float
    span: str  # the innermost segbench span the launching op ran in, or ""
    host_op: str  # the launching host op, or ""

    @property
    def us(self) -> float:
        return self.end_us - self.start_us

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(COPY_PREFIXES)


class Trace(NamedTuple):
    ops: List[DeviceOp]
    units: int  # steps or frames traced
    window_s: float  # host seconds of the device-only slice, synchronize to synchronize
    busy_s: float  # seconds of that slice in which an operation ran on the device
    counters: Dict[str, float]  # the program's counters' increase over the traced slice

    def kernel_s(self, pred: Callable[[DeviceOp], bool]) -> float:
        return sum(op.us for op in self.ops if op.is_kernel and pred(op)) / 1e6

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for op in self.ops:
            cat = category(op.name)
            out[cat] = out.get(cat, 0.0) + op.us / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` device operations that took most time, summed by name."""
        sums: Dict[str, float] = {}
        for op in self.ops:
            sums[op.name] = sums.get(op.name, 0.0) + op.us / 1e6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle time between device operations, summed by what the host
        launched next (span and op), the largest ``n``."""
        spans = _union(self.ops)
        firsts = sorted(self.ops, key=lambda op: op.start_us)
        sums: Dict[str, float] = {}
        j = 0
        for (_, end), (start, _) in zip(spans, spans[1:]):
            while firsts[j].start_us < start:
                j += 1
            nxt = firsts[j]
            key = f"{nxt.span or 'no span'} > {nxt.host_op or 'unknown op'}"
            sums[key] = sums.get(key, 0.0) + (start - end) / 1e6
        return sorted(sums.items(), key=lambda kv: -kv[1])[:n]


def _union(ops: List[DeviceOp]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for op in sorted(ops, key=lambda o: o.start_us):
        if out and op.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end_us)
        else:
            out.append([op.start_us, op.end_us])
    return [(a, b) for a, b in out]


def _end_ns(ev) -> int:
    return ev.start_ns() + ev.duration_ns()


def device_ops(kineto_events) -> List[DeviceOp]:
    """The device operations of a profiler's kineto events, each with the
    host op that launched it (the device event's linked correlation) and
    the innermost benchmark span that held that op."""
    from torch.autograd import DeviceType

    hosts, spans, device = {}, [], []
    for ev in kineto_events:
        if ev.device_type() == DeviceType.CPU:
            if ev.linked_correlation_id() == 0:
                hosts[ev.correlation_id()] = ev
                if ev.name().startswith(SPAN_PREFIX):
                    spans.append((ev.start_ns(), _end_ns(ev), ev.name()))
        elif ev.device_type() == DeviceType.CUDA and not (
                ev.is_user_annotation() or ev.name().startswith(SPAN_PREFIX)):
            device.append(ev)
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t: int) -> str:
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[i][1] >= t:
                return spans[i][2]
        return ""

    ops = []
    for ev in device:
        host = hosts.get(ev.linked_correlation_id())
        ops.append(DeviceOp(ev.name(), ev.start_ns() / 1e3, _end_ns(ev) / 1e3,
                            span_at(host.start_ns()) if host is not None else "",
                            host.name() if host is not None else ""))
    return ops


def _slice(unit, units: int, activities):
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ops = device_ops(prof.profiler.kineto_results.events())
    if not ops:
        raise RuntimeError("the traced slice shows no device operation")
    return ops, window_s


def profile(unit: Callable[[], None], units: int,
            counters: Optional[Callable[[], Dict[str, float]]] = None) -> Trace:
    """Two slices of ``units`` calls of ``unit``, each from a synchronize to
    a synchronize. The first traces the device alone, whose timeline the
    host's profiling would stretch: its busy time and length. The second
    traces the host's ops too: the device operations with their host ops
    and spans, and ``counters()`` read before and after."""
    from torch.profiler import ProfilerActivity

    light, window_s = _slice(unit, units, [ProfilerActivity.CUDA])
    read = counters or (lambda: {})
    before = read()
    ops, _ = _slice(unit, units, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    after = read()
    busy_s = sum(b - a for a, b in _union(light)) / 1e6
    return Trace(ops, units, window_s, busy_s, {k: after[k] - before[k] for k in after})

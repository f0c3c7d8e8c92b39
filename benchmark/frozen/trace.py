"""The traced window's reduction: device time by kernel and kind, the device's busy and idle time
over the timed window, and the idle gaps named by what the host was doing.

Copied from ``yet_another_mobilenet_series_tpu_torch/bench/trace_ops.py``: ``kernel_kind`` and
``_union_us`` (as ``union``). Changed on purpose: the idle share is
taken against the timed window's own span (its start and end on the host's wall clock, which is
the clock of the profiler's timestamps: the profiler's own host range around a window reads within
0.1 ms of it on an H100 machine), not against the span from the first profiler event to the last;
and events are read from the profiler in memory (``kineto_results``).
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import threading
import time
from dataclasses import dataclass, field

K1_KERNEL = "fused_dw_kernel"


def kernel_kind(name: str) -> str:
    """A device kernel's kind, for the breakdowns of a training or serving window."""
    if "fused_dw_kernel" in name:
        return "K1 fused depthwise"
    if "multi_tensor_apply" in name:
        return "optimizer+EMA (multi_tensor_apply)"
    if any(k in name for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")):
        return "convolutions and matmuls"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in name.lower() or "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and casts"
    return "elementwise"


def union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Spans:
    """The benchmark's own host spans around its calls into each layer: (name, start ns, end ns,
    thread) on the host's wall clock, kept in memory. Off, a span costs nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.records: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            rec = (name, t0, time.time_ns(), threading.get_ident())
            with self._lock:
                self.records.append(rec)


@dataclass
class Event:
    name: str
    start: float  # us on the wall clock
    end: float


def profiler_events(prof) -> list[Event]:
    """The device events of a finished ``torch.profiler.profile``, read from the profiler in
    memory: a profiler without that interface fails the traced run. Neither the benchmark nor the
    program opens a profiler range (``record_function``), so no host range is copied onto the
    device's timeline, and every event on it is a kernel, a copy or a memset."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), start, start + e.duration_ns() / 1e3))
    return out


@dataclass
class Digest:
    window_us: float
    busy_us: float
    per_name_us: collections.Counter = field(default_factory=collections.Counter)
    per_kind_us: collections.Counter = field(default_factory=collections.Counter)
    counts: collections.Counter = field(default_factory=collections.Counter)
    k1_records: int = 0
    k1_us: float = 0.0
    h2d_us: float = 0.0
    idle_by_host: collections.Counter = field(default_factory=collections.Counter)

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], us / 1e6] for n, us in self.per_name_us.most_common(10)],
                "idle_gaps": [[n, us / 1e6] for n, us in self.idle_by_host.most_common(10)]}


def digest(events: list[Event], spans: Spans, window_ns: tuple[int, int]) -> Digest:
    """Reduce a traced window: ``events`` the device's, ``window_ns`` the window's (start, end)
    on the wall clock, the clock of the events and of the host spans."""
    lo, hi = window_ns[0] / 1e3, window_ns[1] / 1e3
    dev = [(max(e.start, lo), min(e.end, hi), e.name) for e in events if e.end > lo and e.start < hi]
    d = Digest(window_us=hi - lo, busy_us=union((a, b) for a, b, _ in dev))
    for a, b, name in dev:
        d.per_name_us[name] += b - a
        d.per_kind_us[kernel_kind(name)] += b - a
        d.counts[name] += 1
        if K1_KERNEL in name:
            d.k1_records += 1
            d.k1_us += b - a
        if "HtoD" in name:
            d.h2d_us += b - a
    host = sorted((s / 1e3, t / 1e3, n) for n, s, t, _ in spans.records)
    active: list[tuple[float, str]] = []  # a heap of (end, name) of the spans open at the gap
    j = 0
    for a, b in gaps([(x, y) for x, y, _ in dev], lo, hi):
        while j < len(host) and host[j][0] <= a:
            heapq.heappush(active, (host[j][1], host[j][2]))
            j += 1
        while active and active[0][0] <= a:
            heapq.heappop(active)
        doing = sorted({n for _, n in active})
        d.idle_by_host["+".join(doing) if doing else "host outside the benchmark's spans"] += b - a
    return d

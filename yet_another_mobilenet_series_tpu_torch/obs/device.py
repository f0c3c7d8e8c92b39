"""Device telemetry: the torch twin of ``yet_another_mobilenet_series_tpu/obs/device.py``.

Two surfaces, with the metric names of docs/OBSERVABILITY.md:

- :func:`build_info` — the ``build_info`` labels: git sha, torch and CUDA
  versions, platform, and the GPU's name.
- :func:`record_compile` — ``obs.compile_seconds`` (histogram) and
  ``obs.compiles`` (counter): the serving engine's CUDA-graph captures,
  the twin of the JAX package's ``timed_compile``.
- :func:`install_memory_gauges` — PULL gauges read only when a snapshot is
  taken: ``host.rss_bytes`` from ``/proc/self/statm``,
  ``device.live_buffer_bytes`` (bytes held by live tensors of the caching
  allocator) and per-device ``device.bytes_in_use.d<i>`` /
  ``device.peak_bytes_in_use.d<i>`` / ``device.bytes_limit.d<i>`` from
  ``torch.cuda.memory_stats`` and the card's total memory. On a machine
  without a card only ``host.rss_bytes`` lands.

- :func:`record_cost` / :func:`flops_for` / :func:`bytes_for` — the per-key
  ``obs.cost_flops.<key>`` / ``obs.cost_bytes.<key>`` gauges and their
  lookups, the twins of the JAX package's (``obs/device.py:87,127,134``).
  XLA's ``cost_analysis`` has no counterpart here: :func:`forward_cost`
  counts from shapes, FLOPs as 2 x the MAC profiler's MACs
  (``utils/profiling.py``) per image x rows, and bytes as each conv's
  input and weights read once and its output written once.
- :func:`install_dispatch_efficiency_gauge` — ``serve.achieved_flops_per_s``,
  dispatched FLOPs over the measured ``serve.run_seconds`` (the JAX
  package's ``obs/device.py:209``).
- :func:`compile_report` — every recorded key's ``{flops, bytes,
  compile_seconds}``, read by the frontend's ``/varz`` and the watchdog's
  hang report (the JAX package's ``obs/device.py:143``).
- :class:`ProfilerCapture` — the serving frontend's ``/profile/start`` and
  ``/profile/stop`` window on ``torch.profiler``: single-flight under a
  lock, stopped by its owner's drain, and written as a Chrome trace that
  ``bench/trace_ops.py`` reads (the JAX package's ``obs/device.py:274``),
  with the program's spans of the window beside the profiler's records.
- :class:`DeviceInterval` / :func:`open_interval` / :func:`place` — the
  device side of ``obs/trace.py``'s device-timed spans: two timing events
  on a stream, placed on the wall clock after the window, never on the
  hot path.

:func:`build_info` names the card only in a process that has already
initialised CUDA, so that a process which owns no device (the fleet
supervisor) takes no context on the card by asking.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import TYPE_CHECKING

import torch

from .registry import MetricsRegistry, get_registry

if TYPE_CHECKING:
    from ..models.specs import Network

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> float:
    with open("/proc/self/statm") as f:
        return float(int(f.read().split()[1]) * _PAGE_SIZE)


def record_compile(seconds: float, registry: MetricsRegistry | None = None) -> None:
    """One compile event: its wall time into ``obs.compile_seconds`` and a
    tick of ``obs.compiles`` (a production server that compiles after
    warmup is a latency cliff; this makes it countable)."""
    reg = registry or get_registry()
    reg.histogram("obs.compile_seconds").observe(seconds)
    reg.counter("obs.compiles").inc()


# ---------------------------------------------------------------------------
# costs from shapes (the twin of XLA's cost_analysis gauges)
# ---------------------------------------------------------------------------

_COSTS: dict[str, dict] = {}
_COSTS_LOCK = threading.Lock()


def forward_cost(net: "Network", image_size: int, rows: int = 1, itemsize: int = 4) -> dict:
    """``{"flops", "bytes"}`` of ``rows`` images through ``net``'s forward at
    ``image_size``, counted from shapes, not measured: FLOPs are 2 x the MAC
    profiler's MACs per image x rows (convs and dense layers; BN and the
    activations are free, as the profiler counts them); bytes count every
    conv and dense layer's input and weights read once and its output
    written once, at ``itemsize`` bytes an element (the compute dtype's).
    What a kernel re-reads from cache, and the elementwise tails, are not
    counted."""
    from ..utils.profiling import profile_network

    macs = profile_network(net, image_size).total_macs
    elems = 0  # per image: activations in + out; weights are per call

    def conv(cin, cout, k, groups, hw, stride):
        nonlocal elems
        out_hw = (hw - 1) // stride + 1
        elems += hw * hw * cin + out_hw * out_hw * cout
        return k * k * (cin // groups) * cout + cout, out_hw

    weights, hw = conv(net.stem.in_channels, net.stem.out_channels, net.stem.kernel_size, net.stem.groups,
                       image_size, net.stem.stride)
    for blk in net.blocks:
        e = blk.expanded_channels
        if blk.has_expand:
            w, _ = conv(blk.in_channels, e, 1, 1, hw, 1)
            weights += w
        for _, k, g, _ in blk._branches():
            w, out_hw = conv(g, g, k, g, hw, blk.stride)
            weights += w
        if blk.se_channels:
            elems += 2 * e + 2 * blk.se_channels
            weights += 2 * e * blk.se_channels + e + blk.se_channels
        w, hw = conv(e, blk.out_channels, 1, 1, out_hw, 1)
        weights += w
    if net.head is not None:
        w, hw = conv(net.head.in_channels, net.head.out_channels, net.head.kernel_size, net.head.groups, hw,
                     net.head.stride)
        weights += w
    for dense in (net.feature, net.classifier):
        if dense is not None:
            elems += dense.in_features + dense.out_features
            weights += dense.in_features * dense.out_features + dense.out_features
    return {"flops": 2.0 * macs * rows, "bytes": float(itemsize * (elems * rows + weights))}


def record_cost(key: str, cost: dict, *, compile_seconds: float | None = None,
                registry: MetricsRegistry | None = None) -> dict:
    """Record ``cost`` (``{"flops", "bytes"}``, e.g. from :func:`forward_cost`)
    for executable ``key``: the ``obs.cost_flops.<key>`` /
    ``obs.cost_bytes.<key>`` gauges and the lookup table of
    :func:`flops_for` / :func:`bytes_for`. Returns the recorded entry."""
    reg = registry or get_registry()
    entry = {k: float(cost[k]) for k in ("flops", "bytes") if k in cost}
    if compile_seconds is not None:
        entry["compile_seconds"] = round(float(compile_seconds), 6)
    with _COSTS_LOCK:
        _COSTS[key] = entry
    if "flops" in entry:
        reg.gauge(f"obs.cost_flops.{key}").set(entry["flops"])
    if "bytes" in entry:
        reg.gauge(f"obs.cost_bytes.{key}").set(entry["bytes"])
    return entry


def flops_for(key: str) -> float:
    """Recorded FLOPs of executable ``key`` (0.0 when none was recorded): the
    engine's per-dispatch accounting lookup."""
    with _COSTS_LOCK:
        return float(_COSTS.get(key, {}).get("flops", 0.0))


def bytes_for(key: str) -> float:
    """Recorded bytes of executable ``key`` (0.0 when none was recorded): the
    engine joins it to every dispatch as ``serve.dispatched_bytes``."""
    with _COSTS_LOCK:
        return float(_COSTS.get(key, {}).get("bytes", 0.0))


def compile_report() -> dict:
    """``{key: {flops, bytes, compile_seconds}}`` for every recorded key,
    sorted: the ``executables`` of the frontend's ``/varz`` and of the
    watchdog's hang report."""
    with _COSTS_LOCK:
        return {k: dict(v) for k, v in sorted(_COSTS.items())}


def install_dispatch_efficiency_gauge(registry: MetricsRegistry | None = None) -> None:
    """``serve.achieved_flops_per_s`` pull gauge: the FLOPs the engine
    dispatched (``serve.dispatched_flops``) over the measured wall time
    those requests took (``serve.run_seconds`` sum). Idempotent."""
    reg = registry or get_registry()
    flops = reg.counter("serve.dispatched_flops")
    run = reg.histogram("serve.run_seconds")

    def achieved() -> float:
        return flops.value / run.total if run.total > 0 else 0.0

    reg.gauge("serve.achieved_flops_per_s").set_fn(achieved)


_MEM_INSTALLED = False
_MEM_LOCK = threading.Lock()


def install_memory_gauges(registry: MetricsRegistry | None = None) -> None:
    """Register the device/host memory pull gauges (idempotent). Reading
    ``torch.cuda.memory_stats`` is host-side allocator bookkeeping, so the
    gauges add no device synchronization."""
    global _MEM_INSTALLED
    with _MEM_LOCK:
        if _MEM_INSTALLED:
            return
        _MEM_INSTALLED = True
    reg = registry or get_registry()
    reg.gauge("host.rss_bytes").set_fn(_rss_bytes)
    if not torch.cuda.is_available():
        return
    n = torch.cuda.device_count()
    reg.gauge("device.live_buffer_bytes").set_fn(
        lambda: float(sum(torch.cuda.memory_allocated(i) for i in range(n))))
    for i in range(n):
        def stat(field: str, dev: int = i):
            return lambda: float(torch.cuda.memory_stats(dev).get(field, 0))

        reg.gauge(f"device.bytes_in_use.d{i}").set_fn(stat("allocated_bytes.all.current"))
        reg.gauge(f"device.peak_bytes_in_use.d{i}").set_fn(stat("allocated_bytes.all.peak"))
        total = float(torch.cuda.get_device_properties(i).total_memory)
        reg.gauge(f"device.bytes_limit.d{i}").set_fn(lambda t=total: t)


def _git_sha(repo_dir: str | None = None) -> str:
    """HEAD sha read straight from .git (no subprocess); "" when not a checkout."""
    d = repo_dir or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        git = os.path.join(d, ".git")
        with open(os.path.join(git, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head[:40]
        ref = head.split(None, 1)[1]
        ref_path = os.path.join(git, *ref.split("/"))
        if os.path.exists(ref_path):
            with open(ref_path) as f:
                return f.read().strip()[:40]
        with open(os.path.join(git, "packed-refs")) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 2 and parts[1] == ref:
                    return parts[0][:40]
    except OSError:
        pass
    return ""


def build_info(rank: int = 0, world: int = 1) -> dict:
    """Version-attribution labels for the ``build_info`` metric family, with
    this process's data-parallel ``rank`` and ``world`` size. The card's
    name needs CUDA initialised (``get_device_name`` would otherwise
    initialise it): a process that has not touched the card reports
    ``gpu_name`` "not initialised", and a serving process sets its labels
    again once its engine holds the device."""
    cuda = torch.cuda.is_available()
    if not cuda:
        gpu = "none"
    elif torch.cuda.is_initialized():
        gpu = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        gpu = "not initialised"
    return {
        "git_sha": _git_sha() or "unknown",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "platform": "cuda" if cuda else "cpu",
        "gpu_name": gpu,
        "rank": str(rank),
        "world": str(world),
    }


# ---------------------------------------------------------------------------
# device-timed spans (obs/trace.py): timing events, placed at readout
# ---------------------------------------------------------------------------

# elapsed_time is a float32 count of milliseconds, whose step grows with the
# distance (about 4 us at a minute): an event is placed from a placed event
# less than this far after it wherever the chain back from the anchor has one
_HOP_MS = 1000.0


class DeviceInterval:
    """The device side of one span: a timing event recorded on ``stream``
    when the span opens and another when it closes. :func:`place` resolves
    them once, after the window: ``start_ns``/``end_ns`` are then the
    device's start and end on the wall clock (``time.time_ns()``, the clock
    of the profiler's timestamps), or stay None with ``note`` saying why."""

    __slots__ = ("stream", "index", "start", "end", "start_ns", "end_ns", "note")

    def __init__(self, stream: torch.cuda.Stream):
        self.stream, self.index = stream, stream.device_index
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start_ns = self.end_ns = self.note = None
        self.start.record(stream)

    def close(self) -> None:
        self.end.record(self.stream)

    @property
    def label(self) -> str:
        return f"cuda:{self.index} stream {self.stream.stream_id}"


def capturing(target) -> bool:
    """Whether a device span on ``target`` (a ``torch.device`` or a CUDA
    stream, current where the span opens) would open inside a CUDA-graph
    capture: a replay runs no Python, so the span of a captured step records
    nothing."""
    if isinstance(target, torch.device) and target.type != "cuda":
        return False
    return torch.cuda.is_current_stream_capturing()


def open_interval(target) -> DeviceInterval | None:
    """Open the device side of a span on ``target``: a ``torch.cuda.Stream``,
    or a ``torch.device`` whose current stream times it. None on the CPU (the
    span is the host's alone)."""
    if isinstance(target, torch.device):
        if target.type != "cuda":
            return None
        target = torch.cuda.current_stream(target)
    return DeviceInterval(target)


def _anchor(index: int) -> tuple[torch.cuda.Event, int]:
    """An event recorded on card ``index``, idle, and the wall clock's ns at
    it: the midpoint of the ``time.time_ns()`` reads around its record and
    its completion, of the three tries the one with the narrowest bracket."""
    stream = torch.cuda.current_stream(index)
    best = None
    for _ in range(3):
        ev = torch.cuda.Event(enable_timing=True)
        p0, w0 = time.perf_counter_ns(), time.time_ns()
        ev.record(stream)
        ev.synchronize()
        w1, p1 = time.time_ns(), time.perf_counter_ns()
        if best is None or p1 - p0 < best[2]:
            best = (ev, w0 + (w1 - w0) // 2, p1 - p0)
    return best[0], best[1]


def place(intervals) -> None:
    """Place every interval not placed yet on the wall clock. Per card:
    synchronize it, take an anchor (:func:`_anchor`), then, newest first,
    place each start event by its ``elapsed_time`` to the anchor, or to a
    placed start less than ``_HOP_MS`` later, and each end by the interval's
    own elapsed time. An event that has not completed, or a card that fails
    to synchronize, gives no device time, and ``note`` says so."""
    todo: dict[int, list[DeviceInterval]] = {}
    for iv in intervals:
        if iv.start_ns is None and iv.note is None:
            todo.setdefault(iv.index, []).append(iv)
    for index, ivs in todo.items():
        try:
            torch.cuda.synchronize(index)
            ref, ref_ns = _anchor(index)
        except RuntimeError as e:
            for iv in ivs:
                iv.note = f"card {index} not synchronized ({type(e).__name__})"
            continue
        for iv in reversed(ivs):
            try:
                if not (iv.start.query() and iv.end.query()):
                    raise RuntimeError("not completed")
                ms, dur = iv.start.elapsed_time(ref), iv.start.elapsed_time(iv.end)
            except RuntimeError:
                iv.note = "event not completed"
                continue
            iv.start_ns = ref_ns - round(ms * 1e6)
            iv.end_ns = iv.start_ns + round(dur * 1e6)
            if ms > _HOP_MS:
                ref, ref_ns = iv.start, iv.start_ns


# ---------------------------------------------------------------------------
# profiler capture (the serving frontend's /profile endpoints)
# ---------------------------------------------------------------------------


def add_program_spans(path: str, lo_ns: int, hi_ns: int) -> None:
    """Write the program's spans of the window ``[lo_ns, hi_ns]`` (wall
    clock; ``obs/trace.py``'s host rows and device rows) into the profiler's
    Chrome trace at ``path``, on that trace's time base: its
    ``baseTimeNanoseconds`` (0 where the file has none) plus ``ts``
    microseconds is the wall clock."""
    from .trace import get_tracer

    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc.setdefault("traceEvents", []).extend(get_tracer().chrome_events(lo_ns, hi_ns, base))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class ProfilerCapture:
    """An HTTP-triggered ``torch.profiler`` window on live serving traffic.
    ``start`` and ``stop`` arrive as separate requests, so no function-local
    ``try``/``finally`` can pair them: the capture is single-flight under a
    lock, and its owner (``cli/serve.py``'s drain) calls
    :meth:`stop_if_active` at every shutdown. Each window lands in
    ``trace_dir`` as ``serve_trace_<n>.json``, a Chrome trace that
    ``bench/trace_ops.py`` reads: the host ops of every thread, the card's
    kernels whenever this process has a card, and the program's spans of
    the window (:func:`add_program_spans`), so that each idle gap shows
    under the span the host was in."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._active_since: float | None = None
        self._since_ns = 0  # the window's start on the wall clock
        self._prof = None
        self._windows = 0

    @property
    def active(self) -> bool:
        return self._active_since is not None

    def start(self) -> dict:
        """Begin a capture; raises RuntimeError when one is already open."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with self._lock:
            if self._active_since is not None:
                raise RuntimeError(
                    f"profiler capture already active for {time.perf_counter() - self._active_since:.1f}s")
            os.makedirs(self.trace_dir, exist_ok=True)
            # the window is opened by an HTTP handler thread; the ops it must
            # see run on the batcher's threads
            prof = torch.profiler.profile(
                activities=activities,
                experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))  # yamt-lint: disable=YAMT006 — torch's only switch for profiling threads other than the caller's; chip_smoke.py resolves it on the card's torch
            prof.start()  # yamt-lint: disable=YAMT013 — stop arrives via /profile/stop; stop_if_active() guards every drain path
            self._prof, self._active_since, self._since_ns = prof, time.perf_counter(), time.time_ns()
            get_registry().counter("obs.profiler_captures").inc()
        return {"trace_dir": self.trace_dir}

    def stop(self) -> dict:
        """End the capture and write its trace; raises RuntimeError when none
        is open."""
        with self._lock:
            if self._active_since is None:
                raise RuntimeError("no profiler capture active")
            prof, t0 = self._prof, self._active_since
            self._prof, self._active_since = None, None
            prof.stop()
            until_ns = time.time_ns()
            self._windows += 1
            path = os.path.join(self.trace_dir, f"serve_trace_{self._windows}.json")
            prof.export_chrome_trace(path)
            add_program_spans(path, self._since_ns, until_ns)
        return {"trace_dir": self.trace_dir, "trace": path, "captured_s": round(time.perf_counter() - t0, 3)}

    def stop_if_active(self) -> None:
        """Drain-path guard: close a still-open window without raising."""
        try:
            self.stop()
        except RuntimeError:
            pass
        except Exception:  # noqa: BLE001 — a torn capture must not block the drain
            get_registry().counter("obs.profiler_stop_errors").inc()

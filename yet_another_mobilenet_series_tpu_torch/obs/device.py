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
  ``bench/trace_ops.py`` reads (the JAX package's ``obs/device.py:274``).

:func:`build_info` names the card only in a process that has already
initialised CUDA, so that a process which owns no device (the fleet
supervisor) takes no context on the card by asking.
"""

from __future__ import annotations

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
# profiler capture (the serving frontend's /profile endpoints)
# ---------------------------------------------------------------------------


class ProfilerCapture:
    """An HTTP-triggered ``torch.profiler`` window on live serving traffic.
    ``start`` and ``stop`` arrive as separate requests, so no function-local
    ``try``/``finally`` can pair them: the capture is single-flight under a
    lock, and its owner (``cli/serve.py``'s drain) calls
    :meth:`stop_if_active` at every shutdown. Each window lands in
    ``trace_dir`` as ``serve_trace_<n>.json``, a Chrome trace that
    ``bench/trace_ops.py`` reads: the host ops of every thread, and the
    card's kernels whenever this process has a card."""

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._active_since: float | None = None
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
                experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
            prof.start()
            self._prof, self._active_since = prof, time.perf_counter()
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
            self._windows += 1
            path = os.path.join(self.trace_dir, f"serve_trace_{self._windows}.json")
            prof.export_chrome_trace(path)
        return {"trace_dir": self.trace_dir, "trace": path, "captured_s": round(time.perf_counter() - t0, 3)}

    def stop_if_active(self) -> None:
        """Drain-path guard: close a still-open window without raising."""
        try:
            self.stop()
        except RuntimeError:
            pass
        except Exception:  # noqa: BLE001 — a torn capture must not block the drain
            get_registry().counter("obs.profiler_stop_errors").inc()

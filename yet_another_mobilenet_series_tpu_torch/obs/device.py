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

The JAX package's cost-analysis gauges (``obs.cost_*``,
``serve.dispatched_flops`` / ``serve.dispatched_bytes``) come from XLA's
``cost_analysis`` and have no counterpart until the MAC profiler is ported
(ROADMAP queue 1, item 3); its profiler capture waits for the benches
(queue 1, item 11).
"""

from __future__ import annotations

import os
import threading

import torch

from .registry import MetricsRegistry, get_registry

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


def build_info() -> dict:
    """Version-attribution labels for the ``build_info`` metric family."""
    cuda = torch.cuda.is_available()
    return {
        "git_sha": _git_sha() or "unknown",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "platform": "cuda" if cuda else "cpu",
        "gpu_name": torch.cuda.get_device_name(0) if cuda else "none",
    }

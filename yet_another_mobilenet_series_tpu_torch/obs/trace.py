# Copy of yet_another_mobilenet_series_tpu/obs/trace.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Ring-buffered span tracer emitting Chrome-trace/Perfetto JSON.

Coordinator-only, host-side, and deliberately dumber than ``jax.profiler``:
spans measure HOST wall time (monotonic ``perf_counter_ns``) around the
things the profiler window cannot see without forcing
``steps_per_dispatch=1`` — data fetch, step dispatch, the log-boundary
``float()`` sync, prune events, eval, checkpoint saves, Trainer rebuilds.
Because a dispatch span closes when the host call RETURNS (async dispatch,
no device sync), tracing adds no host<->device round trips: an input-bound
step shows a fat ``data/next`` span, a dispatch-bound one a fat
``dispatch/*`` span, and a wedged tunnel an open span in the hang report.

Beyond duration ("X") spans the tracer emits the Chrome-trace event kinds
that correlate ONE request across threads (serve/context.py threads them
through the serving stack):

- **async events** (``ph: b``/``e``, keyed by ``id``): a request's
  admit -> queue -> in-flight -> complete phases render as one nested
  waterfall row per request id in Perfetto, regardless of which thread
  emitted each edge;
- **flow events** (``ph: s``/``t``/``f``, same ``id``): arrows stitching
  the handler thread's submit to the collect thread's dispatch to the
  completion thread's sync;
- **metadata** (``ph: M``): ``thread_name`` rows for registered worker
  threads (``register_thread``), so Perfetto shows ``serve-collect`` /
  ``serve-complete``, not raw thread ids.

The buffer is a fixed-size ring (``collections.deque(maxlen=...)``): a
multi-day run keeps the last N events, never unbounded memory. Completed
events are plain tuples; JSON rendering happens only at ``write()``.

A span exited OUT OF ORDER (an exception path closing a parent before a
child, a handle resolved on a different thread) is removed from its stack
by identity wherever it sits and counted in ``obs.misnested_spans`` —
before this, the stale entry sat in ``_open`` forever and every later hang
report carried phantom "open" spans.

Categories are load-bearing (docs/OBSERVABILITY.md span taxonomy): ``data``,
``dispatch``, ``sync``, ``prune``, ``eval``, ``ckpt``, ``rebuild``,
``serve`` (docs/SERVING.md).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .registry import get_registry


class _NullSpan:
    """Shared do-nothing context manager returned by a disabled tracer —
    the hot path pays one method call and an attribute test, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "t0_ns")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0_ns = time.perf_counter_ns()
        self._tracer._push(self)
        return self

    def __exit__(self, *exc):
        self._tracer._pop(self, time.perf_counter_ns())
        return False


class SpanTracer:
    def __init__(self, ring_size: int = 4096, enabled: bool = True,
                 process_name: str = "yamt coordinator"):
        self.enabled = enabled
        self.ring_size = ring_size
        # the Perfetto process-row label: "router" for the fleet supervisor,
        # the replica_id for serving replicas — a merged cross-process trace
        # (obs/trace_merge.py) needs each process to say who it is
        self.process_name = process_name
        # completed events: (ph, name, cat, t0_ns, dur_ns, tid, args, ev_id)
        # — ph "X" for duration spans (dur_ns set), "b"/"e" async and
        # "s"/"t"/"f" flow events (ev_id set, dur 0)
        self._events: collections.deque = collections.deque(maxlen=max(ring_size, 1))
        # open-span stacks keyed by thread id; each thread pushes/pops only
        # its own stack (GIL-atomic list ops), the watchdog reads copies
        self._open: dict[int, list[_Span]] = {}
        # tid -> human name for Perfetto thread_name metadata rows
        self._thread_names: dict[int, str] = {}
        self._origin_ns = time.perf_counter_ns()
        # wall-clock anchor sampled ADJACENT to the monotonic origin: every
        # event ts is relative to _origin_ns, so origin_unix is the one wall
        # timestamp that places this process's whole trace on a shared
        # timeline. obs/trace_merge.py aligns N processes by differencing their
        # origins — error is bounded by inter-host wall skew plus the
        # sub-microsecond gap between these two adjacent clock reads.
        # Identity/alignment use only, never differenced into a duration
        # within one process (the YAMT017 hazard is same-process intervals).
        self.origin_unix = time.time()
        self._pid = os.getpid()

    # -- hot path -----------------------------------------------------------

    def span(self, name: str, cat: str = "misc", **args):
        """Context manager timing one host-side region. ``args`` land in the
        Chrome-trace event's ``args`` block (keep them tiny and constant —
        NEVER pass a device array: stringifying it would force the very sync
        this tracer exists to avoid)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def _push(self, span: _Span) -> None:
        tid = threading.get_ident()
        stack = self._open.get(tid)
        if stack is None:
            stack = self._open[tid] = []
        stack.append(span)

    def _pop(self, span: _Span, t1_ns: int) -> None:
        stack = self._open.get(threading.get_ident())
        if stack and stack[-1] is span:
            stack.pop()
        else:
            # out-of-order exit: remove by identity wherever it sits (its
            # own stack first, any other thread's second) so the entry can
            # never pollute later hang reports as a phantom open span.
            # list() snapshots _open: another thread registering its first
            # span mid-scan must not blow up this thread's span exit
            found = False
            for st in ([stack] if stack else []) + [
                s for s in list(self._open.values()) if s is not stack
            ]:
                for i in range(len(st) - 1, -1, -1):
                    if st[i] is span:
                        del st[i]
                        found = True
                        break
                if found:
                    break
            if found:
                get_registry().counter("obs.misnested_spans").inc()
        self._events.append(
            ("X", span.name, span.cat, span.t0_ns, t1_ns - span.t0_ns,
             threading.get_ident(), span.args, None)
        )

    def _mark(self, ph: str, name: str, cat: str, ev_id: int, args: dict | None) -> None:
        if not self.enabled:
            return
        self._events.append(
            (ph, name, cat, time.perf_counter_ns(), 0, threading.get_ident(), args, ev_id)
        )

    # async (nestable, per-id waterfall rows) -------------------------------

    def async_begin(self, name: str, ev_id: int, cat: str = "serve", **args) -> None:
        self._mark("b", name, cat, ev_id, args or None)

    def async_end(self, name: str, ev_id: int, cat: str = "serve", **args) -> None:
        self._mark("e", name, cat, ev_id, args or None)

    # flow (cross-thread arrows) --------------------------------------------

    def flow_start(self, name: str, ev_id: int, cat: str = "serve", **args) -> None:
        self._mark("s", name, cat, ev_id, args or None)

    def flow_step(self, name: str, ev_id: int, cat: str = "serve", **args) -> None:
        self._mark("t", name, cat, ev_id, args or None)

    def flow_end(self, name: str, ev_id: int, cat: str = "serve", **args) -> None:
        self._mark("f", name, cat, ev_id, args or None)

    def register_thread(self, name: str | None = None) -> None:
        """Name the CALLING thread's Perfetto row (``thread_name`` metadata
        event at ``to_chrome_trace``). Worker loops call this once at entry;
        default is the Python thread's own name (``serve-collect``, ...)."""
        if not self.enabled:
            return
        self._thread_names[threading.get_ident()] = (  # yamt-lint: disable=YAMT019 — per-thread dict: every thread writes only its OWN ident key

            name or threading.current_thread().name
        )

    # -- readout ------------------------------------------------------------

    def open_spans(self) -> list[dict]:
        """Currently-open spans across all threads (outermost first) — the
        "where was it stuck" section of the watchdog's hang report."""
        now = time.perf_counter_ns()
        out = []
        for tid, stack in list(self._open.items()):
            for span in list(stack):
                out.append(
                    {
                        "name": span.name,
                        "cat": span.cat,
                        "tid": tid,
                        "open_for_s": (now - span.t0_ns) / 1e9,
                        "args": span.args,
                    }
                )
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (load via chrome://tracing or
        https://ui.perfetto.dev). Complete ("X"), async ("b"/"e"), flow
        ("s"/"t"/"f"), and metadata ("M") events, ts/dur in µs."""
        events: list[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": self.process_name},
            }
        ]
        for tid, name in sorted(self._thread_names.items()):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self._pid,
                    "tid": tid,
                    "ts": 0,
                    "args": {"name": name},
                }
            )
        for ph, name, cat, t0_ns, dur_ns, tid, args, ev_id in list(self._events):
            ev = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": (t0_ns - self._origin_ns) / 1e3,
                "pid": self._pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            else:
                ev["id"] = ev_id
                if ph == "f":
                    ev["bp"] = "e"  # bind the arrow head to the enclosing slice
            if args:
                ev["args"] = args
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # cross-process alignment block (obs/trace_merge.py): which
            # process wrote this file and where its ts=0 sits on the wall
            "pid": self._pid,
            "process_name": self.process_name,
            "origin_unix": self.origin_unix,
        }

    def write(self, path: str) -> str:
        """Atomically write the Chrome-trace JSON next to the run's logs."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


# Module singleton: producers deep in the stack (prefetch_to_mesh, the
# checkpoint manager) fetch the tracer by call, so cli/train.py can configure
# it once without threading a tracer handle through every signature.
_TRACER = SpanTracer(ring_size=1, enabled=False)


def get_tracer() -> SpanTracer:
    return _TRACER


def configure(enabled: bool, ring_size: int = 4096,
              process_name: str = "yamt coordinator") -> SpanTracer:
    """Install the process tracer (cli/train.py, coordinator only).
    ``process_name`` labels this process's Perfetto row — serving processes
    pass their role ("router") or replica_id so a merged fleet trace reads
    as named process lanes, not anonymous pids."""
    global _TRACER
    _TRACER = SpanTracer(ring_size=ring_size, enabled=enabled, process_name=process_name)
    return _TRACER

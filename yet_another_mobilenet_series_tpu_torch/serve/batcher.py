# Copy of yet_another_mobilenet_series_tpu/serve/batcher.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Thread-based micro-batching request queue in front of the engine.

Single-image requests are latency-cheap but throughput-poisonous: the chip
is happiest at the biggest bucket. The batcher coalesces concurrent
requests into engine batches — up to ``max_batch`` images or ``max_wait_ms``
of linger, whichever first — on a dedicated dispatch thread, so clients see
a Future and the engine sees full buckets. A coalesced batch of MIXED image
sizes partitions by shape and dispatches one engine batch per size, each
hitting its own (bucket, image_size) executable (serve/engine.py ladder).
A size group is handed to the engine WHOLE, never split here: one larger
than the biggest bucket rides the engine's fused multi-chunk path (one
``lax.scan`` dispatch per ladder piece, ``serve.fuse_chunks``), so
``max_batch`` above the largest bucket turns coalesced overflow into fused
whole-batch dispatches instead of a host-side chunk loop.

The collect wait is event-driven, not polled: an idle batcher blocks on the
queue (zero wakeups/s) and the first request of a burst is picked up the
moment it lands — ``stop()`` wakes the thread with a queue sentinel instead
of a poll-interval check. FIFO makes the sentinel double as the drain
barrier: everything enqueued before ``stop()`` is served first.

Overload behavior is explicit, not emergent:

- **backpressure**: the queue is bounded (``queue_depth``); a full queue
  rejects ``submit`` with :class:`QueueFull` immediately instead of growing
  an unbounded latency tail.
- **timeout shedding**: a request carrying a deadline that expires while
  still queued is dropped with :class:`DeadlineExceeded` set on its Future —
  the engine never burns a bucket slot on an answer nobody is waiting for.
  (The pipelined batcher additionally re-checks deadlines at completion —
  serve/pipeline.py.)

Failure containment (the robustness contract every layer above builds on):

- every request is tracked in a live set from submit to resolution, and all
  future resolution goes through :meth:`_finish_ok` / :meth:`_finish_err` —
  idempotent, so a late engine answer for a request that shutdown already
  failed is dropped instead of crashing a worker thread;
- ``stop(drain=True)`` is BOUNDED: if the engine wedges mid-batch,
  ``drain_timeout_s`` fails every still-unresolved request with
  :class:`DrainTimeout` instead of hanging shutdown forever (the worker
  threads are daemons and are abandoned to the hung call);
- the worker loop carries a top-level exception guard (yamt-lint YAMT011):
  an unexpected crash fails every live future and counts
  ``serve.thread_crashes`` instead of dying silently and hanging clients.

Requests carry an optional **priority class** (serve/admission.py taxonomy);
the batcher itself stays FIFO — class policy lives at admission time, where
rejecting is still cheap — but sheds are attributed per class
(``serve.shed_deadline.<class>``) so overload is diagnosable by QoS tier.

Instrumentation (obs/): ``serve.queue_wait_seconds`` (enqueue -> dispatch),
``serve.batch_size`` histograms, ``serve.requests`` (counted only on a
SUCCESSFUL enqueue — a rejected submit increments ``serve.rejected_full``
alone, so requests - completed - shed always balances) / ``serve.completed``
/ ``serve.shed_deadline`` / ``serve.rejected_full`` / ``serve.drain_timeouts``
/ ``serve.thread_crashes`` counters — all in the same registry every scalars
row and obs_registry.json snapshot carries.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable

import numpy as np

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.logging import emit
from .quant import coerce_wire

# queue sentinel: wakes the (blocking) collect thread for shutdown. FIFO
# ordering makes everything enqueued before stop() drain ahead of it.
_STOP = object()


class QueueFull(RuntimeError):
    """submit() rejected: the bounded request queue is at queue_depth."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it was still queued (or, on the
    pipelined path, before its completed batch was synced)."""


class DrainTimeout(RuntimeError):
    """stop(drain=True) gave up waiting for a wedged engine: the request was
    failed at shutdown instead of hanging it (serve.drain_timeout_s)."""


class _Request:
    __slots__ = ("image", "future", "t_enqueue", "t_deadline", "priority", "ctx", "model")

    def __init__(self, image: np.ndarray, deadline_s: float | None, priority: str | None = None,
                 ctx=None, model: str | None = None):
        self.image = image
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.t_deadline = None if deadline_s is None else self.t_enqueue + deadline_s
        self.priority = priority
        # RequestContext (serve/context.py) when the caller threads identity
        # through; phase advances ride the request across the thread hops
        self.ctx = ctx
        # zoo model identity (serve/zoo.py): batches never mix models — the
        # grouping key below includes it, so each engine batch targets one
        # model's (model, bucket, image_size, K) executable
        self.model = model

    def _advance(self, phase: str) -> None:
        if self.ctx is not None:
            self.ctx.advance(phase)


def _group_by_shape(reqs: list["_Request"]) -> list[list["_Request"]]:
    """Partition a coalesced batch by (model, image shape), insertion-ordered:
    mixed image-size traffic dispatches one engine batch per size, each
    hitting its own (bucket, image_size) executable — never a stack error —
    and mixed-MODEL traffic (serve/zoo.py) never shares a batch, so every
    dispatch targets exactly one model's ladder."""
    groups: dict[tuple, list[_Request]] = {}
    for r in reqs:
        groups.setdefault((r.model, r.image.shape), []).append(r)
    return list(groups.values())


class MicroBatcher:
    """Coalesces submit()ted images into predict_fn batches on a worker
    thread. ``predict_fn(images) -> logits`` is typically
    :meth:`serve.engine.InferenceEngine.predict`."""

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        queue_depth: int = 256,
        default_deadline_ms: float = 0.0,
        drain_timeout_s: float = 0.0,
        wire_dtype=np.float32,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._predict = predict_fn
        # zoo-aware predict fns (serve/engine.py multi-model) take a model=
        # kwarg; plain fns (tests, lambdas) don't — detect once, like the
        # pipelined batcher's ctxs detection, so both keep working unchanged
        try:
            self._predict_takes_model = "model" in inspect.signature(predict_fn).parameters
        except (TypeError, ValueError):
            self._predict_takes_model = False
        # the serving WIRE dtype (serve.quant.wire via the engine): submit
        # coerces every image to it ONCE, so stacked batches reach the
        # engine already wire-typed — never a hardcoded np.float32 (the
        # pre-quantization literal YAMT016 now lints against)
        self._wire_dtype = np.dtype(wire_dtype)
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._default_deadline_s = default_deadline_ms / 1e3 if default_deadline_ms > 0 else None
        self._drain_timeout_s = drain_timeout_s
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._reg = get_registry()
        # submit -> resolution tracking: the drain-timeout sweep and the
        # thread-crash guard fail exactly the requests still in flight
        self._live: set[_Request] = set()
        self._live_lock = threading.Lock()
        # empty-handed collect returns; stays 0 with the event-driven wait
        # (pinned by tests) — the old 50 ms poll produced ~20/s while idle
        self._idle_wakeups = 0
        # set when the stop sentinel is drawn mid-linger: serve the batch in
        # hand, then exit (never re-enqueue the sentinel — a full queue would
        # deadlock the put)
        self._exit_after_batch = False
        # brownout fill-or-flush (serve/brownout.py L2+): when True the
        # coalescing linger is skipped — top up from whatever is ALREADY
        # queued (under saturation that is a full batch) and dispatch
        # immediately; an idle lull must not add max_wait_ms of latency to
        # work the storm already queued
        self._fill_or_flush = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stop.clear()
        self._start_threads()
        return self

    def _start_threads(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the worker thread(s). ``drain=True`` serves what is already
        queued first (FIFO: the wake sentinel lands behind every pending
        request); False fails pending requests immediately. The drain is
        bounded by ``drain_timeout_s`` (0 = wait forever): on timeout every
        still-unresolved request fails with :class:`DrainTimeout` and the
        wedged worker threads are abandoned (they are daemons)."""
        if self._thread is None:
            return
        if not drain:
            self._fail_queued(RuntimeError("batcher stopped"))
        self._stop.set()
        self._q.put(_STOP)  # wakes the blocking collect; drains ahead of it
        drained = self._join_threads(self._drain_timeout_s if self._drain_timeout_s > 0 else None)
        self._thread = None
        self._fail_queued(RuntimeError("batcher stopped"))
        if not drained:
            self._reg.counter("serve.drain_timeouts").inc()
            emit(f"[serve] drain timed out after {self._drain_timeout_s:.1f}s; "
                 "failing in-flight requests and abandoning the wedged worker")
            self._fail_live(DrainTimeout(
                f"batcher shutdown drain exceeded {self._drain_timeout_s:.1f}s "
                "(engine wedged mid-batch?)"
            ))

    def _join_threads(self, timeout_s: float | None = None) -> bool:
        """Join the worker(s); False when the drain budget ran out first."""
        self._thread.join(timeout_s)
        return not self._thread.is_alive()

    def _fail_queued(self, exc: Exception) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is _STOP:
                continue
            self._finish_err(req, exc)

    def _fail_live(self, exc: Exception) -> None:
        """Fail every request still unresolved anywhere in the batcher —
        queued, in a worker's hands, or dispatched-but-unsynced."""
        with self._live_lock:
            live = list(self._live)
        for req in live:  # _finish_err re-takes the lock per request
            self._finish_err(req, exc)

    # -- future resolution (idempotent, the only two mutation paths) --------

    def _finish_ok(self, req: _Request, row) -> bool:
        with self._live_lock:
            self._live.discard(req)
        req._advance("completed")  # no-op when the engine already marked it
        try:
            req.future.set_result(row)
            return True
        except InvalidStateError:
            return False  # already failed (drain timeout / crash sweep)

    def _finish_err(self, req: _Request, exc: Exception) -> bool:
        with self._live_lock:
            self._live.discard(req)
        req._advance("failed")  # no-op when already shed/completed
        try:
            req.future.set_exception(exc)
            return True
        except InvalidStateError:
            return False

    # -- client side --------------------------------------------------------

    def submit(
        self,
        image: np.ndarray,
        *,
        deadline_ms: float | None = None,
        priority: str | None = None,
        ctx=None,
        model: str | None = None,
    ) -> Future:
        """Enqueue one (H, W, 3) image; returns a Future resolving to its
        logits row. Raises :class:`QueueFull` when the bounded queue is at
        capacity (the caller's backpressure signal). ``priority`` tags the
        request with its QoS class (serve/admission.py) for per-class shed
        attribution; the batcher itself stays FIFO. ``ctx`` is the optional
        :class:`~.context.RequestContext` correlating this request's trace
        events across the thread hops. ``model`` names the zoo tenant
        (serve/zoo.py); requests for different models never share a batch."""
        if self._thread is None:
            raise RuntimeError("batcher not started")
        deadline_s = deadline_ms / 1e3 if deadline_ms is not None else self._default_deadline_s
        req = _Request(coerce_wire(image, self._wire_dtype), deadline_s, priority, ctx, model)
        with self._live_lock:
            self._live.add(req)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._live_lock:
                self._live.discard(req)
            self._reg.counter("serve.rejected_full").inc()
            raise QueueFull(f"request queue at capacity ({self._q.maxsize})") from None
        self._reg.counter("serve.requests").inc()  # accepted only, after the enqueue
        req._advance("queued")  # flow start + queued async edge, submit thread
        return req.future

    # -- dispatch thread ----------------------------------------------------

    def _collect(self) -> list[_Request] | None:
        """Block (no polling) for the first request, then linger up to
        max_wait_s (or until max_batch) for companions. Returns None when
        the stop sentinel is drawn first — the thread's exit signal."""
        first = self._q.get()
        if first is _STOP:
            return None
        batch = [first]
        self._linger_fill(batch)
        return batch

    def set_fill_or_flush(self, enabled: bool) -> None:
        """Brownout actuator (L2+): disable the coalescing linger — batches
        fill only from what is already queued, then dispatch. Idempotent and
        safe to flip live from the controller thread."""
        self._fill_or_flush = bool(enabled)  # yamt-lint: disable=YAMT019 — single-writer bool flip from the brownout controller; the worker reads a stale value for at most one linger tick

    def apply_brownout(self, policy) -> None:
        """The batcher's slice of a :class:`~.brownout.BrownoutPolicy`."""
        self.set_fill_or_flush(policy.fill_or_flush)

    def _linger_fill(self, batch: list[_Request]) -> None:
        """Top ``batch`` up from the queue until max_batch or max_wait_s of
        linger, whichever first — the shared coalescing policy (also used by
        the pipelined back-to-back path when a drain comes up short). Under
        brownout fill-or-flush the linger window collapses to zero: only
        already-queued requests join, then the batch dispatches."""
        t_close = time.perf_counter() + self._max_wait_s
        while len(batch) < self._max_batch:
            if self._fill_or_flush:
                remaining = 0.0  # no waiting: drain what's there, then go
            else:
                remaining = t_close - time.perf_counter()
                if remaining <= 0:
                    break
            try:
                nxt = self._q.get(timeout=remaining) if remaining > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                # serve this batch, then exit: anything enqueued after the
                # sentinel is failed by stop()'s final _fail_queued sweep
                self._exit_after_batch = True
                break
            batch.append(nxt)

    def _shed_expired(self, batch: list[_Request]) -> list[_Request]:
        """Dispatch-time deadline check: fail expired requests, record queue
        wait for the survivors."""
        now = time.perf_counter()
        live: list[_Request] = []
        for req in batch:
            if req.t_deadline is not None and now > req.t_deadline:
                self._shed(req, DeadlineExceeded(f"queued {now - req.t_enqueue:.3f}s past deadline"))
            else:
                self._reg.histogram("serve.queue_wait_seconds").observe(now - req.t_enqueue)
                live.append(req)
        return live

    def _shed(self, req: _Request, exc: DeadlineExceeded) -> None:
        self._reg.counter("serve.shed_deadline").inc()
        if req.priority:
            self._reg.counter(f"serve.shed_deadline.{req.priority}").inc()
        req._advance("shed")
        self._finish_err(req, exc)

    def _thread_crash(self, exc: Exception) -> None:
        """Terminal handler behind every worker's top-level guard (YAMT011):
        a crashing worker fails every live request instead of dying silently
        — a silently-dead collect thread would hang every future forever."""
        self._reg.counter("serve.thread_crashes").inc()
        emit(f"[serve] worker thread crashed: {type(exc).__name__}: {exc}")
        self._fail_live(exc)

    def _loop(self) -> None:
        try:
            obs_trace.get_tracer().register_thread()  # "serve-batcher" Perfetto row
            self._loop_inner()
        except Exception as e:  # noqa: BLE001 — terminal: contain, don't hang clients
            self._thread_crash(e)

    def _loop_inner(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if not batch:
                self._idle_wakeups += 1
                continue
            self._serve_batch(batch)
            if self._exit_after_batch:
                return

    def _serve_batch(self, batch: list[_Request]) -> None:
        live = self._shed_expired(batch)
        for group in _group_by_shape(live):
            self._reg.histogram("serve.batch_size").observe(len(group))
            for req in group:  # queued -> in-flight edge, dispatch thread
                req._advance("dispatched")
            try:
                stacked = np.stack([r.image for r in group])
                if self._predict_takes_model and group[0].model is not None:
                    logits = self._predict(stacked, model=group[0].model)
                else:
                    logits = self._predict(stacked)
            except Exception as e:  # noqa: BLE001 — a dying engine must not hang clients
                for req in group:
                    self._finish_err(req, e)
                continue
            done = 0
            for req, row in zip(group, logits):
                done += self._finish_ok(req, row)
            if done:
                self._reg.counter("serve.completed").inc(done)

# Copy of yet_another_mobilenet_series_tpu/serve/pipeline.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Pipelined continuous batching: collect/dispatch and completion decoupled.

The plain :class:`~.batcher.MicroBatcher` is a one-thread cycle — collect,
predict (which blocks on the device_get), resolve futures, repeat — so the
host's collect/pad/stage work and the device's compute strictly alternate:
while the chip runs a bucket, no requests coalesce, and while the host
coalesces, the chip idles. BENCH_SERVE_r01 shows the cost (the batch-32
bucket delivering LOWER QPS than batch-8 on CPU rehearsal).

:class:`PipelinedBatcher` splits the cycle across two threads around the
engine's async dispatch (serve/engine.py ``predict_async``):

- the **collect thread** gathers a batch, stages + dispatches it via
  ``predict_async`` (no sync — JAX async dispatch returns as soon as the
  work is enqueued on the device), and pushes the resulting
  :class:`~.engine.PendingPrediction` into a bounded in-flight window;
- the **completion thread** pops handles in dispatch order, blocks on
  ``result()`` (the only host<->device sync), re-checks deadlines, and
  resolves the futures.

So the NEXT bucket fills and stages while the PREVIOUS one executes on the
device — continuous batching. While the window is full the collect thread
keeps TOPPING UP the batch in hand instead of closing it early: dispatch
cannot proceed anyway, and a partial bucket pads with dead rows the device
then computes — under saturation every dispatched bucket arrives full. A
topped-up batch larger than the engine's biggest bucket still dispatches
as ONE ``predict_async`` call (one window slot per size group): the engine
serves it through the fused multi-chunk executables
(``serve.fuse_chunks``, one lax.scan dispatch per ladder piece), so
saturation-driven top-up composes with fusion instead of degrading into a
per-chunk host loop.
``max_inflight`` bounds the number of dispatched-but-unsynced batches, and
the slot is reserved BEFORE dispatch, so at most ``max_inflight``
executions are ever enqueued device-side:
``1`` = classic double buffering (stage batch k+1 while k computes; never
two concurrent executions — the right setting when host and "device" share
cores, i.e. CPU), ``2`` (default) additionally keeps one execution queued
behind the running one so the device never drains between batches. A full
window blocks the collect thread, which backs pressure up into the bounded
submit queue and ultimately :class:`~.batcher.QueueFull`, exactly like the
sync path.

**Back-to-back dispatch** (``run_max`` > 1, serve.overlap config) is the
device-resident steady state for a SATURATED bucket: after dispatching a
batch, while the queue already holds a full next batch, a window slot is
free without blocking, and the run has room, the collect thread drains and
dispatches the next batch immediately — no linger, no completion wake-up in
between — and hands the whole run to the completion thread as ONE item. The
completion thread then syncs only the run's TAIL (device execution is FIFO:
the tail's logits existing proves every earlier batch completed, so their
``result()`` calls are pure device_get, zero further blocking syncs) inside
a ``serve/resident`` span. Each wake-up observes
``serve.dispatches_per_wakeup`` — ENGINE dispatch pieces per completion
wake-up (``handle.dispatches``: an oversized batch a non-fused engine
serves as several pieces counts them all, same granularity as
``serve.dispatch_seconds``). On a fused engine every saturated batch is one
piece, so a mean > 1 on a saturated bucket means runs really formed — the
structural claim the r05 bench artifact pins — and
paired with the engine's overlapped staging (fence-tracked slot pool +
async ``jax.device_put``) the H2D transfer of batch N+1 overlaps compute of
batch N, so steady-state ``serve.achieved_flops_per_s`` approaches the
single-dispatch number. Any blocking window acquire FLUSHES the pending run
first — a run the completion thread has not been handed yet can never be
the thing its window slots are waiting on (the deadlock this ordering rule
exists to make impossible).

**Ring feed/drain** (``serve.ring.enable``, serve/ring.py) replaces
back-to-back dispatch on a saturated bucket with something strictly
stronger: instead of N dispatches per completion wake-up, the collect
thread FEEDS up to R max-bucket slots (engine ``ring_stage`` — async H2D
per slot, no dispatch) and commits the whole window as ONE masked-scan
dispatch (``ring_dispatch``). Engagement is conservative: the queue (plus
the batch in hand) must hold at least ``min_slots(R, min_fill)`` slots'
worth of rows, and only the largest same-(model, shape) group rides the
ring — everything else (mixed sizes, shallow queues, off-ladder sizes,
ring-less engines) falls back to the existing per-batch path unchanged,
so sync / pipelined / fused / overlapped semantics stay intact and
A/B-able. A ring window occupies ONE in-flight window slot and counts as
ONE engine piece in ``serve.dispatches_per_wakeup`` (the whole point:
dispatches-per-window drops to 1/R at full fill).

Failure semantics are preserved, not weakened:

- ``QueueFull`` backpressure and dispatch-time deadline shedding behave as
  in the sync batcher (shared code), and so does brownout fill-or-flush
  (serve/brownout.py L2+): the shared ``_linger_fill`` collapses its linger
  window to zero, which this batcher's top-up and short-drain paths inherit
  — under a storm the queue supplies full batches without the wait;
- deadlines are ALSO checked at completion: a request whose deadline passed
  while its batch was executing gets :class:`~.batcher.DeadlineExceeded`
  instead of a stale answer (``serve.shed_at_completion`` counts these,
  on top of the shared ``serve.shed_deadline``);
- an engine failure at dispatch or at sync fails exactly that batch's
  futures and both threads keep serving;
- ``stop(drain=True)`` drains the request queue, then the in-flight window,
  in FIFO order — BOUNDED by ``drain_timeout_s``: a completion thread
  wedged inside a hung ``result()`` cannot hang shutdown; the remaining
  futures fail with :class:`~.batcher.DrainTimeout` and the wedged daemon
  threads are abandoned (their late answers are dropped by the idempotent
  resolution helpers);
- both loops carry top-level exception guards (yamt-lint YAMT011): an
  unexpected crash fails every live future, counts
  ``serve.thread_crashes``, and — for the collect thread — still delivers
  the drain sentinel so the completion thread exits too.

Instrumentation (obs/): ``serve.inflight`` gauge (window occupancy at each
push/pop) plus everything the engine and shared batcher record —
``serve.dispatch_seconds``, ``serve.dispatch_to_complete_seconds``,
``serve.batch_size``, ``serve.queue_wait_seconds``.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time

import numpy as np

from ..obs import trace as obs_trace
from . import ring as ring_lib
from .batcher import _STOP, DeadlineExceeded, MicroBatcher, _Request, _group_by_shape

# in-flight window sentinel: collect thread -> completion thread shutdown
_DRAINED = object()


class PipelinedBatcher(MicroBatcher):
    """Two-thread continuous batcher over an engine with ``predict_async``.

    ``engine`` needs ``predict_async(images) -> handle`` with a blocking
    ``handle.result()`` — the :class:`~.engine.InferenceEngine` protocol.
    Everything client-facing (``submit`` / ``QueueFull`` / deadlines /
    ``stop``) matches :class:`~.batcher.MicroBatcher`.
    """

    def __init__(
        self,
        engine,
        *,
        max_inflight: int = 2,
        run_max: int = 1,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        queue_depth: int = 256,
        default_deadline_ms: float = 0.0,
        drain_timeout_s: float = 0.0,
        wire_dtype=None,
        ring_min_fill: float = 0.5,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if run_max < 1:
            raise ValueError(f"run_max must be >= 1, got {run_max}")
        if not 0.0 < ring_min_fill <= 1.0:
            raise ValueError(f"ring_min_fill must be in (0, 1], got {ring_min_fill}")
        # the wire dtype rides the engine (serve.quant.wire): submit-side
        # coercion must match the engine's staging buffers, so inherit it
        # unless the caller overrides (bare test doubles default to f32)
        if wire_dtype is None:
            wire_dtype = getattr(engine, "wire_np_dtype", np.float32)
        super().__init__(
            engine.predict,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
            default_deadline_ms=default_deadline_ms,
            drain_timeout_s=drain_timeout_s,
            wire_dtype=wire_dtype,
        )
        self._engine = engine
        self._max_inflight = max_inflight
        # back-to-back run cap: > 1 lets a saturated bucket dispatch up to
        # this many batches per completion wake-up (bounded by the window,
        # which stays the device-side memory bound); 1 = legacy per-batch
        self._run_max = int(run_max)
        # thread request identity into the engine when it speaks the ctxs
        # extension (InferenceEngine/FaultyEngine do; bare test doubles with
        # predict_async(images) keep working — the batcher's own phase
        # advances cover them)
        try:
            params = inspect.signature(engine.predict_async).parameters
            self._engine_takes_ctxs = "ctxs" in params
            # zoo-aware engines additionally take model= (serve/zoo.py);
            # groups are (model, shape)-pure so one kwarg per dispatch works
            self._engine_takes_model = "model" in params
        except (TypeError, ValueError):
            self._engine_takes_ctxs = False
            self._engine_takes_model = False
        # ring feed/drain mode (serve/ring.py): engaged iff the engine was
        # built with ring_slots > 0 (serve.ring.enable); _ring_min_slots is
        # the engagement threshold in STAGED SLOTS (min_fill x R, ceil)
        self._ring_slots = int(getattr(engine, "ring_slots", 0) or 0)
        self._ring_min_slots = (
            ring_lib.min_slots(self._ring_slots, ring_min_fill) if self._ring_slots else 0)
        self._ring_cap = int(engine.buckets[-1]) if self._ring_slots else 0
        # dispatched-but-unsynced budget, acquired BEFORE each dispatch so
        # at most max_inflight executions are ever enqueued device-side
        self._window = threading.BoundedSemaphore(max_inflight)
        # runs of (handle, live_requests) pairs in dispatch order; the
        # semaphore is the bound, the queue just carries them to the
        # completion thread (a run_max=1 run is a singleton list)
        self._inflight: queue.Queue = queue.Queue()
        self._inflight_n = 0
        self._inflight_lock = threading.Lock()
        self._completion: threading.Thread | None = None

    def _inflight_adj(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight_n += delta
            self._reg.gauge("serve.inflight").set(self._inflight_n)

    def inflight(self) -> int:
        """Dispatched-but-unsynced batches right now (health/hang reports)."""
        with self._inflight_lock:
            return self._inflight_n

    def worker_threads(self) -> list[dict]:
        """Name/liveness of the batcher's worker threads — the serving
        section of the watchdog's hang report (obs/watchdog.py)."""
        return [
            {"name": t.name, "alive": t.is_alive()}
            for t in (self._thread, self._completion)
            if t is not None
        ]

    # -- lifecycle (two threads) --------------------------------------------

    def _start_threads(self) -> None:
        self._thread = threading.Thread(target=self._collect_loop, name="serve-collect", daemon=True)  # yamt-lint: disable=YAMT019 — lifecycle: threads start before any client can submit; submit's None-check is the not-started guard
        self._completion = threading.Thread(target=self._complete_loop, name="serve-complete", daemon=True)
        self._thread.start()
        self._completion.start()

    def _join_threads(self, timeout_s: float | None = None) -> bool:
        # one shared drain budget across both joins, not one budget each
        deadline = None if timeout_s is None else time.perf_counter() + timeout_s
        self._thread.join(timeout_s)  # pushes _DRAINED into the in-flight queue on exit
        if deadline is not None:
            timeout_s = max(0.0, deadline - time.perf_counter())
        self._completion.join(timeout_s)
        drained = not (self._thread.is_alive() or self._completion.is_alive())
        if drained:
            self._completion = None
        return drained

    # -- collect/dispatch thread --------------------------------------------

    def _collect_loop(self) -> None:
        try:
            obs_trace.get_tracer().register_thread()  # "serve-collect" Perfetto row
            self._collect_loop_inner()
        except Exception as e:  # noqa: BLE001 — terminal: contain, don't hang clients
            self._thread_crash(e)
        finally:
            self._inflight.put(_DRAINED)

    def _collect_loop_inner(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if not batch:
                self._idle_wakeups += 1
                continue
            self._dispatch_batch(batch)
            if self._exit_after_batch:
                return

    def _acquire_window_topping_up(self, batch: list[_Request]) -> None:
        """Block until a window slot frees, topping the batch up from the
        request queue meanwhile. While the window is full nothing can
        dispatch anyway, so closing a partial batch early would only pad a
        bucket with dead rows — fill matters more than a head start (the
        serve_bench fill counters showed exactly this: partial pipelined
        buckets burning padded compute)."""
        while not self._window.acquire(blocking=False):
            if self._exit_after_batch or len(batch) >= self._max_batch:
                self._window.acquire()
                return
            try:
                nxt = self._q.get(timeout=0.005)
            except queue.Empty:
                continue
            if nxt is _STOP:
                self._exit_after_batch = True
            else:
                batch.append(nxt)

    def _dispatch_batch(self, batch: list[_Request]) -> None:
        # ring feed/drain first (serve.ring.enable): a saturated window
        # rides ONE masked-scan dispatch; on False the batch is untouched
        # (possibly topped up) and falls through to the per-batch path
        if self._ring_min_slots and self._ring_try(batch):
            return
        # reserve the slot (window = dispatched-but-unsynced cap) BEFORE
        # dispatch — backpressure toward submit(); released by completion
        self._acquire_window_topping_up(batch)
        run: list[tuple] = []
        self._dispatch_groups(batch, run)
        # back-to-back extension: while the bucket stays saturated (a FULL
        # next batch is already queued — no linger would improve its fill),
        # a window slot is free WITHOUT blocking, and the run has room,
        # dispatch the next batch with no completion wake-up in between.
        # The completion thread receives the whole run as one item and
        # syncs only its tail.
        while (
            run
            and len(run) < self._run_max
            and not self._exit_after_batch
            and self._q.qsize() >= self._max_batch
        ):
            if not self._window.acquire(blocking=False):
                break  # window full: the run is as deep as the device bound allows
            nxt = self._drain_full_batch_nowait()
            if not nxt:
                self._window.release()
                break
            if len(nxt) < self._max_batch and not self._exit_after_batch:
                # short drain: the qsize saturation signal overstated what
                # was really queued (it counts the stop sentinel, and a
                # concurrent stop() sweep can race the drain) — this batch
                # is NOT saturated, so fill it through the normal lingering
                # path instead of dispatching a padded partial bucket with
                # zero linger. (When the sentinel was drawn we are exiting:
                # dispatch what we have, lingering would only delay drain.)
                self._linger_fill(nxt)
            self._dispatch_groups(nxt, run)
        self._flush_run(run)

    # -- ring feed/drain (serve/ring.py) ------------------------------------

    def _ring_try(self, batch: list[_Request]) -> bool:
        """Serve ``batch`` as a device-resident ring window when it is
        worth one: the batch plus the queue must hold at least
        ``min_slots`` slots' worth of rows (the min_fill engagement
        condition), and the window is the largest same-(model, shape)
        group whose size is ring-ready (on the tenant's warmed ladder).
        Returns True when the batch was fully handled — the ring group as
        ONE feed+dispatch, every other group through the normal per-batch
        machinery. Returns False with the batch intact (possibly topped
        up from the queue, which the per-batch path would have drained
        anyway) when no window can form — shallow queue, mixed traffic,
        off-ladder sizes — so the existing path serves it unchanged."""
        cap, r = self._ring_cap, self._ring_slots
        if len(batch) + self._q.qsize() < self._ring_min_slots * cap:
            return False
        # saturation top-up with NO linger, to at most one full window:
        # the queue reported the rows already there
        while len(batch) < r * cap and not self._exit_after_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                self._exit_after_batch = True
            else:
                batch.append(nxt)
        live = self._shed_expired(batch)
        batch[:] = live
        if not live:
            return True  # everything shed: nothing to dispatch, no window taken
        groups = _group_by_shape(live)
        best = -1
        for i, g in enumerate(groups):
            if (
                len(g) > (self._ring_min_slots - 1) * cap
                and self._engine.ring_ready(g[0].model, g[0].image.shape[0])
                and (best < 0 or len(g) > len(groups[best]))
            ):
                best = i
        if best < 0:
            return False  # no ring-worthy group; per-batch path serves the batch
        ring_group = groups.pop(best)
        batch.clear()
        # ONE window slot for the whole ring window (it is one handle, one
        # dispatch); no run is pending yet, so a blocking acquire is safe
        self._window.acquire()
        self._ring_dispatch_group(ring_group)
        rest = [req for g in groups for req in g]
        if rest:
            # leftover groups ride the normal path — acquired AFTER the
            # ring run was flushed, honoring the flush-before-blocking-
            # acquire ordering rule
            self._acquire_window_topping_up(rest)
            run: list[tuple] = []
            self._dispatch_groups(rest, run)
            self._flush_run(run)
        return True

    def _ring_dispatch_group(self, group: list[_Request]) -> None:
        """Feed one (model, shape)-pure group into ring slots and commit
        the window: per-slot ``ring_stage`` (async H2D, no dispatch) then
        ONE ``ring_dispatch``. The caller holds the window slot; an engine
        failure releases it and fails exactly this group's futures — both
        threads keep serving, same policy as ``_dispatch_groups``."""
        self._reg.histogram("serve.batch_size").observe(len(group))
        for req in group:
            req._advance("dispatched")
        try:
            chunks, leftover = ring_lib.window_chunks(group, self._ring_cap, self._ring_slots)
            assert not leftover  # _ring_try caps the drain at r * cap rows
            entries = [
                self._engine.ring_stage(np.stack([r.image for r in chunk]))
                for chunk in chunks
            ]
            handle = self._engine.ring_dispatch(
                entries,
                ctxs=[r.ctx for r in group if r.ctx is not None],
                model=group[0].model,
            )
        except Exception as e:  # noqa: BLE001 — a dying engine must not hang clients
            self._window.release()
            for req in group:
                self._finish_err(req, e)
            return
        self._inflight_adj(+1)
        self._inflight.put([(handle, group)])

    def _drain_full_batch_nowait(self) -> list[_Request]:
        """Up to max_batch queued requests with NO lingering — only called
        when the queue reported a full batch available (saturation). The
        stop sentinel sets ``_exit_after_batch`` exactly like ``_collect``;
        anything enqueued after it is failed by stop()'s final sweep."""
        batch: list[_Request] = []
        while len(batch) < self._max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is _STOP:
                self._exit_after_batch = True
                break
            batch.append(nxt)
        return batch

    def _dispatch_groups(self, batch: list[_Request], run: list[tuple]) -> None:
        """Shed, partition by image shape, dispatch each group, append the
        ``(handle, group)`` pairs to ``run``. The caller holds ONE window
        slot for the first group; mixed-size groups past the first acquire
        their own — FLUSHING the pending run first, so the blocking acquire
        can never wait on window slots held by a run the completion thread
        has not been handed yet."""
        live = self._shed_expired(batch)
        if not live:
            self._window.release()
            return
        for i, group in enumerate(_group_by_shape(live)):
            if i:
                self._flush_run(run)
                self._window.acquire()
            self._reg.histogram("serve.batch_size").observe(len(group))
            for req in group:  # queued -> in-flight edge, collect thread
                req._advance("dispatched")
            try:
                stacked = np.stack([r.image for r in group])
                kwargs = {}
                if self._engine_takes_ctxs:
                    kwargs["ctxs"] = [r.ctx for r in group if r.ctx is not None]
                if self._engine_takes_model and group[0].model is not None:
                    kwargs["model"] = group[0].model
                handle = self._engine.predict_async(stacked, **kwargs)
            except Exception as e:  # noqa: BLE001 — a dying engine must not hang clients
                self._window.release()
                for req in group:
                    self._finish_err(req, e)
                continue
            run.append((handle, group))
            self._inflight_adj(+1)

    def _flush_run(self, run: list[tuple]) -> None:
        """Hand the accumulated run to the completion thread as ONE item."""
        if run:
            self._inflight.put(list(run))
            run.clear()

    # -- completion thread --------------------------------------------------

    def _complete_loop(self) -> None:
        try:
            obs_trace.get_tracer().register_thread()  # "serve-complete" Perfetto row
            self._complete_loop_inner()
        except Exception as e:  # noqa: BLE001 — terminal: contain, don't hang clients
            self._thread_crash(e)

    def _complete_loop_inner(self) -> None:
        tracer = obs_trace.get_tracer()
        while True:
            item = self._inflight.get()
            if item is _DRAINED:
                return
            run = item
            # engine dispatches the collect thread managed per completion
            # wake-up: the back-to-back instrument. Counts real dispatch
            # PIECES (handle.dispatches — an oversized batch on a non-fused
            # engine is one handle but several pieces), matching the
            # serve.dispatch_seconds granularity; bare test doubles without
            # the attribute count as one dispatch.
            self._reg.histogram("serve.dispatches_per_wakeup").observe(
                sum(getattr(h, "dispatches", 1) for h, _ in run))
            if len(run) > 1:
                # device-resident run: sync ONLY the tail. Execution is FIFO
                # on the device, so the tail's logits existing proves every
                # earlier batch in the run completed — their result() calls
                # below are pure device_get, no further blocking sync.
                with tracer.span("serve/resident", "serve", batches=len(run)):
                    try:
                        run[-1][0].result()
                    except Exception:  # yamt-lint: disable=YAMT012 — ordering optimization only; the per-batch result() below re-raises and fails exactly that batch
                        pass
            for handle, live in run:
                self._complete_one(handle, live)

    def _complete_one(self, handle, live: list[_Request]) -> None:
        try:
            logits = handle.result()
        except Exception as e:  # noqa: BLE001 — fail this batch, keep draining
            self._inflight_adj(-1)
            self._window.release()
            for req in live:
                self._finish_err(req, e)
            return
        # the device is free the moment the sync returns: open the
        # window before the host-side future resolution
        self._inflight_adj(-1)
        self._window.release()
        now = time.perf_counter()
        done = 0
        for req, row in zip(live, logits):
            if req.t_deadline is not None and now > req.t_deadline:
                # expired while the batch executed: a stale answer is a
                # shed, not a success (completion-time deadline check)
                self._reg.counter("serve.shed_at_completion").inc()
                self._shed(req, DeadlineExceeded(
                    f"completed {now - req.t_enqueue:.3f}s past deadline"
                ))
            else:
                done += self._finish_ok(req, row)
        if done:
            self._reg.counter("serve.completed").inc(done)

# Copy of yet_another_mobilenet_series_tpu/serve/autoscale.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Autoscaler: a control thread scaling the replica count off measured load.

The fleet's two live load signals are exactly the families /metrics already
exposes: tail latency (the router's per-class
``serve.router.latency_seconds`` histogram) and backlog (the per-replica
``queued_total`` the router polls from every ``/healthz``). The autoscaler
reads both at ``interval_s`` cadence and nudges the supervisor's target
replica count N inside ``[min_replicas, max_replicas]``:

- **scale up** when the WINDOW p99 (bucket-count deltas since the last
  tick, through the registry's own quantile math — not the whole-run
  quantile, which old traffic would anchor; the shared
  :class:`~.signals.SignalReader` implementation, consumed by the brownout
  ladder too) exceeds ``up_p99_ms`` OR the mean routable queue depth
  exceeds ``up_queue_depth``;
- **scale down** when the window p99 is below ``down_p99_ms`` (or the
  window is empty — an idle fleet drains to ``min_replicas``) AND the mean
  queue depth is below ``down_queue_depth``;
- **cooldown hysteresis**: after ANY scaling action, no further action for
  ``cooldown_s`` — a spawn takes seconds to absorb load, and flapping
  (up, down, up) costs a compile each flap. The up/down thresholds must
  not overlap (enforced at construction) so the steady state is a dead
  band, not an oscillator.

Every tick appends a row to :attr:`trace` (``t``/``n``/``p99_ms``/
``queue_depth``/``action``) — the N-over-time trajectory the serve_bench
``--fleet`` artifact records — and scaling actions count
``fleet.scale_ups`` / ``fleet.scale_downs`` with the ``fleet.replicas``
gauge tracking N.

The supervisor dependency is one method: ``fleet.scale_to(n) -> int``
(blocking; returns the achieved N), plus ``fleet.n_replicas``. The router
dependency is ``router.mean_queue_depth()``. Both are injectable, so the
decision logic unit-tests with fakes and no subprocesses.
"""

from __future__ import annotations

import threading
import time

from ..obs.registry import get_registry
from ..utils.logging import emit
from .hedge import ROUTER_LATENCY
from .signals import SignalReader


class Autoscaler:
    """Cooldown-hysteresis scaling controller between min and max replicas."""

    def __init__(
        self,
        fleet,
        router,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 1.0,
        cooldown_s: float = 5.0,
        up_p99_ms: float = 250.0,
        down_p99_ms: float = 50.0,
        up_queue_depth: float = 8.0,
        down_queue_depth: float = 1.0,
        signal_class: str = "interactive",
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, got "
                             f"{min_replicas}..{max_replicas}")
        if down_p99_ms >= up_p99_ms or down_queue_depth >= up_queue_depth:
            raise ValueError("scale-down thresholds must sit strictly below scale-up "
                             "thresholds (the dead band is the hysteresis)")
        self._fleet = fleet
        self._router = router
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self._interval_s = interval_s
        self._cooldown_s = cooldown_s
        self._up_p99_s = up_p99_ms / 1e3
        self._down_p99_s = down_p99_ms / 1e3
        self._up_queue = up_queue_depth
        self._down_queue = down_queue_depth
        self._cls = signal_class
        self._reg = get_registry()
        # the shared windowed-signal reader (serve/signals.py): window p99
        # off bucket-count deltas + the router's polled backlog — one
        # implementation with the brownout ladder, pinned unchanged here
        self._signals = SignalReader(
            latency_family=ROUTER_LATENCY, signal_class=signal_class,
            quantile=0.99, queue_depth_fn=router.mean_queue_depth,
        )
        self._last_action_t: float | None = None
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the N-over-time trajectory: one row per tick, bench-artifact-ready
        self.trace: list[dict] = []

    # -- the control step ----------------------------------------------------

    def step(self, now: float | None = None) -> dict:
        """One control decision. Separated from the thread so tests drive
        the logic deterministically. Returns the appended trace row."""
        now = time.perf_counter() if now is None else now
        p99_s = self._signals.window_p99_s()
        queue_depth = self._signals.queue_depth()
        n = self._fleet.n_replicas
        in_cooldown = (
            self._last_action_t is not None and now - self._last_action_t < self._cooldown_s
        )
        action = "hold"
        if not in_cooldown:
            overloaded = (p99_s is not None and p99_s > self._up_p99_s) or queue_depth > self._up_queue
            relaxed = (p99_s is None or p99_s < self._down_p99_s) and queue_depth < self._down_queue
            if overloaded and n < self.max_replicas:
                n = self._fleet.scale_to(n + 1)
                self._reg.counter("fleet.scale_ups").inc()
                self._last_action_t = now
                action = "up"
            elif relaxed and n > self.min_replicas:
                n = self._fleet.scale_to(n - 1)
                self._reg.counter("fleet.scale_downs").inc()
                self._last_action_t = now
                action = "down"
        self._reg.gauge("fleet.replicas").set(n)
        row = {
            "t": round(now - self._t0, 3),
            "n": n,
            "p99_ms": round(p99_s * 1e3, 3) if p99_s is not None else None,
            "queue_depth": round(queue_depth, 3),
            "action": action,
            "in_cooldown": in_cooldown,
        }
        self.trace.append(row)
        return row

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="fleet-autoscale", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:  # YAMT011: a dead control thread must be loud, not a frozen N
            while not self._stop.wait(self._interval_s):
                self.step()
        except Exception as e:  # noqa: BLE001 — contain, count, report
            get_registry().counter("serve.thread_crashes").inc()
            emit(f"[fleet] autoscaler thread crashed: {type(e).__name__}: {e}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

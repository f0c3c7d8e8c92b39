# Copy of yet_another_mobilenet_series_tpu/serve/hedge.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Request hedging: duplicate the straggler, first answer wins.

Tail latency in a replica fleet is dominated by the occasional slow server
— a GC pause, a queue spike, a noisy neighbor — not by the median path. The
classic fix (Dean & Barroso, "The Tail at Scale") is to send a DUPLICATE of
a request that has outrun the fleet's typical latency to a second replica
and take whichever answer lands first. Inference is pure, so a duplicate
can never double-apply anything; the only costs are the extra load (bounded
by firing at the tail quantile — only ~1% of requests ever hedge) and the
discipline that the loser's late answer must be discarded without
double-resolving the caller's future.

Two pieces:

:class:`Hedger` — policy. The hedge timer is **derived from measured
latency**, not configured: the p-``quantile`` (default p99) of the router's
own per-class ``serve.router.latency_seconds.<class>`` histogram
(obs/registry.py bucketed quantiles — the same math /metrics exposes),
clamped to ``[min_timer_ms, max_timer_ms]``. Until a class has
``min_samples`` observations the timer is None and nothing hedges — a cold
fleet must not hedge on garbage estimates.

:class:`HedgedCall` — mechanism. One request's idempotent first-wins
resolution across its legs (``primary`` + at most one ``hedge``):

- the first successful leg resolves the future; a hedge-leg win counts
  ``serve.hedge_wins``;
- the LOSER's late answer is dropped and counted
  (``serve.hedge_wasted``) — never a double resolution, never an
  InvalidStateError escaping a worker thread;
- a leg failure only resolves the future once NO other launched leg can
  still answer, and when both legs failed the PRIMARY's error surfaces
  (the hedge was an optimization; its failure mode must not replace the
  primary verdict);
- ``serve.hedges`` counts fired duplicates (armed timers that actually
  launched a second leg, not armings).

Under brownout (serve/brownout.py) hedging is the FIRST thing to go — L1
stops duplicating work before anything is shed — and every timer that
would have armed while disabled counts ``serve.hedges_suppressed``
(:meth:`Hedger.suppressed`): the duplicate load the ladder declined to add.

The router (serve/router.py) owns the threading: it arms a
``threading.Timer`` per eligible request and cancels it when the primary
resolves first. Because the timer is armed at LEG start and fires on its
own thread, it also covers the partition case: a primary leg wedged on a
blackholed or half-open socket (serve/netchaos.py) cannot delay the hedge
— the duplicate goes out at the measured quantile while the stuck leg
waits out its read timeout, so a partitioned replica costs the fleet a
timer tick, not a client-visible stall.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, InvalidStateError

from ..obs.registry import get_registry

# the per-class latency family the router observes and the hedger reads
ROUTER_LATENCY = "serve.router.latency_seconds"


class Hedger:
    """Hedge-timer policy over the router's observed latency histograms."""

    def __init__(self, *, quantile: float = 0.99, min_samples: int = 20,
                 min_timer_ms: float = 10.0, max_timer_ms: float = 2000.0):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.quantile = quantile
        self.min_samples = max(1, int(min_samples))
        self.min_timer_s = min_timer_ms / 1e3
        self.max_timer_s = max_timer_ms / 1e3
        self._reg = get_registry()

    def observe(self, cls: str, latency_s: float) -> None:
        """Feed one completed request's router-side latency (any leg)."""
        self._reg.histogram(f"{ROUTER_LATENCY}.{cls}").observe(latency_s)

    def timer_s(self, cls: str) -> float | None:
        """Seconds to wait before duplicating a request of ``cls``; None
        while the class histogram is too thin to trust (no hedging)."""
        hist = self._reg.histogram(f"{ROUTER_LATENCY}.{cls}")
        if hist.count < self.min_samples:
            return None
        return min(max(hist.quantile(self.quantile), self.min_timer_s), self.max_timer_s)

    def suppressed(self) -> None:
        """Record one hedge the brownout ladder declined to arm
        (``serve.hedges_suppressed``) — the router calls this when a timer
        WOULD have fired but hedging is disabled at L1+."""
        self._reg.counter("serve.hedges_suppressed").inc()


class HedgedCall:
    """First-wins resolution of one request across its launched legs."""

    PRIMARY = "primary"
    HEDGE = "hedge"

    def __init__(self, future: Future):
        self.future = future
        self._lock = threading.Lock()
        self._resolved = False
        self._launched = {self.PRIMARY}
        self._failed: dict[str, Exception] = {}
        self._reg = get_registry()

    def launch_hedge(self) -> bool:
        """Record the duplicate leg going out (counts ``serve.hedges``).
        False when the call already resolved — the caller must not send."""
        with self._lock:
            if self._resolved:
                return False
            self._launched.add(self.HEDGE)
        self._reg.counter("serve.hedges").inc()
        return True

    @property
    def resolved(self) -> bool:
        with self._lock:
            return self._resolved

    @property
    def hedged(self) -> bool:
        """True once a duplicate leg actually launched — the flight
        recorder's discriminator for "this request's outcome was a hedge
        race", not just an armed timer (obs/fleet.py hedge-outcome events)."""
        with self._lock:
            return self.HEDGE in self._launched

    def ok(self, leg: str, value) -> bool:
        """Leg ``leg`` answered. True if it won (resolved the future); a
        loser's late answer is dropped and counted, never double-delivered."""
        with self._lock:
            if self._resolved:
                won = False
            else:
                self._resolved = True
                won = True
        if not won:
            self._reg.counter("serve.hedge_wasted").inc()
            return False
        if leg == self.HEDGE:
            self._reg.counter("serve.hedge_wins").inc()
        try:
            self.future.set_result(value)
        except InvalidStateError:
            pass  # client cancelled; nothing left to deliver
        return True

    def err(self, leg: str, exc: Exception) -> bool:
        """Leg ``leg`` failed. Resolves the future (with the PRIMARY's error
        when both legs failed) only once no launched leg is still pending;
        True if this call delivered the final verdict."""
        with self._lock:
            if self._resolved:
                return False
            self._failed[leg] = exc
            if set(self._failed) != self._launched:
                return False  # another leg may still answer
            self._resolved = True
            final = self._failed.get(self.PRIMARY, exc)
        try:
            self.future.set_exception(final)
        except InvalidStateError:
            pass
        return True

# Copy of yet_another_mobilenet_series_tpu/serve/signals.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Shared windowed-signal reader: the measured load signals every serving
control loop consumes.

Two controllers act on measured load — the fleet autoscaler
(serve/autoscale.py: add capacity) and the brownout ladder
(serve/brownout.py: trade quality for goodput when capacity cannot grow) —
and both must answer the same question: *how is the system doing RIGHT NOW,
not since boot?* The registry's histograms are cumulative, so a whole-run
quantile is anchored by every request ever served; a controller reading it
would see yesterday's calm long after today's storm began. The fix, factored
here so both controllers share ONE implementation instead of drifting
copies, is **bucket-count deltas**: snapshot the histogram's per-bucket
counts each tick, subtract the previous snapshot, and run the registry's own
quantile math (:func:`~..obs.registry.quantiles_from_counts`) over the
difference — the p99 of exactly the completions that landed since the last
tick, through the same interpolation /metrics exposes.

:class:`WindowedQuantile` is that one primitive. :class:`SignalReader`
bundles it with the other two live signals the controllers read:

- **queue depth** — an injected callable (the router's
  ``mean_queue_depth`` at the fleet tier; the admission controller's
  ``queued_total`` at the replica tier), read fresh each tick;
- **breaker state** — the ``serve.breaker_state`` gauge (0 closed / 1 open
  / 2 half-open): an open breaker means the engine itself is sick, which is
  overload evidence no latency window can show (rejected requests never
  reach the histogram).

Both consumers are pinned against this module: tests/test_fleet.py pins the
autoscaler's decisions unchanged across the refactor, and
tests/test_brownout.py drives the ladder from scripted
:class:`Signals` traces.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..obs.registry import get_registry, quantiles_from_counts


@dataclasses.dataclass(frozen=True)
class Signals:
    """One tick's measured-load snapshot.

    ``p99_s`` is None when the window saw no completions (idle — only the
    queue/breaker signals speak); ``breaker_state`` uses the admission
    controller's encoding (0 closed / 1 open / 2 half-open).
    """

    p99_s: float | None
    queue_depth: float
    breaker_state: int

    @property
    def breaker_open(self) -> bool:
        return self.breaker_state == 1


class WindowedQuantile:
    """The q-quantile of a bucketed histogram's observations SINCE the last
    read — cumulative bucket counts differenced per tick, quantiled through
    the registry's own interpolation. Returns None for an empty window."""

    def __init__(self, name: str, quantile: float = 0.99):
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        self.name = name
        self.quantile = quantile
        self._hist = get_registry().histogram(name)
        self._counts_prev = self._hist.bucket_counts()

    def read(self) -> float | None:
        counts = self._hist.bucket_counts()
        delta = [a - b for a, b in zip(counts, self._counts_prev)]
        self._counts_prev = counts  # yamt-lint: disable=YAMT019 — each reader is single-owner by contract (SignalReader docstring): no concurrent read()
        if sum(delta) == 0:
            return None
        (q,) = quantiles_from_counts(self._hist.bounds, delta, (self.quantile,))
        return q


class SLOTracker:
    """Multi-window SLO burn rate over FEDERATED fleet signals.

    The SRE-workbook alerting shape: an SLO is an error budget (the
    fraction of requests allowed to be bad over the compliance period),
    and the *burn rate* is how fast the fleet is spending it — bad-request
    fraction divided by the budget, so burn 1.0 exhausts the budget
    exactly on schedule and burn 14 exhausts a 30-day budget in ~2 days.
    Alerting on ONE window is a trap: a short window pages on blips, a
    long window pages an hour late. The standard fix is requiring a SHORT
    and a LONG window to BOTH burn hot (:attr:`fast_burn`) — the short
    window proves it is still happening, the long window proves it is not
    a blip.

    Two budget dimensions, folded through ``max()`` into one burn number:

    - **error burn** — bad/total over the window vs ``error_budget``
      (bad = rejected + shed + failed, fed by obs/fleet.py from summed
      per-replica counter deltas);
    - **latency burn** — the fraction of scrape ticks whose federated
      windowed p99 breached ``target_p99_ms``, vs the same budget (a tick
      is this tracker's latency quantum: per-request latency SLIs would
      need per-request data federation does not ship).

    Driven by :meth:`observe` once per federation scrape
    (obs/fleet.py); read by the flight recorder (fast burn triggers an
    incident dump) and exported as ``fleet.slo_burn_rate.{short,long}``
    gauges. Single-owner by contract, like :class:`WindowedQuantile`: only
    the scrape loop calls ``observe``.
    """

    def __init__(
        self,
        *,
        target_p99_ms: float = 250.0,
        error_budget: float = 0.01,
        short_window_s: float = 30.0,
        long_window_s: float = 300.0,
        fast_burn: float = 14.0,
        clock: Callable[[], float] | None = None,
    ):
        if not 0.0 < error_budget < 1.0:
            raise ValueError(f"error_budget must be in (0, 1), got {error_budget}")
        if short_window_s <= 0 or long_window_s <= short_window_s:
            raise ValueError(
                f"windows must satisfy 0 < short < long, got "
                f"{short_window_s}/{long_window_s}")
        if fast_burn <= 0:
            raise ValueError(f"fast_burn must be > 0, got {fast_burn}")
        self.target_p99_s = target_p99_ms / 1e3
        self.error_budget = float(error_budget)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.fast_burn_threshold = float(fast_burn)
        # injectable monotonic clock (tests drive time by hand)
        self._clock = clock or time.monotonic
        # per-tick samples: (t, total, bad, latency_breached: 0/1) — pruned
        # past the long window, so memory is bounded by tick rate x window
        self._ticks: list[tuple[float, int, int, int]] = []

    def observe(self, total: int, bad: int, p99_s: float | None = None) -> None:
        """Feed one scrape tick's WINDOWED deltas: ``total`` completed+bad
        requests and ``bad`` budget-burning ones since the previous tick,
        plus the tick's federated windowed p99 (None = idle tick, which
        cannot breach)."""
        now = self._clock()
        breached = 1 if (p99_s is not None and p99_s > self.target_p99_s) else 0
        self._ticks.append((now, max(int(total), 0), max(int(bad), 0), breached))
        horizon = now - self.long_window_s
        while self._ticks and self._ticks[0][0] < horizon:
            self._ticks.pop(0)

    def burn_rate(self, window_s: float) -> float:
        """Budget-burn multiple over the trailing ``window_s``: max of the
        error-fraction burn and the latency-breach-fraction burn. 0.0 with
        no traffic and no breaches."""
        horizon = self._clock() - window_s
        total = bad = ticks = breaches = 0
        for t, n, b, breach in self._ticks:
            if t < horizon:
                continue
            total += n
            bad += b
            ticks += 1
            breaches += breach
        error_burn = (bad / total / self.error_budget) if total else 0.0
        latency_burn = (breaches / ticks / self.error_budget) if ticks else 0.0
        return max(error_burn, latency_burn)

    @property
    def fast_burn(self) -> bool:
        """True when BOTH windows burn past the threshold — the page-now
        condition (and the flight recorder's slo_fast_burn trigger)."""
        return (self.burn_rate(self.short_window_s) >= self.fast_burn_threshold
                and self.burn_rate(self.long_window_s) >= self.fast_burn_threshold)

    def state(self) -> dict:
        """JSON view for /varz fleet snapshots and incident dumps."""
        return {
            "target_p99_ms": round(self.target_p99_s * 1e3, 3),
            "error_budget": self.error_budget,
            "burn_short": round(self.burn_rate(self.short_window_s), 4),
            "burn_long": round(self.burn_rate(self.long_window_s), 4),
            "fast_burn": self.fast_burn,
            "windows_s": [self.short_window_s, self.long_window_s],
            "ticks": len(self._ticks),
        }


class SignalReader:
    """Windowed per-class tail latency + queue depth + breaker state, read
    as one consistent :class:`Signals` snapshot per control tick.

    ``latency_family`` names the per-class histogram family
    (``serve.router.latency_seconds`` at the fleet tier,
    ``serve.latency_seconds`` at the replica tier); ``queue_depth_fn`` is
    the tier's backlog source (0 when None). Each :meth:`read` consumes the
    window — two controllers must each own their OWN reader.
    """

    def __init__(
        self,
        *,
        latency_family: str,
        signal_class: str = "interactive",
        quantile: float = 0.99,
        queue_depth_fn: Callable[[], float] | None = None,
    ):
        self._window = WindowedQuantile(f"{latency_family}.{signal_class}", quantile)
        self._queue_depth_fn = queue_depth_fn
        self._breaker_gauge = get_registry().gauge("serve.breaker_state")

    def window_p99_s(self) -> float | None:
        """The windowed tail alone (the autoscaler's original signal)."""
        return self._window.read()

    def queue_depth(self) -> float:
        return float(self._queue_depth_fn()) if self._queue_depth_fn is not None else 0.0

    def read(self) -> Signals:
        return Signals(
            p99_s=self._window.read(),
            queue_depth=self.queue_depth(),
            breaker_state=int(self._breaker_gauge.value),
        )

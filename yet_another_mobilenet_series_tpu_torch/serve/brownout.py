# Copy of yet_another_mobilenet_series_tpu/serve/brownout.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Brownout: a graceful-degradation ladder under sustained overload.

Every resilience layer so far answers *failure* (retry, breaker, hedging,
replica restart) or answers overload by **rejecting harder** (quotas,
deadline shedding, queue bounds). Nothing trades *quality* for *goodput*:
under a sustained storm the hedger keeps duplicating work, the batchers
keep lingering for fill, and best_effort traffic keeps competing with
interactive at the quota boundary. The brownout controller closes that gap
with the overload half of the tail-at-scale playbook: a deterministic,
ORDERED ladder of degradations, stepped by the same measured signals the
autoscaler consumes (serve/signals.py — windowed per-class p99 off registry
bucket-count deltas, queue depth, breaker state), cheapest degradation
first:

======  ==================================================================
level   what degrades (cumulative — each level keeps everything below it)
======  ==================================================================
L0      healthy: nothing degraded
L1      hedging disabled — stop DUPLICATING work before shedding any
L2      batchers fill-or-flush — no coalescing linger; full batches only
        come from the backlog a storm supplies anyway
L3      best_effort rejected at the door (503 + ``Retry-After``)
L4      deadline-admission margin tightened (predicted wait inflated by
        ``margin``) + the batch class shed too
L5      interactive-only survival mode: every non-interactive class shed,
        transient-failure retries disabled, margin tightened further
======  ==================================================================

Stepping is **asymmetric with hysteresis and cooldown**: the ladder steps
UP one level per ``hold_up_s`` while overloaded (react in seconds — an
overload compounds), and steps DOWN one level per ``cooldown_s`` only
while every signal sits below the *down* thresholds (recover slowly — the
dead band between up/down thresholds plus the one-level-per-cooldown rule
makes the ladder monotone through a storm instead of flapping, the same
discipline as the autoscaler's scale actions). An open breaker counts as
overload evidence on its own: rejected requests never reach the latency
histogram, so the window can look idle exactly when the engine is sickest.

The controller owns no serving state — it PUSHES an immutable
:class:`BrownoutPolicy` into whichever actuation targets it was built with
(each implementing ``apply_brownout(policy)``): the batcher
(fill-or-flush), the admission controller (class shed / margin / retries),
and the router (hedging, class shed at the fleet tier). Observability:
``serve.brownout_level`` gauge (rides /metrics, /varz, and /healthz),
``serve.brownout_transitions`` counter with ``.up``/``.down`` direction
splits, a ``serve/brownout`` span per transition, and an autoscaler-style
:attr:`trace` of per-tick rows the serve_bench ``--overload`` artifact
records. docs/SERVING.md "Overload & brownout" is the operator's guide.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.logging import emit
from .signals import SignalReader, Signals

# ladder depth: levels are 0..MAX_LEVEL inclusive
MAX_LEVEL = 5


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """One ladder level's complete degradation set, pushed whole into every
    actuation target so a level change is atomic per target."""

    level: int
    hedging: bool  # may the router arm hedge timers?
    fill_or_flush: bool  # batchers skip the coalescing linger?
    shed_classes: frozenset[str]  # rejected at the door with Retry-After
    deadline_margin: float  # multiplier on the admission wait predictor
    retries: bool  # transient-failure retries still run?
    retry_after_s: float = 1.0  # the Retry-After hint on brownout sheds


def build_ladder(retry_after_s: float = 1.0) -> tuple[BrownoutPolicy, ...]:
    """The ordered L0..L5 policy ladder (module docstring table)."""
    none: frozenset[str] = frozenset()
    return (
        BrownoutPolicy(0, True, False, none, 1.0, True, retry_after_s),
        BrownoutPolicy(1, False, False, none, 1.0, True, retry_after_s),
        BrownoutPolicy(2, False, True, none, 1.0, True, retry_after_s),
        BrownoutPolicy(3, False, True, frozenset({"best_effort"}), 1.0, True, retry_after_s),
        # margins stay moderate (1.5x / 2.5x): the margin guts admission of
        # deadline-carrying traffic multiplicatively on top of the backlog
        # factor, and an over-tight L5 empties the queue so hard the ladder
        # oscillates at the top instead of holding
        BrownoutPolicy(4, False, True, frozenset({"best_effort", "batch"}), 1.5, True,
                       retry_after_s),
        BrownoutPolicy(5, False, True, frozenset({"best_effort", "batch"}), 2.5, False,
                       retry_after_s),
    )


class BrownoutController:
    """Steps the degradation ladder off one :class:`~.signals.SignalReader`.

    ``targets`` is any iterable of objects implementing
    ``apply_brownout(policy)`` (MicroBatcher / AdmissionController / Router
    — each consumes its own slice and ignores the rest). The decision logic
    is a plain :meth:`step` so tests drive it from scripted signal traces
    with injected clocks; :meth:`start` wraps it in the usual guarded
    control thread.
    """

    def __init__(
        self,
        signals: SignalReader,
        targets=(),
        *,
        interval_s: float = 0.5,
        up_p99_ms: float = 400.0,
        down_p99_ms: float = 100.0,
        up_queue_depth: float = 16.0,
        down_queue_depth: float = 2.0,
        hold_up_s: float = 1.0,
        cooldown_s: float = 5.0,
        max_level: int = MAX_LEVEL,
        retry_after_s: float = 1.0,
        log_fn=None,
    ):
        if down_p99_ms >= up_p99_ms or down_queue_depth >= up_queue_depth:
            raise ValueError("brownout down thresholds must sit strictly below up "
                             "thresholds (the dead band is the hysteresis)")
        if not 0 <= max_level <= MAX_LEVEL:
            raise ValueError(f"brownout max_level must be in [0, {MAX_LEVEL}], got {max_level}")
        if hold_up_s <= 0 or cooldown_s <= 0:
            raise ValueError("brownout hold_up_s and cooldown_s must be > 0")
        self._signals = signals
        self._targets = list(targets)
        self._interval_s = interval_s
        self._up_p99_s = up_p99_ms / 1e3
        self._down_p99_s = down_p99_ms / 1e3
        self._up_queue = up_queue_depth
        self._down_queue = down_queue_depth
        self._hold_up_s = hold_up_s
        self._cooldown_s = cooldown_s
        self._max_level = max_level
        # transition announcements; benches whose stdout IS the artifact
        # inject a stderr printer (the bench-contract one-JSON-line rule)
        self._log = log_fn or emit
        self._ladder = build_ladder(retry_after_s)
        self.level = 0
        self._last_up_t: float | None = None
        self._last_change_t: float | None = None
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._reg = get_registry()
        self._reg.gauge("serve.brownout_level").set(0)
        # per-tick rows (t/level/p99_ms/queue_depth/breaker/action) — the
        # ladder-over-time trajectory the --overload bench artifact records
        self.trace: list[dict] = []
        self._apply(self._ladder[0])

    @property
    def policy(self) -> BrownoutPolicy:
        return self._ladder[self.level]

    # -- actuation -----------------------------------------------------------

    def _apply(self, policy: BrownoutPolicy) -> None:
        for target in self._targets:
            target.apply_brownout(policy)

    def _transition(self, new_level: int, now: float) -> None:
        direction = "up" if new_level > self.level else "down"
        with obs_trace.get_tracer().span("serve/brownout", "serve",
                                         frm=self.level, to=new_level):
            self.level = new_level  # yamt-lint: disable=YAMT019 — single-writer int publish from the controller loop; readers tolerate one stale tick
            self._apply(self._ladder[new_level])
        self._reg.gauge("serve.brownout_level").set(new_level)
        self._reg.counter("serve.brownout_transitions").inc()
        self._reg.counter(f"serve.brownout_transitions.{direction}").inc()
        self._last_change_t = now
        if direction == "up":
            self._last_up_t = now
        self._log(f"[serve] brownout {direction}: L{new_level} "
                  f"({'degrading' if direction == 'up' else 'recovering'})")

    # -- the control step ----------------------------------------------------

    def step(self, now: float | None = None, signals: Signals | None = None) -> dict:
        """One ladder decision; ``now``/``signals`` injectable for scripted
        tests. Returns the appended trace row."""
        now = time.perf_counter() if now is None else now
        sig = self._signals.read() if signals is None else signals
        overloaded = (
            (sig.p99_s is not None and sig.p99_s > self._up_p99_s)
            or sig.queue_depth > self._up_queue
            or sig.breaker_open
        )
        relaxed = (
            (sig.p99_s is None or sig.p99_s < self._down_p99_s)
            and sig.queue_depth < self._down_queue
            and not sig.breaker_open
        )
        action = "hold"
        if overloaded and self.level < self._max_level:
            # step UP at most once per hold_up_s: reacting fast matters, but
            # one window of bad luck must not jump straight to survival mode
            if self._last_up_t is None or now - self._last_up_t >= self._hold_up_s:
                self._transition(self.level + 1, now)
                action = "up"
        elif relaxed and self.level > 0:
            # step DOWN one level per cooldown: each restored degradation
            # adds load back, and the window must prove it holds before the
            # next restoration — the ladder cannot flap
            if self._last_change_t is None or now - self._last_change_t >= self._cooldown_s:
                self._transition(self.level - 1, now)
                action = "down"
        row = {
            "t": round(now - self._t0, 3),
            "level": self.level,
            "p99_ms": round(sig.p99_s * 1e3, 3) if sig.p99_s is not None else None,
            "queue_depth": round(sig.queue_depth, 3),
            "breaker_open": sig.breaker_open,
            "action": action,
        }
        self.trace.append(row)
        return row

    # -- introspection -------------------------------------------------------

    def state(self) -> dict:
        pol = self.policy
        return {
            "level": self.level,
            "max_level": self._max_level,
            "hedging": pol.hedging,
            "fill_or_flush": pol.fill_or_flush,
            "shed_classes": sorted(pol.shed_classes),
            "deadline_margin": pol.deadline_margin,
            "retries": pol.retries,
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "BrownoutController":
        if self._thread is not None:
            raise RuntimeError("brownout controller already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="serve-brownout", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:  # YAMT011: a dead controller must be loud, not a frozen ladder
            while not self._stop.wait(self._interval_s):
                self.step()
        except Exception as e:  # noqa: BLE001 — contain, count, report
            get_registry().counter("serve.thread_crashes").inc()
            emit(f"[serve] brownout thread crashed: {type(e).__name__}: {e}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    @classmethod
    def from_config(cls, bc, signals: SignalReader, targets=()) -> "BrownoutController":
        """Build from a config.BrownoutConfig block (both CLIs)."""
        return cls(
            signals, targets,
            interval_s=bc.interval_s,
            up_p99_ms=bc.up_p99_ms, down_p99_ms=bc.down_p99_ms,
            up_queue_depth=bc.up_queue_depth, down_queue_depth=bc.down_queue_depth,
            hold_up_s=bc.hold_up_s, cooldown_s=bc.cooldown_s,
            max_level=bc.max_level, retry_after_s=bc.retry_after_s,
        )

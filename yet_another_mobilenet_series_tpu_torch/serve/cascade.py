# Copy of yet_another_mobilenet_series_tpu/serve/cascade.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Confidence cascade: cheap model answers, uncertain answers escalate.

FLASH/LANA-style cascading is the zoo's dominant cost lever: most requests
are EASY — a small int8 model's top-1 is already the big model's top-1 —
and the expensive tier should only burn FLOPs on the requests the small
tier is unsure about. :class:`CascadeTier` implements that policy at the
ROUTER level: it speaks the same submit protocol the frontend consumes
(``submit(image, priority, deadline_ms, ctx) -> Future`` + ``state()``),
wraps a :class:`~.router.Router`, and for each request

1. routes it to the **small** tier (a normal router submit — weighted
   pick over the replicas advertising the small model, retries, hedging);
2. scores the answer's confidence as the **top-1 softmax margin**
   (``p1 - p2`` — how far the winner is ahead of the runner-up);
3. **answers from the small tier** when the margin clears
   ``cascade.threshold`` (``serve.cascade.answered_small``), or
   **re-submits to the big tier** when it does not
   (``serve.cascade.escalations``), riding the SAME leg machinery
   (placement-aware pick, transport retries, hedging) with the escalation's
   legs stamped at ``TRACE_SEQ_CASCADE_BASE`` (serve/context.py) — a merged
   fleet trace shows small-leg -> escalation-leg as distinct rows of one
   request, never confused with a retry or a hedge.

Deadline preservation: the escalation inherits the request's REMAINING
deadline budget (elapsed small-tier time subtracted). A request whose
budget is already burned when the low-confidence answer lands returns the
small answer instead of escalating into a certain 504 — a degraded answer
beats a typed failure at the same cost (``serve.cascade.deadline_skips``).
An escalation that FAILS (no big-tier replica, transport exhaustion) also
falls back to the small answer (``serve.cascade.escalation_failures``) —
the cascade may never make a request fail that the small tier answered.

Explicit model pins: a request naming a model via ``X-Model`` bypasses the
cascade (``respect_explicit_model=True``, the default) — the cascade is a
policy for clients that did NOT choose; a client that chose gets exactly
what it asked for.

Instrumentation: ``serve.cascade.escalations`` /
``serve.cascade.answered_small`` counters, the ``serve.cascade.
escalation_rate`` gauge (escalations / decided), per-tier
``serve.cascade.latency_seconds.{small,big}`` histograms, and a
``serve.cascade.margin`` histogram of observed confidence margins (the
threshold-tuning instrument: its quantiles say what any given threshold
would have escalated).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np

from ..obs.registry import get_registry
from .context import TRACE_SEQ_CASCADE_BASE, RequestContext


def softmax_margin(logits) -> float:
    """Top-1 softmax margin of one logits row: ``p_top1 - p_top2`` in
    [0, 1]. Shift-invariant and monotone in the top-two logit gap; a
    single-class row is maximally confident by definition."""
    row = np.asarray(logits, np.float64).reshape(-1)
    if row.size < 2:
        return 1.0
    z = row - row.max()
    p = np.exp(z)
    p /= p.sum()
    top2 = np.partition(p, -2)[-2:]
    return float(top2[1] - top2[0])


class CascadeTier:
    """Router-level confidence cascade over a small and a big zoo tenant.

    Drop-in for the router in the frontend's admission slot: everything
    but ``submit``/``state`` delegates to the wrapped router (membership
    registration, backends, brownout — the cascade is routing POLICY, not
    membership)."""

    def __init__(self, router, *, small: str, big: str, threshold: float = 0.15,
                 respect_explicit_model: bool = True):
        if not 0.0 <= float(threshold) <= 1.0:
            raise ValueError(f"cascade threshold must be in [0, 1], got {threshold}")
        if small == big:
            raise ValueError(f"cascade small and big tiers are both {small!r}")
        self._router = router
        self.small = small
        self.big = big
        self.threshold = float(threshold)
        self._respect_explicit = bool(respect_explicit_model)
        self._reg = get_registry()
        self._lock = threading.Lock()
        self._escalations = 0
        self._answered_small = 0

    # -- the serving protocol (what Frontend consumes) -----------------------

    def submit(self, image, *, priority: str | None = None,
               deadline_ms: float | None = None, ctx=None,
               model: str | None = None) -> Future:
        model = model or (ctx.model if ctx is not None else None)
        if model is not None and self._respect_explicit:
            # the client PINNED a tenant: policy defers to choice
            self._reg.counter("serve.cascade.bypassed_explicit").inc()
            return self._router.submit(image, priority=priority,
                                       deadline_ms=deadline_ms, ctx=ctx, model=model)
        outer: Future = Future()
        t0 = time.perf_counter()
        inner = self._router.submit(image, priority=priority,
                                    deadline_ms=deadline_ms, ctx=ctx, model=self.small)
        inner.add_done_callback(
            lambda f: self._on_small(f, outer, image, priority, deadline_ms, ctx, t0)
        )
        return outer

    def _on_small(self, inner: Future, outer: Future, image, priority,
                  deadline_ms, ctx, t0: float) -> None:
        try:  # a crashed policy callback must not hang the outer future
            exc = inner.exception()
            if exc is not None:
                # the small tier FAILED (typed shed, no replica, ...): the
                # verdict passes through — cascading is for answers, not
                # for masking the fleet's admission decisions
                outer.set_exception(exc)
                return
            logits = inner.result()
            elapsed_s = time.perf_counter() - t0
            self._reg.histogram("serve.cascade.latency_seconds.small").observe(elapsed_s)
            margin = softmax_margin(logits)
            self._reg.histogram("serve.cascade.margin").observe(margin)
            if margin >= self.threshold:
                self._decided(escalated=False)
                self._reg.counter("serve.cascade.answered_small").inc()
                outer.set_result(logits)
                return
            remaining_ms = None
            if deadline_ms is not None:
                remaining_ms = deadline_ms - elapsed_s * 1e3
                if remaining_ms <= 0.0:
                    # the budget is gone: a degraded answer now beats a
                    # guaranteed 504 after another round trip
                    self._decided(escalated=False)
                    self._reg.counter("serve.cascade.deadline_skips").inc()
                    self._reg.counter("serve.cascade.answered_small").inc()
                    outer.set_result(logits)
                    return
            self._decided(escalated=True)
            self._reg.counter("serve.cascade.escalations").inc()
            # the escalation is its own routed request: a fresh context
            # (new trace id) pinned to the big tier, its legs stamped in
            # the cascade band (TRACE_SEQ_CASCADE_BASE) so the merged
            # trace tells an escalation from a retry or a hedge
            esc_ctx = RequestContext.mint(
                ctx.cls if ctx is not None else (priority or "interactive"),
                remaining_ms,
                client_tag=f"{ctx.wire_id}-cascade" if ctx is not None else None,
                model=self.big,
            )
            t_big = time.perf_counter()
            big_fut = self._router.submit(
                image, priority=priority, deadline_ms=remaining_ms, ctx=esc_ctx,
                model=self.big, seq_base=TRACE_SEQ_CASCADE_BASE,
            )
            big_fut.add_done_callback(
                lambda f: self._on_big(f, outer, logits, t_big)
            )
        except Exception as e:  # noqa: BLE001 — resolve, never hang
            if not outer.done():
                outer.set_exception(e)

    def _on_big(self, big_fut: Future, outer: Future, small_logits, t_big: float) -> None:
        try:
            exc = big_fut.exception()
            if exc is None:
                self._reg.histogram("serve.cascade.latency_seconds.big").observe(
                    time.perf_counter() - t_big)
                outer.set_result(big_fut.result())
                return
            # escalation failed: the small answer stands — the cascade may
            # never turn an answered request into a failure
            self._reg.counter("serve.cascade.escalation_failures").inc()
            outer.set_result(small_logits)
        except Exception as e:  # noqa: BLE001 — resolve, never hang
            if not outer.done():
                outer.set_exception(e)

    def _decided(self, *, escalated: bool) -> None:
        with self._lock:
            if escalated:
                self._escalations += 1
            else:
                self._answered_small += 1
            decided = self._escalations + self._answered_small
            rate = self._escalations / decided if decided else 0.0
        self._reg.gauge("serve.cascade.escalation_rate").set(rate)

    # -- introspection -------------------------------------------------------

    def state(self) -> dict:
        doc = self._router.state()
        with self._lock:
            decided = self._escalations + self._answered_small
            doc["cascade"] = {
                "small": self.small,
                "big": self.big,
                "threshold": self.threshold,
                "escalations": self._escalations,
                "answered_small": self._answered_small,
                "escalation_rate": (self._escalations / decided) if decided else 0.0,
            }
        return doc

    def __getattr__(self, name: str):
        # routing policy wraps membership/observability verbatim: /register,
        # backends(), apply_brownout, start/stop, ... all reach the router
        return getattr(self._router, name)

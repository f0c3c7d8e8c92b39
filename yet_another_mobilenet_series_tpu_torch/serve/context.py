# Copy of yet_another_mobilenet_series_tpu/serve/context.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Per-request identity threaded through the serving stack.

A request crosses four threads on its way to logits — the HTTP handler
(serve/frontend.py), the admission edge (serve/admission.py), the batcher's
collect/dispatch thread (serve/batcher.py, serve/pipeline.py), and the
completion thread that syncs the engine's handle (serve/engine.py
``PendingPrediction.result``). Before this module those hops were
anonymous: spans were flat per-thread events and a hang report could say
"the window is occupied" but not WHOSE request occupied it.

:class:`RequestContext` is the identity that survives the hops: a
process-monotonic request id (echoed to HTTP clients as ``X-Request-Id``),
the QoS class, the deadline, the arrival time, and the current ``phase``.
:meth:`advance` is the ONE place phase transitions emit trace events, so
the producers just call ``ctx.advance("dispatched")`` at the right moment
and the Chrome-trace async waterfall (``serve/request`` envelope with
``serve/queued`` and ``serve/inflight`` sub-phases, ``ph: b``/``e``) plus
the cross-thread flow arrows (``serve/req``, ``ph: s``/``t``/``f``) stay
consistent by construction — all keyed ``id = rid``, so Perfetto renders
one correlated row per request across every thread.

Phases (terminal states never regress — a late duplicate ``advance`` is a
no-op, so the idempotent future-resolution paths in the batcher stay safe):

``arrived`` -> ``queued`` -> ``dispatched`` -> ``completed`` | ``shed`` |
``failed``, then ``resolved`` once the admission future is delivered.

The context is cheap enough to mint per request unconditionally (a counter
increment and a clock read); the trace emission inside ``advance`` is
no-op'd by a disabled tracer exactly like spans.
"""

from __future__ import annotations

import itertools
import time

from ..obs import trace as obs_trace

_IDS = itertools.count(1)

TERMINAL_PHASES = ("completed", "shed", "failed", "resolved")

# hedge legs occupy seq 8+: route_attempts is small (<= ~3 retries per
# leg), so seq = attempt + LEG_SEQ_HEDGE * 8 is unique per (request, leg,
# attempt) and the Perfetto flow id (trace_id * 16 + seq) never collides
TRACE_SEQ_HEDGE_BASE = 8

# cascade escalation legs occupy seq 4..7 (between the primary's 0..3 and
# the hedge's 8+): the big-tier re-submit of a low-confidence small-tier
# answer is its own leg in the fleet trace, never confused with a retry or
# a hedge of the small-tier dispatch (serve/cascade.py)
TRACE_SEQ_CASCADE_BASE = 4


def parse_trace_parent(header: str | None) -> tuple[int, int, str] | None:
    """Parse an ``X-Trace-Parent: <trace_id>-<seq>-<leg>`` header (the
    router stamps one per leg — serve/router.py) into ``(trace_id, seq,
    leg)``. Malformed or absent headers return None: trace propagation is
    best-effort and must never fail a request."""
    if not header:
        return None
    parts = header.strip().split("-", 2)
    if len(parts) != 3:
        return None
    try:
        trace_id, seq = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    if trace_id < 0 or not 0 <= seq < 16 or not parts[2]:
        return None
    return trace_id, seq, parts[2]


def trace_flow_id(trace_id: int, seq: int) -> int:
    """The Perfetto flow-event id shared by the router's ``flow_start`` and
    the replica's ``flow_end`` for one leg: 16 seq slots per trace id."""
    return trace_id * 16 + seq


class RequestContext:
    """Identity + QoS + phase for one in-system serving request."""

    __slots__ = ("rid", "cls", "deadline_ms", "client_tag", "t_arrival", "phase",
                 "trace_id", "trace_seq", "trace_leg", "model")

    def __init__(self, rid: int, cls: str, deadline_ms: float | None, client_tag: str | None = None,
                 trace_parent: str | None = None, model: str | None = None):
        self.rid = rid
        self.cls = cls
        self.deadline_ms = deadline_ms
        # zoo model identity (X-Model header, serve/zoo.py): which named
        # bundle serves this request; None = the replica's default model
        self.model = model
        # a client-supplied X-Request-Id is echoed back verbatim; the
        # internal rid stays monotonic (trace ids must be process-unique)
        self.client_tag = client_tag
        self.t_arrival = time.perf_counter()
        self.phase = "arrived"
        # fleet-level trace identity (X-Trace-Parent, stamped by the router
        # on every leg): the ROUTER's request id + this leg's seq/name, so
        # replica-side trace events carry the fleet-wide correlation key
        parsed = parse_trace_parent(trace_parent)
        self.trace_id = parsed[0] if parsed else None
        self.trace_seq = parsed[1] if parsed else 0
        self.trace_leg = parsed[2] if parsed else None

    @classmethod
    def mint(cls, qos_class: str, deadline_ms: float | None = None,
             client_tag: str | None = None,
             trace_parent: str | None = None,
             model: str | None = None) -> "RequestContext":
        return cls(next(_IDS), qos_class, deadline_ms, client_tag, trace_parent, model)

    @property
    def wire_id(self) -> str:
        """The value echoed as ``X-Request-Id``."""
        return self.client_tag or str(self.rid)

    def age_s(self) -> float:
        return time.perf_counter() - self.t_arrival

    def as_dict(self) -> dict:
        """JSON-safe view for hang reports / varz (watchdog serving info)."""
        return {
            "id": self.rid,
            "class": self.cls,
            "model": self.model,
            "deadline_ms": self.deadline_ms,
            "age_s": self.age_s(),
            "phase": self.phase,
            "trace": self.trace_id,
        }

    def _targs(self) -> dict:
        """Fleet-trace args attached to every emitted event when a trace
        parent rode in: the ROUTER-issued request id (and which leg this
        replica served), so a merged cross-process trace correlates replica
        events to the fleet request without string joins."""
        if self.trace_id is None:
            return {}
        return {"trace": self.trace_id, "leg": self.trace_leg}

    # -- the one trace-emission point ---------------------------------------

    def link_parent(self) -> None:
        """Emit the ``fleet/leg`` flow ARRIVAL (``ph: f``) binding the
        router's leg arrow to this replica's enclosing slice — called inside
        the frontend's ``serve/submit`` span, so Perfetto draws
        router -> leg -> replica as one connected arrow per leg. No-op
        without a trace parent (a direct client, no router above us)."""
        if self.trace_id is None:
            return
        obs_trace.get_tracer().flow_end(
            "fleet/leg", trace_flow_id(self.trace_id, self.trace_seq),
            trace=self.trace_id, leg=self.trace_leg, rid=self.rid,
        )

    def advance(self, phase: str) -> None:
        """Move to ``phase``, emitting the async/flow trace edges for the
        transition. Duplicate and post-terminal advances are no-ops, so
        every resolution path may call this defensively."""
        prev = self.phase
        if phase == prev or prev in TERMINAL_PHASES:
            return
        self.phase = phase
        tr = obs_trace.get_tracer()
        if not tr.enabled:
            return
        if phase == "queued":
            tr.async_begin("serve/queued", self.rid, **self._targs())
            tr.flow_start("serve/req", self.rid, cls=self.cls, **self._targs())
        elif phase == "dispatched":
            tr.async_end("serve/queued", self.rid)
            tr.async_begin("serve/inflight", self.rid, **self._targs())
            tr.flow_step("serve/req", self.rid)
        elif phase in ("completed", "shed", "failed"):
            # close whichever sub-phase the request died in (a reject can
            # fail straight out of "queued"; a shed can happen either side)
            tr.async_end("serve/inflight" if prev == "dispatched" else "serve/queued", self.rid)
            tr.flow_end("serve/req", self.rid, outcome=phase)

    def open_envelope(self) -> None:
        """Async envelope begin (admission, once per admitted request)."""
        obs_trace.get_tracer().async_begin(
            "serve/request", self.rid, cls=self.cls,
            deadline_ms=self.deadline_ms if self.deadline_ms is not None else 0.0,
            **self._targs(),
        )

    def close_envelope(self) -> None:
        """Async envelope end (admission, at final future resolution)."""
        obs_trace.get_tracer().async_end("serve/request", self.rid, outcome=self.phase,
                                         **self._targs())
        self.phase = "resolved"

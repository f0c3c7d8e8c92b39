# Copy of yet_another_mobilenet_series_tpu/serve/router.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Fleet router: weighted routing over N replica frontends.

One replica process is bounded by one host; the millions-of-users story
needs a shared-nothing fleet behind one address. The router is that
address. It speaks the SAME protocol the admission controller speaks
(``submit(image, priority, deadline_ms, ctx) -> Future`` + ``state()``), so
``serve/frontend.py`` can serve it directly — the fleet exposes the exact
endpoints, typed statuses, and ``X-Request-Id`` threading one replica does,
and a client cannot tell N replicas from one.

Routing policy, all driven by what the replicas THEMSELVES report:

- **health polling**: a daemon thread polls every backend's ``/healthz`` at
  ``poll_interval_s``. Each poll refreshes the replica's queue depth
  (``queued_total``), breaker state, draining flag, and identity block
  (``replica_id``/``pid``/``start_unix`` — a changed ``start_unix`` behind
  the same address is a detected restart, ``fleet.replica_restarts``).
- **weighted pick**: routable replicas are drawn with weight
  ``1 / (1 + queue_depth)`` (seeded RNG — reproducible in tests), so load
  skews away from backed-up replicas without starving anyone.
- **ejection / readmission**: ``eject_failures`` consecutive failures
  (poll or dispatch transport errors), an open breaker, or a draining flag
  eject a replica from rotation (``fleet.ejections``); the next healthy
  poll readmits it (``fleet.readmissions``). Ejection is advisory — with
  every replica ejected the router fails typed
  (:class:`NoHealthyReplicas` -> 503), never silently.
- **latency-based soft ejection** (gray failure): crash counters never fire
  for a slow-but-alive replica, so one straggler poisons the fleet p99
  forever. Each replica carries an EWMA of its per-leg dispatch latency;
  every poll sweep compares it against the fleet's (lower) median. A
  multiplicative outlier (``slow_factor`` x median, above an absolute
  ``slow_min_ms`` floor) first has its routing weight DECAYED (halved per
  outlier sweep — load skews away before anything is ejected), and after
  ``slow_eject_after`` consecutive outlier sweeps is ejected
  (``fleet.slow_ejections``, also counted in ``fleet.ejections``). It
  readmits through the existing healthy-poll path after a
  ``slow_cooldown_s`` probation, with a fresh latency estimate — still
  slow, it walks the same decay-then-eject path again; recovered, it stays.
- **backpressure vs death**: a 503 carrying ``Retry-After`` is an
  overloaded-but-healthy replica (breaker cooldown, brownout shed) — the
  request re-routes (``fleet.backpressure``) but the replica's ejection
  counter is NOT touched; a 503 without it (draining, nothing routable
  behind a nested router) scores toward ejection like a transport failure.
- **poll desynchronization**: each replica's next health poll is scheduled
  with per-replica seeded jitter around ``poll_interval_s``, so N routers
  x M replicas cannot phase-lock into a thundering poll herd.
- **transport retry**: a dead socket (:class:`~.client.ClientConnectError`),
  a transport-level read timeout (:class:`~.client.ClientTimeout` — a
  half-open socket or a response-eating link; inference is pure, so the
  duplicate risk is only wasted work), or a replica-side 503 (draining /
  its own breaker) re-routes the request to the next replica
  (``fleet.route_retries``); typed per-request verdicts (429 quota, 504
  deadline, 500 engine error) pass through unchanged — the replica already
  ran ITS retry policy.
- **partition awareness**: the client splits its CONNECT timeout from its
  read timeout (``connect_timeout_s``), and the health poll's read bound
  derives from the connect budget — a /healthz answers in microseconds, so
  a poll that cannot finish inside the connect budget is a partition, not
  a slow reply. A blackholed replica therefore ejects within
  ``eject_failures`` poll sweeps x (interval + connect timeout), never the
  60 s read budget. Ejections whose terminal failure was transport-shaped
  (connect failure / timeout) count ``fleet.partition_ejections``, and an
  ejected replica serves an ``eject_cooldown_s`` probation before a
  healthy poll may readmit it — a flapping link produces ONE bounded
  eject/readmit cycle per cooldown instead of ping-ponging every flap.
- **TTL-leased membership** (the multi-host rung): besides the
  statically-configured backend set (:meth:`set_backends` — the local
  supervisor's view), replicas REGISTER themselves (:meth:`register`, via
  POST /register on the router's frontend) with a TTL lease renewed by
  heartbeat (``fleet.registrations`` / ``fleet.lease_renewals``). A lease
  that expires unrenewed REMOVES the backend (``fleet.lease_expirations``)
  — a silently-vanished host leaves the fleet without anyone having to
  notice it, which no crash signal can do across machines.
- **hedging** (serve/hedge.py): when a :class:`~.hedge.Hedger` is attached
  and >= 2 replicas are routable, a timer fires at the class's p99-derived
  bound and sends a duplicate to a second replica (primary's replica
  excluded); first answer wins, the loser is dropped idempotently.

Instrumentation: ``fleet.routed`` / ``fleet.route_retries`` /
``fleet.route_errors`` / ``fleet.ejections`` / ``fleet.readmissions`` /
``fleet.replica_restarts`` counters, the ``fleet.replicas_routable`` gauge,
per-class ``serve.router.latency_seconds.<class>`` histograms (the hedge
timer's input), and a ``fleet/route`` span per request.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.logging import emit
from .admission import CLASSES, BrownoutShed
from .client import (
    ClientConnectError,
    ClientError,
    ClientHTTPError,
    ClientTimeout,
    ReplicaClient,
)
from .context import TRACE_SEQ_HEDGE_BASE, trace_flow_id
from .hedge import ROUTER_LATENCY, HedgedCall, Hedger


class NoHealthyReplicas(RuntimeError):
    """Every replica is ejected or the backend set is empty: the fleet
    cannot serve this request (mapped to 503 by the frontend)."""


class NoReplicaForModel(NoHealthyReplicas):
    """Replicas are routable, but none ADVERTISES the request's model: a
    placement gap, not a health failure. Subclasses NoHealthyReplicas so
    every existing 503 mapping holds; carries the model so the frontend
    can tag the verdict distinctly."""

    def __init__(self, model: str, served: tuple = ()):  # noqa: D107
        self.model = model
        self.served = tuple(sorted(served))
        super().__init__(
            f"no routable replica serves model {model!r}"
            + (f"; fleet serves: {', '.join(self.served)}" if self.served else "")
        )


class ModelDigestConflict(ValueError):
    """Two replicas are advertising the SAME model name with DIFFERENT
    content digests: routing would be a lottery over which weights answer.
    The conflicting registration is refused (mapped to 409 by the
    frontend); the operator must converge the fleet on one artifact."""


class _Replica:
    """Router-side view of one backend: client + polled health."""

    __slots__ = ("key", "host", "port", "client", "routable", "consecutive_failures",
                 "queue_depth", "breaker_state", "draining", "identity",
                 "lat_ewma_s", "slow_strikes", "slow_until", "weight_scale", "next_poll_t",
                 "source", "lease_until", "eject_until", "models")

    def __init__(self, host: str, port: int, client, source: str = "static"):
        self.key = f"{host}:{port}"
        self.host = host
        self.port = port
        self.client = client
        self.routable = True
        self.consecutive_failures = 0
        self.queue_depth = 0.0
        self.breaker_state = 0
        self.draining = False
        self.identity: dict = {}
        # gray-failure bookkeeping: EWMA of per-LEG dispatch latency (None
        # until the first success), consecutive outlier-sweep strikes, the
        # probation deadline a slow ejection imposes, and the multiplicative
        # weight decay applied while this replica is an outlier
        self.lat_ewma_s: float | None = None
        self.slow_strikes = 0
        self.slow_until = 0.0
        self.weight_scale = 1.0
        # per-replica jittered poll schedule (monotonic deadline)
        self.next_poll_t = 0.0
        # membership: "static" (set_backends — the supervisor's view, no
        # lease) or "lease" (self-registered with a TTL, expires unrenewed)
        self.source = source
        self.lease_until: float | None = None
        # post-ejection probation (monotonic): a healthy poll may not
        # readmit before this — the flap-ping-pong damper
        self.eject_until = 0.0
        # model-sharded placement: {model_name: digest} the replica's lease
        # advertised ('' = unstamped pre-zoo bundle). None = no advertisement
        # (static member / pre-zoo replica) — routable for EVERY model, so a
        # zoo-unaware fleet keeps the pre-zoo routing behavior
        self.models: dict[str, str] | None = None

    def weight(self) -> float:
        return self.weight_scale / (1.0 + max(self.queue_depth, 0.0))

    def as_dict(self) -> dict:
        return {
            "key": self.key,
            "source": self.source,
            "routable": self.routable,
            "queue_depth": self.queue_depth,
            "breaker_state": self.breaker_state,
            "draining": self.draining,
            "consecutive_failures": self.consecutive_failures,
            "lat_ewma_ms": round(self.lat_ewma_s * 1e3, 3) if self.lat_ewma_s is not None else None,
            "slow_strikes": self.slow_strikes,
            "weight_scale": self.weight_scale,
            "identity": self.identity,
            "models": sorted(self.models) if self.models is not None else None,
        }


class Router:
    """Weighted fleet router implementing the frontend's admission protocol."""

    def __init__(
        self,
        backends=(),
        *,
        default_class: str = "interactive",
        poll_interval_s: float = 0.25,
        eject_failures: int = 2,
        route_attempts: int = 3,
        client_timeout_s: float = 60.0,
        hedger: Hedger | None = None,
        seed: int = 0,
        max_workers: int = 32,
        client_factory=None,
        poll_jitter: float = 0.2,
        slow_eject: bool = False,
        slow_factor: float = 3.0,
        slow_eject_after: int = 3,
        slow_cooldown_s: float = 5.0,
        slow_min_ms: float = 1.0,
        lat_alpha: float = 0.3,
        connect_timeout_s: float | None = None,
        eject_cooldown_s: float = 0.0,
        lease_ttl_s: float = 5.0,
    ):
        if default_class not in CLASSES:
            raise ValueError(f"default_class {default_class!r} not in {CLASSES}")
        if not 0.0 <= poll_jitter < 1.0:
            raise ValueError(f"poll_jitter must be in [0, 1), got {poll_jitter}")
        if slow_factor <= 1.0:
            raise ValueError(f"slow_factor must be > 1 (a multiplicative outlier), got {slow_factor}")
        self._default_class = default_class
        self._poll_interval_s = poll_interval_s
        self._poll_jitter = poll_jitter
        self._eject_failures = max(1, int(eject_failures))
        self._route_attempts = max(1, int(route_attempts))
        self._client_timeout_s = client_timeout_s
        self._hedger = hedger
        self._hedging_enabled = True  # brownout L1+ flips this off
        self._shed_classes: frozenset[str] = frozenset()
        self._brownout_level = 0
        self._brownout_retry_after_s = 1.0
        self._slow_eject = bool(slow_eject)
        self._slow_factor = float(slow_factor)
        self._slow_eject_after = max(1, int(slow_eject_after))
        self._slow_cooldown_s = float(slow_cooldown_s)
        self._slow_min_s = slow_min_ms / 1e3
        self._lat_alpha = float(lat_alpha)
        # None = the pre-split single-timeout client (r06 semantics); set,
        # it bounds the TCP handshake AND the health poll's read budget — a
        # /healthz that cannot answer inside the connect budget is a
        # partition, not a slow reply
        self._connect_timeout_s = connect_timeout_s
        self._eject_cooldown_s = float(eject_cooldown_s)
        self._lease_ttl_s = float(lease_ttl_s)
        self._rng = random.Random(seed)
        # the poll scheduler's own stream: pick draws must not perturb the
        # deterministic per-replica jitter (and vice versa)
        self._poll_rng = random.Random(seed + 0x9E37)
        self._client_factory = client_factory or (
            lambda host, port: ReplicaClient(
                host, port, timeout_s=client_timeout_s,
                connect_timeout_s=connect_timeout_s,
            )
        )
        self._lock = threading.Lock()
        self._replicas: dict[str, _Replica] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="fleet-route")
        self._poll_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._reg = get_registry()
        # flight-recorder hook: called with (kind, **fields) for significant
        # fleet events. Some emit sites hold self._lock, so the sink MUST be
        # non-blocking (obs/fleet.py FlightRecorder.record is a deque append)
        self._event_sink = None
        # in-flight ledger: token -> submit record, for the watchdog's
        # "oldest in-flight request" hang-report provider. Tokens are
        # monotonic, so min(token) is the oldest submit
        self._inflight: dict[int, dict] = {}
        self._inflight_ids = itertools.count(1)
        self.set_backends(backends)

    # -- flight-recorder event sink ------------------------------------------

    def set_event_sink(self, sink) -> None:
        """Attach a ``fn(kind, **fields)`` receiving significant fleet
        events (ejections, readmissions, lease expirations, breaker flips,
        hedge outcomes, terminal failures, sheds). The sink is called from
        routing/poll threads — sometimes UNDER the router lock — so it must
        be non-blocking and must not call back into the router."""
        self._event_sink = sink  # yamt-lint: disable=YAMT019 — single-writer wiring at startup; emit sites read the slot lock-free by design

    def _emit_event(self, kind: str, **fields) -> None:
        sink = self._event_sink
        if sink is None:
            return
        try:
            sink(kind, **fields)
        except Exception:  # noqa: BLE001 — observability must never fail routing
            self._reg.counter("fleet.event_sink_errors").inc()

    # -- backend set (the supervisor / autoscaler mutate this) ---------------

    def set_backends(self, backends) -> None:
        """Reconcile the STATIC replica set against ``backends`` (iterable
        of ``(host, port)`` or ``"host:port"``). New backends start
        routable; removed backends have their clients closed. Leased
        (self-registered) members are NOT touched — a local supervisor's
        membership notifications must never evict a remote host that is
        faithfully renewing its lease."""
        want: dict[str, tuple[str, int]] = {}
        for b in backends:
            host, port = b.rsplit(":", 1) if isinstance(b, str) else b
            want[f"{host}:{int(port)}"] = (host, int(port))
        with self._lock:
            for key in [k for k in self._replicas
                        if k not in want and self._replicas[k].source == "static"]:
                rep = self._replicas.pop(key)
                rep.client.close()
            for key, (host, port) in want.items():
                if key not in self._replicas:
                    self._replicas[key] = _Replica(host, port, self._client_factory(host, port))
                elif self._replicas[key].source == "lease":
                    # the supervisor now owns an address that self-registered
                    # earlier: promote it — static membership outranks leases
                    self._replicas[key].source = "static"
                    self._replicas[key].lease_until = None
            self._update_routable_gauge_locked()

    def set_backend_models(self, assignments: dict) -> None:
        """Attach served-model advertisements to members by key
        (``"host:port" -> {model: digest}`` — digest '' when the caller
        only knows placement, e.g. the local supervisor's slot assignment).
        Unknown keys are skipped (the member may have just died); a key
        mapped to None clears its advertisement (routes everything)."""
        with self._lock:
            for key, models in assignments.items():
                rep = self._replicas.get(key)
                if rep is None:
                    continue
                rep.models = (
                    None if models is None
                    else {str(n): str(d or "") for n, d in dict(models).items()}
                )

    # -- TTL-leased membership (the multi-host registration path) ------------

    def register(self, host: str, port: int, *, ttl_s: float | None = None,
                 replica_id: str = "", models=None) -> dict:
        """Admit (or heartbeat-renew) a self-registered backend with a TTL
        lease. First sight counts ``fleet.registrations``; renewals count
        ``fleet.lease_renewals``; a lease that expires unrenewed is swept
        out of membership by the poll loop (``fleet.lease_expirations``).
        Registering an address the static set already owns is a harmless
        renewal no-op (static membership has no lease to expire).

        ``models`` is the replica's served-model advertisement,
        ``{name: digest}`` (digest '' for an unstamped bundle) — the
        model-aware pick routes a request for model M only to replicas
        advertising M. A registration advertising a name whose NON-EMPTY
        digest differs from another live replica's for the same name is
        refused (:class:`ModelDigestConflict`,
        ``fleet.rejected_digest_conflict``): a split-brain fleet where one
        name maps to two different artifacts must fail the late joiner
        loudly, not answer from whichever replica the weighted pick lands
        on."""
        ttl = float(ttl_s) if ttl_s else self._lease_ttl_s
        if ttl <= 0:
            raise ValueError(f"lease ttl_s must be > 0, got {ttl}")
        adv: dict[str, str] | None = None
        if models is not None:
            adv = {str(name): str(digest or "") for name, digest in dict(models).items()}
        key = f"{host}:{int(port)}"
        now = time.monotonic()
        with self._lock:
            if adv:
                for other in self._replicas.values():
                    if other.key == key or not other.models:
                        continue
                    for name, digest in adv.items():
                        have = other.models.get(name)
                        if digest and have and have != digest:
                            self._reg.counter("fleet.rejected_digest_conflict").inc()
                            self._emit_event("digest_conflict", replica=key,
                                             model=name, digest=digest,
                                             holder=other.key, holder_digest=have)
                            raise ModelDigestConflict(
                                f"replica {key} advertises model {name!r} with digest "
                                f"{digest} but live replica {other.key} serves digest "
                                f"{have}; refusing registration — one name, one artifact"
                            )
            rep = self._replicas.get(key)
            if rep is None:
                rep = _Replica(host, int(port), self._client_factory(host, int(port)),
                               source="lease")
                rep.lease_until = now + ttl
                rep.models = adv
                self._replicas[key] = rep
                self._reg.counter("fleet.registrations").inc()
                self._update_routable_gauge_locked()
                new = True
            else:
                if rep.source == "lease":
                    rep.lease_until = now + ttl
                if adv is not None:
                    rep.models = adv
                self._reg.counter("fleet.lease_renewals").inc()
                new = False
        return {"ok": True, "key": key, "ttl_s": ttl, "new": new,
                "source": rep.source, "replica_id": replica_id,
                "models": sorted(adv) if adv is not None else None}

    def deregister(self, host: str, port: int) -> dict:
        """Drop a leased membership immediately (the clean-drain path —
        faster than waiting out the TTL). Static members are supervisor-
        owned and stay; unknown keys are a no-op."""
        key = f"{host}:{int(port)}"
        with self._lock:
            rep = self._replicas.get(key)
            if rep is None or rep.source != "lease":
                return {"ok": False, "key": key,
                        "reason": "unknown" if rep is None else "static"}
            self._replicas.pop(key)
            rep.client.close()
            self._update_routable_gauge_locked()
        self._reg.counter("fleet.deregistrations").inc()
        return {"ok": True, "key": key}

    def _sweep_leases_locked(self, now: float) -> None:
        """Remove leased members whose TTL ran out unrenewed: the replica
        (or its host, or the path to it) is gone — membership must not keep
        routing weight parked on a ghost."""
        expired = [k for k, r in self._replicas.items()
                   if r.source == "lease" and r.lease_until is not None
                   and now >= r.lease_until]
        for key in expired:
            rep = self._replicas.pop(key)
            rep.client.close()
            self._reg.counter("fleet.lease_expirations").inc()
            self._emit_event("lease_expired", replica=key)
        if expired:
            self._update_routable_gauge_locked()

    def _update_routable_gauge_locked(self) -> None:
        self._reg.gauge("fleet.replicas_routable").set(
            sum(1 for r in self._replicas.values() if r.routable)
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Router":
        if self._poll_thread is not None:
            raise RuntimeError("router already started")
        self._stop.clear()
        self._poll_thread = threading.Thread(target=self._poll_loop, name="fleet-poll", daemon=True)
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            for rep in self._replicas.values():
                rep.client.close()

    # -- health polling ------------------------------------------------------

    def _poll_loop(self) -> None:
        try:  # YAMT011: a silently-dead poll thread would freeze health state
            obs_trace.get_tracer().register_thread()
            # the loop ticks FASTER than the poll interval and polls only the
            # replicas whose jittered deadline has passed — per-replica
            # schedules drift apart instead of firing as one herd
            tick = max(self._poll_interval_s / 4.0, 0.02)
            while not self._stop.wait(tick):
                self.poll_once(now=time.monotonic())
        except Exception as e:  # noqa: BLE001 — contain, count, report
            self._reg.counter("serve.thread_crashes").inc()
            emit(f"[fleet] router poll thread crashed: {type(e).__name__}: {e}")

    def _next_poll_t(self, now: float) -> float:
        """The next jittered poll deadline: interval scaled by a seeded draw
        in [1 - jitter, 1 + jitter], per replica per poll — N routers x M
        replicas starting together desynchronize within a few intervals
        instead of thundering every /healthz at once."""
        factor = 1.0 + self._poll_jitter * self._poll_rng.uniform(-1.0, 1.0)
        return now + self._poll_interval_s * factor

    def poll_once(self, now: float | None = None) -> None:
        """One health sweep. With ``now`` (the poll thread's monotonic
        clock), only replicas whose jittered deadline has passed are polled;
        called bare (tests, the bench's deterministic refreshes) it polls
        every backend immediately."""
        force = now is None
        now = time.monotonic() if now is None else now
        with self._lock:
            self._sweep_leases_locked(now)
            reps = [r for r in self._replicas.values() if force or now >= r.next_poll_t]
        # the poll's read budget: /healthz answers in microseconds, so a
        # poll is bounded by the CONNECT budget when one is configured — a
        # blackholed replica then ejects in ~eject_failures x (interval +
        # connect timeout), never the 60 s read timeout
        if self._connect_timeout_s is not None:
            poll_timeout = max(self._connect_timeout_s, 2 * self._poll_interval_s)
        else:
            poll_timeout = max(2.0, 4 * self._poll_interval_s)
        for rep in reps:
            rep.next_poll_t = self._next_poll_t(now)
            try:
                status, doc = rep.client.healthz(timeout_s=poll_timeout)
            except ClientError as e:
                # a poll that TIMES OUT is partition-shaped (blackhole /
                # half-open); a refused/reset one is crash-shaped — both
                # score the same counter, but the ejection they cause is
                # attributed differently (fleet.partition_ejections)
                self._record_failure(
                    rep, kind="timeout" if isinstance(e, ClientTimeout) else "connect",
                    now=now,
                )
                continue
            identity = doc.get("replica") or {}
            with self._lock:
                rep.consecutive_failures = 0
                rep.queue_depth = float(doc.get("queued_total") or 0.0)
                breaker = int(doc.get("breaker_state") or 0)
                if breaker != rep.breaker_state:
                    self._emit_event("breaker_flip", replica=rep.key,
                                     state=breaker, prev=rep.breaker_state)
                rep.breaker_state = breaker
                rep.draining = bool(doc.get("draining"))
                if (identity and rep.identity
                        and identity.get("start_unix") != rep.identity.get("start_unix")):
                    # same address, new process: a supervisor restarted it
                    self._reg.counter("fleet.replica_restarts").inc()
                if identity:
                    rep.identity = identity
                # a slow- or crash-ejected replica serves out its probation
                # before a healthy poll may readmit it (otherwise the very
                # next sweep would readmit and a flapping link would
                # ping-pong eject/readmit every cycle)
                healthy = (status == 200 and not rep.draining
                           and now >= rep.slow_until and now >= rep.eject_until)
                self._set_routable_locked(rep, healthy)
        if reps:
            self._slow_sweep(now)

    # -- gray-failure detection (latency-based soft ejection) ----------------

    def _slow_sweep(self, now: float) -> None:
        """Compare every routable replica's per-leg latency EWMA against the
        fleet's LOWER median (robust in 2-replica fleets: the outlier never
        drags its own threshold up). A multiplicative outlier decays its
        routing weight first; ``slow_eject_after`` consecutive outlier
        sweeps eject it (``fleet.slow_ejections``) into a
        ``slow_cooldown_s`` probation, after which the ordinary healthy
        poll readmits it with a fresh estimate."""
        if not self._slow_eject:
            return
        with self._lock:
            scored = [r for r in self._replicas.values()
                      if r.routable and r.lat_ewma_s is not None]
            if len(scored) < 2:
                return  # no fleet to be an outlier OF
            med = sorted(r.lat_ewma_s for r in scored)[(len(scored) - 1) // 2]
            threshold = max(med * self._slow_factor, self._slow_min_s)
            for rep in scored:
                if rep.lat_ewma_s > threshold:
                    rep.slow_strikes += 1
                    # decay first: load skews away before anything ejects
                    rep.weight_scale = max(rep.weight_scale * 0.5, 1.0 / 16.0)
                    if rep.slow_strikes >= self._slow_eject_after:
                        self._reg.counter("fleet.slow_ejections").inc()
                        self._set_routable_locked(rep, False)
                        rep.slow_until = now + self._slow_cooldown_s
                        # probation starts clean: the estimate that ejected
                        # it must not re-eject it before it serves a request
                        rep.slow_strikes = 0
                        rep.weight_scale = 1.0
                        rep.lat_ewma_s = None
                else:
                    rep.slow_strikes = 0
                    rep.weight_scale = min(1.0, rep.weight_scale * 2.0)

    def _set_routable_locked(self, rep: _Replica, routable: bool) -> None:
        if routable and not rep.routable:
            rep.routable = True
            self._reg.counter("fleet.readmissions").inc()
            self._emit_event("readmission", replica=rep.key)
        elif not routable and rep.routable:
            rep.routable = False
            self._reg.counter("fleet.ejections").inc()
            self._emit_event("ejection", replica=rep.key,
                             consecutive_failures=rep.consecutive_failures)
        self._update_routable_gauge_locked()

    def _record_failure(self, rep: _Replica, kind: str = "connect",
                        now: float | None = None) -> None:
        """Score one transport-shaped failure against a replica. ``kind`` is
        "connect" (refused/reset/dead socket), "timeout" (blackhole /
        half-open — the partition shapes), or "http" (a 503 with no
        comeback hint). The ejection it triggers starts the
        ``eject_cooldown_s`` probation, and transport-shaped kinds count
        ``fleet.partition_ejections`` so a fleet operator can tell a
        network event from a crash loop in one counter."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rep.consecutive_failures += 1
            if rep.consecutive_failures >= self._eject_failures:
                if rep.routable and kind in ("connect", "timeout"):
                    self._reg.counter("fleet.partition_ejections").inc()
                self._set_routable_locked(rep, False)
                rep.eject_until = now + self._eject_cooldown_s

    # -- picking -------------------------------------------------------------

    def _pick(self, exclude: set[str], model: str | None = None) -> _Replica:
        with self._lock:
            pool = [r for r in self._replicas.values() if r.routable and r.key not in exclude]
            if not pool:
                raise NoHealthyReplicas(
                    f"no routable replica ({len(self._replicas)} registered, "
                    f"{len(exclude)} excluded)"
                )
            if model is not None:
                # model-sharded placement: only replicas ADVERTISING the
                # model may answer for it (None advertisement = pre-zoo
                # replica, serves everything). Healthy-but-wrong-model is a
                # placement gap, distinct from NoHealthyReplicas
                served = [r for r in pool if r.models is None or model in r.models]
                if not served:
                    raise NoReplicaForModel(
                        model,
                        {m for r in pool if r.models for m in r.models},
                    )
                pool = served
            weights = [r.weight() for r in pool]
            return self._rng.choices(pool, weights=weights, k=1)[0]

    def set_hedger(self, hedger: Hedger | None) -> None:
        """Swap the hedging policy live (the serve_bench A/B drives both
        arms through ONE router so replica state is shared)."""
        self._hedger = hedger

    def set_slow_ejection(self, enabled: bool) -> None:
        """Flip gray-failure soft ejection live (the --overload bench warms
        the fleet with it off, then arms it at the round start so
        time-to-eject is measured from a known instant)."""
        self._slow_eject = bool(enabled)  # yamt-lint: disable=YAMT019 — bench actuator: single-writer bool flip; the poll loop reads it lock-free by design

    def apply_brownout(self, policy) -> None:
        """The router's slice of a :class:`~.brownout.BrownoutPolicy`:
        hedging on/off (L1 stops duplicating work first) and the classes
        the fleet door sheds with Retry-After (L3+)."""
        self._hedging_enabled = bool(policy.hedging)
        self._shed_classes = frozenset(policy.shed_classes)
        self._brownout_level = int(policy.level)
        self._brownout_retry_after_s = float(policy.retry_after_s)

    def n_routable(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.routable)

    def mean_queue_depth(self) -> float:
        """Mean polled queue depth across routable replicas (the
        autoscaler's backlog signal); 0 with nothing routable."""
        with self._lock:
            depths = [r.queue_depth for r in self._replicas.values() if r.routable]
        return sum(depths) / len(depths) if depths else 0.0

    # -- the serving protocol (what Frontend consumes) -----------------------

    def submit(self, image, *, priority: str | None = None,
               deadline_ms: float | None = None, ctx=None,
               model: str | None = None, seq_base: int | None = None) -> Future:
        # the request's model: explicit kwarg wins, else the ctx's parsed
        # X-Model, else None (pre-zoo request — any replica may answer).
        # seq_base overrides the primary leg's trace-seq origin (the
        # cascade's escalation legs stamp TRACE_SEQ_CASCADE_BASE so a merged
        # trace tells an escalation from a first-tier attempt)
        model = model or (ctx.model if ctx is not None else None)
        cls = priority or self._default_class
        if cls not in CLASSES:
            raise ValueError(f"unknown priority class {cls!r}; valid: {CLASSES}")
        if cls in self._shed_classes:
            # brownout at the FLEET door: cheaper than a hop to any replica
            self._reg.counter("serve.rejected_brownout").inc()
            self._emit_event("request_shed", cls=cls, level=self._brownout_level,
                             rid=ctx.wire_id if ctx is not None else None)
            raise BrownoutShed(
                f"class {cls!r} shed at brownout level L{self._brownout_level}; "
                f"retry after {self._brownout_retry_after_s:.1f}s",
                retry_after_s=self._brownout_retry_after_s,
            )
        fut: Future = Future()
        call = HedgedCall(fut)
        # preserve a uint8 wire body (X-Dtype: u8) end-to-end: forcing f32
        # here would silently 4x the router->replica bytes the quantized
        # wire exists to save; anything else stays on the f32 contract
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = np.asarray(image, np.float32)
        # latency is measured from HERE (submit), not from leg start: router
        # queueing is part of what a client experiences, so the histogram
        # the autoscaler and hedge timer read must include it
        t_submit = time.perf_counter()
        token = next(self._inflight_ids)
        with self._lock:
            self._inflight[token] = {
                "t0": t_submit, "cls": cls,
                "rid": ctx.rid if ctx is not None else None,
            }
        if ctx is not None:
            # router-side request envelope: the router process gets its own
            # serve/request async span keyed by the ROUTER rid (= the fleet
            # trace id the legs carry), so a merged trace shows the fleet
            # view of the request above the per-leg and replica rows
            ctx.open_envelope()
            ctx.advance("queued")

        def _settle(f: Future, token: int = token, ctx=ctx) -> None:
            with self._lock:
                self._inflight.pop(token, None)
            if ctx is None:
                return
            try:
                failed = f.exception() is not None
            except Exception:  # noqa: BLE001 — a cancelled future is "failed"
                failed = True
            ctx.advance("failed" if failed else "completed")
            ctx.close_envelope()

        fut.add_done_callback(_settle)
        self._pool.submit(self._route_guarded, call, image, cls, deadline_ms, ctx,
                          t_submit, model, seq_base)
        return fut

    def _route_guarded(self, call, image, cls, deadline_ms, ctx, t_submit,
                       model=None, seq_base=None) -> None:
        trace_id = ctx.rid if ctx is not None else None
        try:
            self._route(call, image, cls, deadline_ms, ctx, t_submit, model, seq_base)
        except Exception as e:  # noqa: BLE001 — a crashed route must not hang its client
            self._reg.counter("fleet.route_errors").inc()
            self._fail_leg(call, HedgedCall.PRIMARY, e, cls=cls, trace_id=trace_id)

    def _route(self, call, image, cls, deadline_ms, ctx, t_submit,
               model=None, seq_base=None) -> None:
        rid = ctx.wire_id if ctx is not None else None
        # the fleet trace id every leg's X-Trace-Parent carries: the
        # router's own monotonic rid (context.py parse_trace_parent)
        trace_id = ctx.rid if ctx is not None else None
        timer: threading.Timer | None = None
        primary_at: dict = {}
        hedge_s = None
        if self._hedger is not None:
            if self._hedging_enabled:
                hedge_s = self._hedger.timer_s(cls)
            else:
                # brownout L1+: a timer that WOULD have armed is counted as
                # suppressed — the "work we chose not to duplicate" instrument
                if self._hedger.timer_s(cls) is not None and self.n_routable() >= 2:
                    self._hedger.suppressed()
        # the hedge timer arms at LEG start, while the histogram it derives
        # from measures submit -> resolution: under router-side overload the
        # timer inflates past per-leg latency, so hedging naturally backs
        # off instead of doubling the load of an already-saturated fleet
        if hedge_s is not None and self.n_routable() >= 2:
            timer = threading.Timer(
                hedge_s, self._fire_hedge,
                args=(call, image, cls, deadline_ms, rid, trace_id, primary_at, t_submit,
                      model),
            )
            timer.daemon = True
            timer.start()
        try:
            targs = {"trace": trace_id} if trace_id is not None else {}
            if model is not None:
                targs["model"] = model
            with obs_trace.get_tracer().span("fleet/route", "serve", cls=cls, **targs):
                self._leg(call, HedgedCall.PRIMARY, image, cls, deadline_ms, rid,
                          exclude=set(), chosen=primary_at, t_submit=t_submit,
                          trace_id=trace_id, model=model, seq_base=seq_base)
        finally:
            if timer is not None and call.resolved:
                timer.cancel()

    def _fire_hedge(self, call, image, cls, deadline_ms, rid, trace_id, primary_at,
                    t_submit, model=None) -> None:
        try:  # Timer threads die as silently as any other (YAMT011 discipline)
            if not call.launch_hedge():
                return  # primary already resolved; nothing to duplicate
            exclude = {primary_at["key"]} if "key" in primary_at else set()
            self._leg(call, HedgedCall.HEDGE, image, cls, deadline_ms, rid,
                      exclude=exclude, t_submit=t_submit, trace_id=trace_id,
                      model=model)
        except Exception as e:  # noqa: BLE001 — contain: fail the leg, not the thread
            self._reg.counter("fleet.route_errors").inc()
            self._fail_leg(call, HedgedCall.HEDGE, e, cls=cls, trace_id=trace_id)

    def _fail_leg(self, call, leg, exc, *, cls, trace_id) -> None:
        """Deliver a leg failure; when THIS call settles the request (no
        other leg can still answer), record the terminal verdict for the
        flight recorder — failed requests leave a per-request record."""
        if call.err(leg, exc):
            self._emit_event("request_failed", trace=trace_id, cls=cls, leg=leg,
                             error=type(exc).__name__)

    def _leg(self, call, leg, image, cls, deadline_ms, rid, *, exclude, chosen=None,
             t_submit=None, trace_id=None, model=None, seq_base=None) -> None:
        """One leg (primary or hedge) of one request: pick, dispatch, retry
        transport-level failures on other replicas, resolve the call.

        Trace propagation: each ATTEMPT of each leg gets a distinct seq
        (hedge attempts offset by TRACE_SEQ_HEDGE_BASE; a cascade
        escalation's primary legs by TRACE_SEQ_CASCADE_BASE via
        ``seq_base``) stamped into the ``X-Trace-Parent`` header, plus a
        ``fleet/leg`` span with a flow arrow whose id the replica's
        ``link_parent`` flow-end shares — the merged trace draws
        router -> leg -> replica per attempt."""
        tracer = obs_trace.get_tracer()
        tried = set(exclude)
        last_exc: Exception | None = None
        if leg == HedgedCall.HEDGE:
            seq_base = TRACE_SEQ_HEDGE_BASE
        elif seq_base is None:
            seq_base = 0
        for attempt in range(self._route_attempts):
            try:
                rep = self._pick(tried, model)
            except NoHealthyReplicas as e:
                self._fail_leg(call, leg, last_exc or e, cls=cls, trace_id=trace_id)
                return
            if chosen is not None:
                chosen["key"] = rep.key
            tp = None
            targs = {}
            if trace_id is not None:
                # seq < 16 is the parse_trace_parent contract; retries must
                # stay inside their band (primary 0..3, cascade 4..7, hedge
                # 8..15), so clamp to the band width (route_attempts is
                # small — <= ~3 — in any real config)
                span = ((TRACE_SEQ_HEDGE_BASE - seq_base)
                        if seq_base < TRACE_SEQ_HEDGE_BASE else (16 - seq_base))
                seq = seq_base + min(attempt, span - 1)
                tp = f"{trace_id}-{seq}-{leg}"
                targs = {"trace": trace_id, "leg": leg, "seq": seq}
                if model is not None:
                    targs["model"] = model
            t0 = time.perf_counter() if t_submit is None else t_submit
            t_leg = time.perf_counter()
            try:
                with tracer.span("fleet/leg", "serve", replica=rep.key, **targs):
                    if trace_id is not None:
                        # flow DEPARTURE, inside the leg slice so Perfetto
                        # anchors the arrow here; the replica's link_parent
                        # emits the matching arrival (same name/cat/id)
                        tracer.flow_start("fleet/leg", trace_flow_id(trace_id, seq),
                                          **targs)
                    logits = rep.client.predict(
                        image, priority=cls, deadline_ms=deadline_ms, request_id=rid,
                        trace_parent=tp, timeout_s=self._client_timeout_s,
                        model=model,
                    )
            except ClientConnectError as e:
                # the socket is dead — likely a killed replica: score it,
                # move the request to the next one (inference is pure)
                self._record_failure(rep, kind="connect")
                self._reg.counter("fleet.route_retries").inc()
                tried.add(rep.key)
                last_exc = e
                continue
            except ClientTimeout as e:
                # the READ timed out: a half-open socket, a response-eating
                # link, or a mid-flight blackhole. The request may have run
                # server-side — inference is pure, so the only duplicate
                # cost is wasted work — and surfacing a 504 for a fault the
                # fleet can absorb would break the partition-containment
                # contract: score the replica, re-route
                self._record_failure(rep, kind="timeout")
                self._reg.counter("fleet.route_retries").inc()
                tried.add(rep.key)
                last_exc = e
                continue
            except ClientHTTPError as e:
                if e.status == 503:
                    if e.retry_after is not None:
                        # backpressure: the replica is ALIVE, just saturated
                        # (breaker cooldown / brownout shed) — re-route, but
                        # never score its ejection counter: an overloaded
                        # replica and a dead one are different things
                        self._reg.counter("fleet.backpressure").inc()
                    else:
                        # unavailability with no comeback hint (draining,
                        # nothing routable behind it): score toward ejection
                        self._record_failure(rep, kind="http")
                    self._reg.counter("fleet.route_retries").inc()
                    tried.add(rep.key)
                    last_exc = e
                    continue
                # per-request verdict: pass through verbatim
                self._fail_leg(call, leg, e, cls=cls, trace_id=trace_id)
                return
            except ClientError as e:  # timeout: the request burned its budget
                self._fail_leg(call, leg, e, cls=cls, trace_id=trace_id)
                return
            leg_s = time.perf_counter() - t_leg
            with self._lock:
                rep.consecutive_failures = 0
                # per-replica latency estimate (the gray-failure signal):
                # per-LEG time, excluding router queueing — a backed-up
                # router must not make every replica look slow
                rep.lat_ewma_s = (
                    leg_s if rep.lat_ewma_s is None
                    else self._lat_alpha * leg_s + (1 - self._lat_alpha) * rep.lat_ewma_s
                )
            self._reg.histogram(f"{ROUTER_LATENCY}.{cls}").observe(time.perf_counter() - t0)
            self._reg.counter("fleet.routed").inc()
            if call.ok(leg, logits) and call.hedged:
                # a hedge RACE settled: record which leg won and where — the
                # flight recorder's per-request hedge outcome
                self._emit_event("hedge_outcome", winner=leg, replica=rep.key,
                                 trace=trace_id, cls=cls,
                                 leg_ms=round(leg_s * 1e3, 3))
            return
        self._fail_leg(call, leg, last_exc or NoHealthyReplicas("route attempts exhausted"),
                       cls=cls, trace_id=trace_id)

    # -- introspection (healthz / varz via the frontend) ---------------------

    def backends(self) -> list:
        """``(key, client)`` pairs for every registered backend — the
        federation scrape loop (obs/fleet.py) reuses the router's own
        keep-alive clients; ReplicaClient connections are per-thread, so a
        scrape thread never contends with route workers for a socket."""
        with self._lock:
            return [(r.key, r.client) for r in self._replicas.values()]

    def lease_ages(self) -> dict:
        """Per-replica seconds until lease expiry (None = static member, no
        lease) — a hang-report / federation info provider."""
        now = time.monotonic()
        with self._lock:
            return {r.key: (round(r.lease_until - now, 3) if r.lease_until is not None
                            else None)
                    for r in self._replicas.values()}

    def oldest_inflight(self) -> dict | None:
        """The longest-outstanding submitted request (age, class, rid) plus
        the in-flight count — what a hang report needs to say WHOSE request
        the wedged router is sitting on; None when idle."""
        now = time.perf_counter()
        with self._lock:
            if not self._inflight:
                return None
            token = min(self._inflight)
            rec = self._inflight[token]
            n = len(self._inflight)
        return {"age_s": round(now - rec["t0"], 3), "class": rec["cls"],
                "rid": rec["rid"], "inflight": n}

    def replicas_state(self) -> list[dict]:
        with self._lock:
            return [r.as_dict() for r in self._replicas.values()]

    def state(self) -> dict:
        """The frontend's /healthz payload: aggregate availability expressed
        in the breaker vocabulary (0 = serving, 1 = nothing routable -> 503)
        plus the per-replica fleet table."""
        reps = self.replicas_state()
        routable = sum(1 for r in reps if r["routable"])
        return {
            "breaker_state": 0 if routable else 1,
            "breaker": "closed" if routable else "open",
            "queued_total": sum(r["queue_depth"] for r in reps),
            "brownout": {
                "level": self._brownout_level,
                "shed_classes": sorted(self._shed_classes),
                "hedging": self._hedging_enabled,
            },
            "membership": {
                "static": sum(1 for r in reps if r["source"] == "static"),
                "leased": sum(1 for r in reps if r["source"] == "lease"),
                "lease_ttl_s": self._lease_ttl_s,
            },
            "fleet": {
                "total": len(reps), "routable": routable, "replicas": reps,
                # the union of advertised model names (None = zoo-unaware
                # fleet): what NoReplicaForModel's 503 body reports as served
                "models": sorted({m for r in reps if r["models"] for m in r["models"]}) or None,
            },
        }

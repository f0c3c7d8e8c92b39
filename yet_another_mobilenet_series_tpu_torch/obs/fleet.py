# Copy of yet_another_mobilenet_series_tpu/obs/fleet.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Fleet-wide observability: metrics federation + the incident flight
recorder.

One replica's /metrics answers "how is THIS process doing"; a fleet
operator's questions — what is the fleet p99, which replica is burning the
error budget, what happened in the 30 s before that ejection — need signals
JOINED across processes. Two pieces live here, both jax-free (they run in
the router supervisor, which must stay importable without an accelerator):

:class:`FleetFederation` — a pull-based scrape loop over every live
backend's ``/varz`` (driven from the supervisor's main loop on the existing
poll cadence, cli/fleet.py). Replicas ship RAW histogram bucket counts
(``Histogram.state()``): every process bins into the same fixed log-spaced
ladder (obs/registry.py ``DEFAULT_BUCKET_BOUNDS``), so the cross-replica
merge is an exact count sum — the federated fleet quantile is IDENTICAL to
the quantile of the pooled per-replica observations, not an average of
averages. Each scrape:

- sums per-replica bucket-count DELTAS into fleet-windowed per-class p99
  gauges (``fleet.window_p99_seconds.<class>``, through the registry's own
  ``quantiles_from_counts`` — the same interpolation every other consumer
  uses);
- accumulates merged CUMULATIVE counts (``merged`` in :meth:`snapshot`,
  the bench's federation-correctness oracle);
- feeds the SLO tracker (serve/signals.py :class:`~..serve.signals.SLOTracker`)
  with summed completed/bad deltas and exports its burn rates
  (``fleet.slo_burn_rate.{short,long}``);
- refreshes the replica-labeled Prometheus families
  (:meth:`render_prometheus`, appended to the router frontend's /metrics):
  ``fleet_<family>_bucket{replica="...",...,le="..."}`` per histogram plus
  every replica's ``fleet_build_info{replica="..."} 1`` under one family.

:class:`FlightRecorder` — a bounded ring of significant fleet events
(ejections/readmissions, lease expirations, breaker flips, brownout
transitions, hedge outcomes, terminal records for failed/shed requests),
fed by the router's event sink (``Router.set_event_sink``) and the brownout
controller (the recorder is an ``apply_brownout`` target). On a trigger —
brownout reaching ``incident_level``, any ejection, or SLO fast-burn — the
NEXT :meth:`maybe_dump` writes ``incident_<reason>.json``: the ring, the
federated snapshot, and the last per-replica /varz — the "what was the
fleet doing when it went wrong" artifact, rate-limited so a flapping
trigger cannot spam the log dir.

Threading: ``record`` is called from routing/poll threads, sometimes UNDER
the router lock, so it is a bare ``deque.append`` + attribute store (both
GIL-atomic) — no lock, no I/O. All file I/O happens in ``maybe_dump`` on
the supervisor's main loop. ``scrape_once`` is single-owner (the main
loop); the handler-facing readers (``render_prometheus`` / ``snapshot``)
take the federation lock only to copy out the last scrape's state.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from .registry import (
    PROM_LABEL_FAMILIES,
    _fmt,
    _prom_name,
    get_registry,
    quantiles_from_counts,
)

# the per-replica counter families summed into the SLO tracker's feed:
# total = completed + bad; bad = everything that burned budget (typed
# rejections, deadline sheds, engine failures)
_SLO_TOTAL_PREFIXES = ("serve.completed.",)
_SLO_BAD_PREFIXES = ("serve.rejected.", "serve.shed_deadline.", "serve.failed")

# event kinds that arm an incident dump on their own (a fast-burn trigger
# arrives via trigger(); brownout transitions via apply_brownout)
_TRIGGER_KINDS = frozenset({"ejection", "lease_expired"})


def _prom_family_labeled(name: str) -> tuple[str, str]:
    """(family, label-clause) for one federated metric name, reusing the
    registry's fold rules (serve.latency_seconds.interactive ->
    class="interactive") under the ``fleet_`` namespace — federated
    families must not collide with the router's OWN local families on the
    same /metrics page."""
    if "." in name:
        fam, suffix = name.rsplit(".", 1)
        label = PROM_LABEL_FAMILIES.get(fam)
        if label is not None:
            return "fleet_" + _prom_name(fam), f'{label}="{suffix}"'
    return "fleet_" + _prom_name(name), ""


class FleetFederation:
    """Scrape-merge loop over every backend's /varz (see module docstring)."""

    def __init__(
        self,
        backends_fn,
        *,
        slo=None,
        recorder=None,
        signal_classes=("interactive",),
        latency_family: str = "serve.latency_seconds",
        scrape_timeout_s: float = 2.0,
    ):
        # () -> [(key, client)]: the router's own keep-alive clients
        # (Router.backends) — ReplicaClient connections are per-thread, so
        # the scrape never contends with route workers for a socket
        self._backends_fn = backends_fn
        self._slo = slo
        self._recorder = recorder
        self._signal_classes = tuple(signal_classes)
        self._latency_family = latency_family
        self._scrape_timeout_s = float(scrape_timeout_s)
        self._reg = get_registry()
        self._lock = threading.Lock()
        # per-(replica, histogram) previous counts for windowed deltas, and
        # per-(replica, counter) previous values for the SLO feed
        self._prev_counts: dict[tuple[str, str], list[int]] = {}
        self._prev_flat: dict[tuple[str, str], float] = {}
        # merged cumulative bucket counts per histogram name (exact sum of
        # every delta ever scraped — survives replica restarts, which a
        # naive "sum the cumulative counts" would double-count or lose)
        self._merged: dict[str, dict] = {}
        self._last_varz: dict[str, dict] = {}
        self._last_p99: dict[str, float | None] = {}
        self._scrapes = 0
        self._errors = 0

    # -- the scrape (single-owner: the supervisor main loop) -----------------

    def scrape_once(self) -> dict:
        """Pull every backend's /varz once; merge. Returns a summary dict
        (scraped/error counts) for the caller's log line. A replica that
        fails to answer is skipped this tick — federation is best-effort
        and must never take the router down."""
        t0 = time.perf_counter()
        docs: dict[str, dict] = {}
        errors = 0
        for key, client in self._backends_fn():
            try:
                status, doc = client.varz(timeout_s=self._scrape_timeout_s)
            except Exception:  # noqa: BLE001 — a dead replica is a skipped scrape
                errors += 1
                continue
            if status != 200 or not isinstance(doc, dict):
                errors += 1
                continue
            docs[key] = doc
        window_deltas: dict[str, list[int]] = {}
        slo_total = 0.0
        slo_bad = 0.0
        with self._lock:
            for key, doc in docs.items():
                for name, st in (doc.get("histograms") or {}).items():
                    counts = [int(c) for c in st.get("counts") or []]
                    prev = self._prev_counts.get((key, name))
                    delta = self._delta(counts, prev)
                    self._prev_counts[(key, name)] = counts
                    self._merge_cumulative(name, st, delta)
                    if name.startswith(self._latency_family + "."):
                        cls = name[len(self._latency_family) + 1:]
                        acc = window_deltas.setdefault(cls, [0] * len(delta))
                        if len(acc) == len(delta):
                            for i, d in enumerate(delta):
                                acc[i] += d
                flat = doc.get("metrics") or {}
                slo_total += self._flat_delta(key, flat, _SLO_TOTAL_PREFIXES)
                slo_bad += self._flat_delta(key, flat, _SLO_BAD_PREFIXES)
            self._last_varz = docs
            self._scrapes += 1
            self._errors += errors
            # fleet-windowed per-class p99 off the summed deltas: the exact
            # quantile of every completion the fleet saw since last tick
            for cls in self._signal_classes:
                delta = window_deltas.get(cls)
                bounds = (self._merged.get(f"{self._latency_family}.{cls}") or {}).get("bounds")
                if delta and bounds and sum(delta):
                    (p99,) = quantiles_from_counts(bounds, delta, (0.99,))
                else:
                    p99 = None
                self._last_p99[cls] = p99
                self._reg.gauge(f"fleet.window_p99_seconds.{cls}").set(p99 or 0.0)
        self._reg.gauge("fleet.federated_replicas").set(len(docs))
        primary = self._signal_classes[0] if self._signal_classes else None
        if self._slo is not None:
            total = slo_total + slo_bad
            self._slo.observe(int(total), int(slo_bad),
                              p99_s=self._last_p99.get(primary))
            self._reg.gauge("fleet.slo_burn_rate.short").set(
                self._slo.burn_rate(self._slo.short_window_s))
            self._reg.gauge("fleet.slo_burn_rate.long").set(
                self._slo.burn_rate(self._slo.long_window_s))
            if self._slo.fast_burn and self._recorder is not None:
                self._recorder.trigger("slo_fast_burn")
        self._reg.histogram("fleet.scrape_seconds").observe(time.perf_counter() - t0)
        return {"scraped": len(docs), "errors": errors}

    @staticmethod
    def _delta(counts: list[int], prev: list[int] | None) -> list[int]:
        """Per-bucket delta with counter-reset handling: a replica restart
        zeroes its histograms, so any negative component means the current
        counts ARE the delta (the fresh process's whole history)."""
        if prev is None or len(prev) != len(counts):
            return list(counts)
        delta = [c - p for c, p in zip(counts, prev)]
        if any(d < 0 for d in delta):
            return list(counts)
        return delta

    def _merge_cumulative(self, name: str, st: dict, delta: list[int]) -> None:
        bounds = list(st.get("bounds") or [])
        m = self._merged.get(name)
        if m is None or m["bounds"] != bounds or len(m["counts"]) != len(delta):
            self._merged[name] = {"bounds": bounds, "counts": list(delta)}
            return
        for i, d in enumerate(delta):
            m["counts"][i] += d

    def _flat_delta(self, key: str, flat: dict, prefixes) -> float:
        """Sum of deltas of every flat metric matching ``prefixes`` for one
        replica (reset-aware, like :meth:`_delta`)."""
        out = 0.0
        for name, value in flat.items():
            if not any(name == p or name.startswith(p) for p in prefixes):
                continue
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            prev = self._prev_flat.get((key, name), 0.0)
            d = v - prev
            self._prev_flat[(key, name)] = v
            out += v if d < 0 else d  # reset: the fresh count is the delta
        return out

    # -- handler-facing readers ----------------------------------------------

    def last_varz(self) -> dict:
        """The most recent per-replica /varz documents (incident dumps)."""
        with self._lock:
            return dict(self._last_varz)

    def merged_counts(self) -> dict:
        """{histogram name: {"bounds", "counts"}} — the fleet's cumulative
        merged bucket counts (the bench's federation oracle)."""
        with self._lock:
            return {k: {"bounds": list(v["bounds"]), "counts": list(v["counts"])}
                    for k, v in self._merged.items()}

    def snapshot(self) -> dict:
        """JSON view for the router's /varz ``fleet`` section and incident
        dumps: who was scraped, the fleet-windowed tails, SLO state."""
        with self._lock:
            replicas = {
                key: {
                    "identity": (doc.get("replica") or {}),
                    "draining": bool(doc.get("draining")),
                    "queued_total": (doc.get("admission") or {}).get("queued_total"),
                }
                for key, doc in self._last_varz.items()
            }
            out = {
                "replicas": replicas,
                "window_p99_s": dict(self._last_p99),
                "scrapes": self._scrapes,
                "scrape_errors": self._errors,
            }
        if self._slo is not None:
            out["slo"] = self._slo.state()
        return out

    def render_prometheus(self) -> str:
        """Replica-labeled exposition of the last scrape: every replica's
        histogram families under the ``fleet_`` namespace with a
        ``replica="<id>"`` label, plus one ``fleet_build_info`` family
        carrying every replica's identity labels. Deterministic ordering
        (sorted replicas x sorted families) so the output golden-tests."""
        with self._lock:
            docs = dict(self._last_varz)
        lines: list[str] = []
        typed: set[str] = set()
        binfo_lines: list[str] = []
        for key in sorted(docs):
            doc = docs[key]
            rid = str((doc.get("replica") or {}).get("replica_id") or key)
            binfo = doc.get("build_info") or {}
            labels = ",".join([f'replica="{rid}"'] + [
                f'{_prom_name(k)}="{v}"' for k, v in sorted(binfo.items())
            ])
            binfo_lines.append(f"fleet_build_info{{{labels}}} 1")
            for name in sorted(doc.get("histograms") or {}):
                st = doc["histograms"][name]
                fam, label = _prom_family_labeled(name)
                if fam not in typed:
                    typed.add(fam)
                    lines.append(f"# TYPE {fam} histogram")
                base = f'replica="{rid}"' + (f",{label}" if label else "")
                cum = 0
                for bound, c in zip(st.get("bounds") or [], st.get("counts") or []):
                    cum += int(c)
                    lines.append(f'{fam}_bucket{{{base},le="{_fmt(bound)}"}} {cum}')
                total = int(st.get("count") or 0)
                lines.append(f'{fam}_bucket{{{base},le="+Inf"}} {total}')
                lines.append(f"{fam}_sum{{{base}}} {_fmt(st.get('sum') or 0.0)}")
                lines.append(f"{fam}_count{{{base}}} {total}")
        out = []
        if binfo_lines:
            out.append("# TYPE fleet_build_info gauge")
            out.extend(binfo_lines)
        out.extend(lines)
        return "\n".join(out) + "\n" if out else ""


class FlightRecorder:
    """Bounded ring of significant fleet events + triggered incident dumps
    (see module docstring). ``record`` is the router's event sink; the
    brownout controller drives :meth:`apply_brownout`; the supervisor main
    loop drives :meth:`maybe_dump`."""

    def __init__(self, log_dir: str, *, ring: int = 256,
                 min_interval_s: float = 30.0, incident_level: int = 3):
        self.log_dir = log_dir
        self.incident_level = int(incident_level)
        self.min_interval_s = float(min_interval_s)
        self._ring: collections.deque = collections.deque(maxlen=max(int(ring), 8))
        # the armed trigger reason (None = nothing pending): a plain
        # attribute store — record() runs under the router lock and must
        # not block, and a GIL-atomic store is all arming needs
        self._pending: str | None = None
        self._last_dump_t = float("-inf")  # monotonic
        self._brownout_level = 0
        self._dumps = 0
        self._reg = get_registry()

    # -- producers (non-blocking; may run under the router lock) -------------

    def record(self, kind: str, **fields) -> None:
        """Append one event. Wall-clock timestamp BY DESIGN: incident
        events are read next to per-replica logs from other hosts, so the
        timeline must be in shared wall time, never differenced into a
        duration (the YAMT017 hazard is subtraction, not the reading)."""
        evt = {"t_unix": time.time(), "kind": str(kind)}
        evt.update(fields)
        self._ring.append(evt)  # deque.append is GIL-atomic; no lock, no I/O
        if kind in _TRIGGER_KINDS:
            self._pending = kind  # GIL-atomic arm; maybe_dump (single consumer) clears it

    def apply_brownout(self, policy) -> None:
        """Brownout-target protocol (serve/brownout.py): record level
        transitions; a climb to ``incident_level`` or beyond arms a dump."""
        level = int(policy.level)
        prev = self._brownout_level
        if level == prev:
            return
        self._brownout_level = level
        self.record("brownout_transition", level=level, prev=prev,
                    shed_classes=sorted(policy.shed_classes),
                    hedging=bool(policy.hedging))
        if level >= self.incident_level and level > prev:
            self._pending = f"brownout_l{level}"  # GIL-atomic arm, single consumer

    def trigger(self, reason: str) -> None:
        """Arm an incident dump explicitly (the federation's SLO fast-burn
        path)."""
        self.record("trigger", reason=str(reason))
        self._pending = str(reason)  # GIL-atomic arm, single consumer

    # -- the consumer (supervisor main loop) ---------------------------------

    def events(self) -> list[dict]:
        return list(self._ring)

    def maybe_dump(self, federation=None) -> str | None:
        """Write ``incident_<reason>.json`` if a trigger is armed and the
        rate limit allows; returns the path (None = nothing written). The
        artifact is self-contained: the event ring, the federated fleet
        snapshot, the last per-replica /varz, and the local registry — what
        a responder needs WITHOUT the processes that produced it."""
        reason = self._pending
        if reason is None:
            return None
        now = time.monotonic()
        if now - self._last_dump_t < self.min_interval_s:
            return None  # stay armed; dump when the limiter reopens
        self._pending = None  # single consumer by contract (supervisor main loop)
        self._last_dump_t = now
        doc = {
            "reason": reason,
            # wall timestamp for cross-host correlation (never differenced)
            "t_unix": time.time(),
            "brownout_level": self._brownout_level,
            "events": self.events(),
            "registry": self._reg.snapshot(),
        }
        if federation is not None:
            doc["fleet"] = federation.snapshot()
            doc["replica_varz"] = federation.last_varz()
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
        path = os.path.join(self.log_dir, f"incident_{safe}.json")
        os.makedirs(self.log_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)  # atomic: a reader sees whole JSON or nothing
        self._dumps += 1
        self._reg.counter("fleet.incidents").inc()
        return path

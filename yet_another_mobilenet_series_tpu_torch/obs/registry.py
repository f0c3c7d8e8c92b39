# Copy of yet_another_mobilenet_series_tpu/obs/registry.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Process-wide typed metrics registry (counters, gauges, histograms).

Unifies the runtime signals that previously lived as ad-hoc module state
(native-loader decode failures reached into from the train loop, bare
``print`` warnings in the data pipeline, checkpoint barrier waits and
post-rematerialize rebuilds that were invisible outside one-off benches).
Producers anywhere in the process register/update metrics by name;
``Logger.scalars`` snapshots the whole registry into every metrics row, so
one ``metrics.jsonl`` stream carries every signal.

Histograms are BUCKETED: every observation lands in a fixed log-spaced
bucket ladder (``DEFAULT_BUCKET_BOUNDS``, overridable per registry via
``set_default_buckets`` — the ``obs.histogram_buckets`` config knob — or per
histogram at creation), so online p50/p95/p99 estimates come out of
``snapshot()`` without keeping samples: the quantile is linearly
interpolated inside the bucket that crosses the target rank, clamped to the
tracked min/max. Error is bounded by one bucket width (~1.78x per rung on
the default quarter-decade ladder) — tests/test_obs.py pins the estimate
against a sorted-sample reference. ``render_prometheus()`` emits the same
state as Prometheus text exposition (``GET /metrics`` on the serving
frontend): histogram families get cumulative ``_bucket{le=...}`` lines plus
``quantile=`` samples, and dotted per-class/per-bucket metric names
(``serve.latency_seconds.interactive``) fold into one labeled family
(``serve_latency_seconds{class="interactive"}``) via ``PROM_LABEL_FAMILIES``.

Thread-safety: metric updates are single bytecode-level mutations guarded by
a lock only where a read-modify-write races (counter inc, histogram
observe); ``snapshot()`` may be called from the watchdog thread at any time.
Gauges may be backed by a pull callback (``set_fn``) so sources that already
keep their own total (the native loader's C-side failure count) are read
lazily at snapshot time instead of being pushed per batch.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Sequence

# Quarter-decade log ladder from 100 µs to ~56 s (24 bounds + overflow):
# wide enough for queue waits and whole-request latencies, fine enough that
# a one-bucket quantile error is ~1.78x — the SLO question is "is p99 5 ms
# or 50 ms", not "5.0 or 5.2". Durations in seconds by convention.
DEFAULT_BUCKET_BOUNDS: tuple[float, ...] = tuple(
    round(1e-4 * (10.0 ** 0.25) ** i, 10) for i in range(24)
)

# Rendered quantiles: snapshot()/render_prometheus() columns and the serving
# frontend's /varz payload all agree on this set.
QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99)

# Dotted families whose last segment is a label value, not part of the
# metric name: "serve.latency_seconds.interactive" is one sample of the
# serve_latency_seconds family at class="interactive" in the exposition.
PROM_LABEL_FAMILIES: dict[str, str] = {
    "serve.latency_seconds": "class",
    "serve.requests": "class",
    "serve.completed": "class",
    "serve.rejected": "class",
    "serve.retries": "class",
    "serve.shed_deadline": "class",
    "serve.bucket_hits": "bucket",
    # the fleet router's per-class latency (the hedge timer's input)
    "serve.router.latency_seconds": "class",
    # brownout ladder transitions split by direction (up = degrading)
    "serve.brownout_transitions": "direction",
    # fleet-federated derived gauges (obs/fleet.py): windowed fleet-wide
    # p99 per class from exactly-merged replica bucket counts, and the SLO
    # tracker's burn rate per window (short/long — serve/signals.py)
    "fleet.window_p99_seconds": "class",
    "fleet.slo_burn_rate": "window",
    # per-tenant accounting on a zoo-serving replica (serve/admission.py)
    "serve.model_requests": "model",
    "serve.model_completed": "model",
    "serve.model_latency_seconds": "model",
    # per-model image throughput split (serve/engine.py; DEFAULT_MODEL
    # rides the unlabeled total only)
    "serve.infer_images": "model",
    # per-model ring-window split (serve/engine.py ring_dispatch; same
    # DEFAULT_MODEL-rides-the-total convention as infer_images)
    "serve.ring_dispatches": "model",
    # XLA cost_analysis gauges keyed by executable (obs/device.py)
    "obs.cost_flops": "key",
    "obs.cost_bytes": "key",
}


class Counter:
    """Monotonic count. ``inc`` is the only mutator."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written value, or a pull callback (``set_fn``) read at snapshot
    time. A callback that raises falls back to the last good reading — a
    dying producer (e.g. a closed ctypes loader) must not take the metrics
    stream down with it."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        self._value = float(value)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                self._value = float(self._fn())
            except Exception:  # yamt-lint: disable=YAMT012 — documented: a dying pull producer keeps the last good reading
                pass
        return self._value


class Histogram:
    """Streaming summary stats (count/sum/min/max) plus fixed log-spaced
    bucket counts, so online quantile estimates (p50/p95/p99) come out of a
    snapshot without keeping samples — "how many, how long, worst case, AND
    where the tail sits" for durations like request latencies."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "bounds", "_bucket_counts", "_lock")

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKET_BOUNDS):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError(f"histogram {name!r} needs at least one bucket bound")
        # bucket i counts values <= bounds[i] (and > bounds[i-1]); the last
        # slot is the +Inf overflow bucket
        self._bucket_counts = [0] * (len(self.bounds) + 1)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)
            self._bucket_counts[bisect.bisect_left(self.bounds, v)] += 1

    def bucket_counts(self) -> tuple[int, ...]:
        """Per-bucket counts (NOT cumulative), one per bound + the overflow
        slot. Consistent snapshot: taken under the observe lock."""
        with self._lock:
            return tuple(self._bucket_counts)

    def state(self) -> dict:
        """The RAW mergeable state — bounds, non-cumulative counts, running
        count/sum/min/max — as one consistent JSON-safe snapshot. This is
        what /varz ships for metrics federation (obs/fleet.py): identical
        fixed bucket ladders make the cross-replica merge an exact count
        sum, so fleet quantiles lose nothing the per-replica ones had."""
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._bucket_counts),
                "count": self.count,
                "sum": self.total,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None,
            }

    def _quantiles_locked(self, qs: Sequence[float]) -> list[float]:
        return quantiles_from_counts(
            self.bounds, self._bucket_counts, qs, vmin=self.vmin, vmax=self.vmax
        )

    def quantile(self, q: float) -> float:
        """Bucketed estimate of the q-quantile (0 when empty). Error is
        bounded by the width of the bucket the true quantile lands in."""
        with self._lock:
            return self._quantiles_locked((q,))[0]

    def summary(self) -> dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0.0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0,
                        **{_q_key(q): 0.0 for q in QUANTILES}}
            est = self._quantiles_locked(QUANTILES)
            return {
                "count": float(self.count),
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.vmin,
                "max": self.vmax,
                **{_q_key(q): v for q, v in zip(QUANTILES, est)},
            }


def _q_key(q: float) -> str:
    return "p" + format(q * 100, "g").replace(".", "_")  # 0.5 -> p50, 0.99 -> p99


def quantiles_from_counts(
    bounds: Sequence[float],
    counts: Sequence[int],
    qs: Sequence[float],
    *,
    vmin: float | None = None,
    vmax: float | None = None,
) -> list[float]:
    """Quantile estimates from per-bucket counts (len(bounds) + 1 slots, the
    last being overflow): walk the cumulative counts to the bucket that
    crosses each target rank and interpolate linearly inside it, clamped to
    the observed [vmin, vmax]. Shared by :class:`Histogram` and any consumer
    working from bucket-count DELTAS (scripts/serve_bench.py measures one
    round's quantiles as counts_after - counts_before through this exact
    function, so bench math and registry math cannot drift apart)."""
    total = sum(counts)
    if not total:
        return [0.0 for _ in qs]
    lo_clamp = 0.0 if vmin is None or vmin == float("inf") else vmin
    hi_clamp = bounds[-1] if vmax is None or vmax == float("-inf") else vmax
    out = []
    for q in qs:
        target = q * total
        cum = 0.0
        est = hi_clamp
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= target:
                lo = bounds[i - 1] if i > 0 else lo_clamp
                hi = bounds[i] if i < len(bounds) else hi_clamp
                lo = max(lo, lo_clamp)
                hi = min(max(hi, lo), hi_clamp)
                est = lo + (hi - lo) * (target - cum) / c
                break
            cum += c
        out.append(min(max(est, lo_clamp), hi_clamp))
    return out


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_family(name: str) -> tuple[str, str]:
    """(family, label-clause) for one registry name: a known labeled family
    folds its last segment into a label, everything else is label-less."""
    if "." in name:
        fam, suffix = name.rsplit(".", 1)
        label = PROM_LABEL_FAMILIES.get(fam)
        if label is not None:
            return _prom_name(fam), f'{label}="{suffix}"'
    return _prom_name(name), ""


def _fmt(v: float) -> str:
    return format(float(v), ".10g")


class MetricsRegistry:
    """Name -> typed metric, get-or-create semantics. Re-requesting a name
    with a different type is a programming error and fails loudly."""

    def __init__(self, default_buckets: Sequence[float] = DEFAULT_BUCKET_BOUNDS):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._default_buckets = tuple(default_buckets)
        self._build_info: dict[str, str] = {}
        self._lock = threading.Lock()

    def set_build_info(self, labels: dict) -> None:
        """Install the ``build_info`` exposition family (git sha, jax
        version, platform — obs/device.py ``build_info()``): a constant-1
        gauge whose LABELS carry the identity, the standard Prometheus
        version-attribution idiom, so a scraped fleet can group replicas by
        exactly what they run. Also served verbatim in ``/varz``."""
        with self._lock:
            self._build_info = {str(k): str(v) for k, v in labels.items()}

    @property
    def build_info(self) -> dict:
        return dict(self._build_info)

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {type(m).__name__}, "
                    f"requested as {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds: Sequence[float] | None = None) -> Histogram:
        """Get-or-create; ``bounds`` applies only at creation (an existing
        histogram keeps its ladder — bucket counts are not re-binnable)."""
        return self._get(name, Histogram, tuple(bounds) if bounds else self._default_buckets)

    def set_default_buckets(self, bounds: Sequence[float]) -> None:
        """Bucket ladder for histograms created AFTER this call (the
        ``obs.histogram_buckets`` config knob, applied at CLI startup before
        any serving histogram exists)."""
        if not bounds:
            return
        self._default_buckets = tuple(sorted(float(b) for b in bounds))  # yamt-lint: disable=YAMT019 — startup-ordered: applied at CLI boot before any serving histogram (or thread) exists

    def snapshot(self) -> dict[str, float]:
        """Flat {name: float} view of every metric; histograms expand to
        ``name.count/.sum/.mean/.min/.max/.p50/.p95/.p99``. Safe to call
        from any thread."""
        with self._lock:
            metrics = dict(self._metrics)
        out: dict[str, float] = {}
        for name in sorted(metrics):
            m = metrics[name]
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = float(m.value)
        return out

    def histograms_state(self) -> dict[str, dict]:
        """``{name: Histogram.state()}`` for every histogram — the /varz
        federation section a fleet scraper merges exactly (bucket ladders
        are fixed, so summing counts across replicas is lossless)."""
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.state() for name, m in sorted(metrics.items())
                if isinstance(m, Histogram)}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the whole registry
        — the body behind ``GET /metrics`` (serve/frontend.py). Histograms
        emit cumulative ``_bucket{le=...}``/``_sum``/``_count`` plus
        ``quantile=`` estimate samples; counters/gauges one sample each.
        Stdlib-only, no client library."""
        with self._lock:
            metrics = dict(self._metrics)
            binfo = dict(self._build_info)
        lines: list[str] = []
        typed: set[str] = set()
        if binfo:
            labels = ",".join(
                f'{_prom_name(k)}="{v}"' for k, v in sorted(binfo.items())
            )
            lines.append("# TYPE build_info gauge")
            lines.append(f"build_info{{{labels}}} 1")

        def _type_line(fam: str, kind: str) -> None:
            if fam not in typed:
                typed.add(fam)
                lines.append(f"# TYPE {fam} {kind}")

        for name in sorted(metrics):
            m = metrics[name]
            fam, label = _prom_family(name)
            if isinstance(m, Histogram):
                _type_line(fam, "histogram")
                s = m.summary()
                cum = 0
                for bound, c in zip(m.bounds, m.bucket_counts()):
                    cum += c
                    sep = "," if label else ""
                    lines.append(f'{fam}_bucket{{{label}{sep}le="{_fmt(bound)}"}} {cum}')
                sep = "," if label else ""
                lines.append(f'{fam}_bucket{{{label}{sep}le="+Inf"}} {int(s["count"])}')
                lines.append(f"{fam}_sum{{{label}}} {_fmt(s['sum'])}" if label
                             else f"{fam}_sum {_fmt(s['sum'])}")
                lines.append(f"{fam}_count{{{label}}} {int(s['count'])}" if label
                             else f"{fam}_count {int(s['count'])}")
                for q in QUANTILES:
                    lines.append(
                        f'{fam}{{{label}{sep}quantile="{format(q, "g")}"}} {_fmt(s[_q_key(q)])}'
                    )
            else:
                _type_line(fam, "counter" if isinstance(m, Counter) else "gauge")
                lines.append(f"{fam}{{{label}}} {_fmt(m.value)}" if label
                             else f"{fam} {_fmt(m.value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric (tests; never called by production code — the
        registry is process-lifetime by design)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every producer and consumer shares."""
    return _REGISTRY

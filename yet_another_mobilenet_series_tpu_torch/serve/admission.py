# Copy of yet_another_mobilenet_series_tpu/serve/admission.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Priority/QoS admission control + resilience edge in front of the batcher.

The batcher (serve/batcher.py, serve/pipeline.py) gives every request the
same FIFO treatment and fails a batch's futures the moment the engine throws.
Correct, but production traffic is not uniform and engines are not immortal:
interactive requests must not starve behind a best-effort flood, a transient
engine failure should cost a retry, not a user error, and a SICK engine must
stop eating every queued request. Per Kernel Looping (PAPERS.md,
arXiv:2410.23668) the device-feeding path must stay non-blocking, so ALL of
this logic lives at **admission time** (synchronous, before the queue) and
**completion time** (future callbacks) — never inside the dispatch loop.

:class:`AdmissionController` wraps a started batcher and adds three layers:

**1. Per-class weighted admission.** Three priority classes —
``interactive`` / ``batch`` / ``best_effort`` — each holding a weighted
share of the queue (``weights``): a class at its quota is rejected with
:class:`ClassQueueFull` while other classes still admit, so overload sheds
the cheap traffic first and a flood in one class can never starve another.
On top of quotas, **deadline-aware rejection at arrival**: an EWMA of
observed request latency predicts the wait a new request faces; a request
whose deadline the prediction already blows is rejected with
:class:`DeadlineUnmeetable` immediately — reject-on-arrival beats
shed-after-queue (the request never burns a queue slot or a bucket row).

**2. Bounded retry with jittered backoff.** The folded inference forward is
pure — a retry cannot double-apply anything — so a transient engine failure
(the only exception class that retries; deadline sheds and rejections do
not) re-submits up to ``max_retries`` times with exponentially growing,
jitter-desynchronized backoff, counted in ``serve.retries``. Retries stop
early when the request's own deadline passes or the breaker opens.

**3. Circuit breaker.** ``breaker_threshold`` CONSECUTIVE engine failures
open the breaker: every submit fails fast with :class:`BreakerOpen` (no
queue time, no engine load) for ``breaker_cooldown_s``, after which the
breaker goes half-open and admits exactly ONE probe request; the probe's
outcome closes the breaker (success) or re-opens it for another cooldown
(failure). State is exported as the ``serve.breaker_state`` gauge
(0 closed / 1 open / 2 half-open) and in :meth:`AdmissionController.state`
— the payload behind ``GET /healthz`` (serve/frontend.py).

Instrumentation (obs/): per-class ``serve.latency_seconds.<class>``
histograms and ``serve.requests.<class>`` / ``serve.completed.<class>`` /
``serve.rejected.<class>`` counters; cause-split ``serve.rejected_breaker``
/ ``serve.rejected_deadline`` / ``serve.rejected_class_full`` counters;
``serve.retries`` (+ per class), ``serve.engine_failures``,
``serve.breaker_opens``, and the ``serve.breaker_state`` gauge.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future, InvalidStateError

from ..obs.registry import get_registry
from .batcher import DeadlineExceeded, DrainTimeout, QueueFull
from .context import RequestContext

# the QoS taxonomy, cheapest-to-shed last; weights align with this order
CLASSES = ("interactive", "batch", "best_effort")

BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN = 0, 1, 2
_BREAKER_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open", BREAKER_HALF_OPEN: "half_open"}


class BreakerOpen(RuntimeError):
    """Rejected at arrival: the circuit breaker is open (engine failure
    streak); retry after the cooldown."""


class BrownoutShed(RuntimeError):
    """Rejected at arrival: the brownout ladder (serve/brownout.py) is
    shedding this priority class to protect interactive goodput under
    sustained overload. Maps to 503 with a ``Retry-After`` hint — the
    server is healthy, just saturated; come back, don't eject it.

    ``retry_after_s`` rides the exception so the frontend can emit the
    header and the router can tell backpressure from death."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineUnmeetable(RuntimeError):
    """Rejected at arrival: the predicted wait already exceeds the request's
    deadline — shedding now is strictly cheaper than shedding after queueing."""


class ClassQueueFull(QueueFull):
    """Rejected at arrival: this priority class is at its weighted queue
    share (other classes may still be admitting)."""


class UnknownModel(ValueError):
    """Rejected at arrival: the request's ``X-Model`` names a model this
    replica does not serve. Typed so the frontend answers 400 with the
    served-model list in the body (never a KeyError-shaped 500) and the
    client surfaces a typed :class:`~.client.ClientHTTPError` tag.
    ``served`` rides the exception for the error body."""

    def __init__(self, model: str, served):
        self.model = model
        self.served = tuple(served)
        super().__init__(
            f"unknown model {model!r}; served: {', '.join(self.served) or '(none)'}")


class ModelQueueFull(QueueFull):
    """Rejected at arrival: this model is at its configured in-system quota
    (serve.zoo.quotas) — other models may still be admitting, so a burst on
    one zoo tenant can never starve the others."""


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    Thread-safe; transitions are driven by :meth:`allow` (at admission) and
    :meth:`on_success` / :meth:`on_failure` (at completion).
    """

    def __init__(self, threshold: int, cooldown_s: float):
        if threshold < 1:
            raise ValueError(f"breaker_threshold must be >= 1, got {threshold}")
        self._threshold = threshold
        self._cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._streak = 0
        self._opened_at = 0.0
        self._probe_pending = False
        self._reg = get_registry()
        self._reg.gauge("serve.breaker_state").set(BREAKER_CLOSED)

    def _set_state(self, state: int) -> None:
        self._state = state
        self._reg.gauge("serve.breaker_state").set(state)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return _BREAKER_NAMES[self.state]

    def allow(self) -> tuple[bool, bool]:
        """(admit?, is_probe?) for one arriving request."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True, False
            if self._state == BREAKER_OPEN:
                if time.perf_counter() - self._opened_at < self._cooldown_s:
                    return False, False
                self._set_state(BREAKER_HALF_OPEN)
                self._probe_pending = True
                return True, True  # the cooldown's first arrival IS the probe
            # half-open: one probe outstanding at a time
            if self._probe_pending:
                return False, False
            self._probe_pending = True
            return True, True

    def cancel_probe(self) -> None:
        """The admitted probe was rejected downstream before reaching the
        engine: free the probe slot for the next arrival."""
        with self._lock:
            self._probe_pending = False

    def on_success(self, probe: bool) -> None:
        with self._lock:
            self._streak = 0
            if probe:
                self._probe_pending = False
                self._set_state(BREAKER_CLOSED)

    def on_failure(self, probe: bool) -> None:
        with self._lock:
            if probe:
                self._probe_pending = False
                self._open()
                return
            if self._state != BREAKER_CLOSED:
                return  # failures of pre-open stragglers don't re-arm the clock
            self._streak += 1
            if self._streak >= self._threshold:
                self._open()

    def _open(self) -> None:
        self._streak = 0
        self._opened_at = time.perf_counter()
        if self._state != BREAKER_OPEN:
            self._set_state(BREAKER_OPEN)
            self._reg.counter("serve.breaker_opens").inc()


class _Pending:
    """Admission-side bookkeeping for one in-system request (survives
    retries — the class quota slot is held until final resolution)."""

    __slots__ = ("cls", "image", "t_submit", "t_deadline", "retries_left", "probe", "attempt", "ctx",
                 "model")

    def __init__(self, cls, image, deadline_s, retries_left, probe, ctx, model=None):
        self.cls = cls
        self.image = image
        self.t_submit = time.perf_counter()
        self.t_deadline = None if deadline_s is None else self.t_submit + deadline_s
        self.retries_left = retries_left
        self.probe = probe
        self.attempt = 0
        self.ctx = ctx
        self.model = model


class AdmissionController:
    """QoS admission + retry + breaker around a started batcher.

    ``submit`` mirrors the batcher's API (image, deadline) plus ``priority``
    and returns a Future that ALWAYS resolves: to logits, or to a typed
    rejection/shed/failure — never a silent hang.
    """

    def __init__(
        self,
        batcher,
        *,
        weights=(8.0, 3.0, 1.0),
        default_class: str = "interactive",
        max_retries: int = 2,
        retry_backoff_ms: float = 5.0,
        retry_jitter: float = 0.5,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 1.0,
        ewma_alpha: float = 0.2,
        reject_unmeetable: bool = True,
        predictor: str = "ewma",
        predictor_quantile: float = 0.9,
        seed: int = 0,
        heartbeat=None,
        models=None,
        default_model: str | None = None,
        model_quotas=None,
    ):
        if predictor not in ("ewma", "quantile"):
            raise ValueError(f"predictor must be 'ewma' or 'quantile', got {predictor!r}")
        if len(weights) != len(CLASSES):
            raise ValueError(f"need one weight per class {CLASSES}, got {weights}")
        if default_class not in CLASSES:
            raise ValueError(f"default_class {default_class!r} not in {CLASSES}")
        self._batcher = batcher
        self._default_class = default_class
        self._max_retries = max(0, int(max_retries))
        self._backoff_s = retry_backoff_ms / 1e3
        self._jitter = retry_jitter
        self._alpha = ewma_alpha
        self._reject_unmeetable = reject_unmeetable
        self._predictor = predictor
        self._predictor_q = float(predictor_quantile)
        self._heartbeat = heartbeat  # e.g. StallWatchdog.arm — beats per completion
        self._rng = random.Random(seed)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown_s)
        depth = batcher._q.maxsize or 256
        total_w = float(sum(weights))
        self._quota = {
            cls: max(1, int(round(depth * w / total_w))) for cls, w in zip(CLASSES, weights)
        }
        self._weights = dict(zip(CLASSES, weights))
        self._lock = threading.Lock()
        self._in_queue = {cls: 0 for cls in CLASSES}
        self._ewma_s: float | None = None
        # brownout policy pushed by serve/brownout.py (all neutral at L0):
        # classes rejected at the door, a multiplier tightening the
        # deadline-admission margin, and whether transient-failure retries
        # still run (L5 survival mode spends no capacity on second chances)
        self._shed_classes: frozenset[str] = frozenset()
        self._deadline_margin = 1.0
        self._retries_enabled = True
        self._brownout_level = 0
        self._brownout_retry_after_s = 1.0
        # rid -> RequestContext for every request currently in the system:
        # the hang report's "whose request is wedged" section reads this
        self._inflight_ctx: dict[int, RequestContext] = {}
        # zoo tenancy (serve/zoo.py): the served-model set (None = legacy
        # single-model process, X-Model left unvalidated here), the name
        # unqualified requests resolve to, and optional per-model in-system
        # quotas so a burst on one tenant can never starve the others
        self._models: tuple[str, ...] | None = tuple(models) if models else None
        if default_model is not None and self._models is not None and default_model not in self._models:
            raise ValueError(f"default_model {default_model!r} not in served set {self._models}")
        self._default_model = default_model or (self._models[0] if self._models else None)
        self._model_quota = {k: int(v) for k, v in dict(model_quotas or {}).items()}
        self._in_model: dict[str, int] = {}
        self._reg = get_registry()

    # -- the arrival-time wait predictor ------------------------------------

    def _observe(self, cls: str, latency_s: float) -> None:
        self._reg.histogram(f"serve.latency_seconds.{cls}").observe(latency_s)
        with self._lock:
            self._ewma_s = (
                latency_s if self._ewma_s is None
                else self._alpha * latency_s + (1 - self._alpha) * self._ewma_s
            )

    def predicted_wait_s(self, cls: str | None = None) -> float:
        """Expected time-to-answer for a request admitted NOW: a per-request
        latency estimate scaled by the backlog in units of engine batches.
        0 until the first completion lands (no data — admit optimistically).

        Two estimators (``predictor`` config): ``ewma`` (the original
        smoothed mean — tracks the center, blind to the tail) and
        ``quantile`` (the ``predictor_quantile`` of the class's bucketed
        ``serve.latency_seconds.<class>`` histogram — a p90-based predictor
        sheds on TAIL latency, which is what deadlines are actually about;
        FLASH/LANA: decide on measured latency, not a proxy). The quantile
        mode falls back to the EWMA until the class histogram has data."""
        with self._lock:
            ewma = self._ewma_s
            backlog = sum(self._in_queue.values())
        per_request = ewma
        if self._predictor == "quantile":
            hist = self._reg.histogram(f"serve.latency_seconds.{cls or self._default_class}")
            if hist.count:
                per_request = hist.quantile(self._predictor_q)
        if per_request is None:
            return 0.0
        per_batch = max(getattr(self._batcher, "_max_batch", 1), 1)
        # the brownout deadline margin (> 1 at L4+) inflates the estimate,
        # so deadline-carrying requests shed EARLIER under overload — the
        # predictor lags a storm by design (it only learns from completions)
        with self._lock:
            margin = self._deadline_margin
        return per_request * (1.0 + backlog / per_batch) * margin

    # -- brownout actuation (serve/brownout.py pushes, never reads) ----------

    def apply_brownout(self, policy) -> None:
        """Install one :class:`~.brownout.BrownoutPolicy` atomically: the
        classes to reject at the door, the deadline-margin multiplier, and
        the retry switch. Called from the controller thread on every ladder
        transition; in-flight requests keep the policy they admitted under."""
        with self._lock:
            self._shed_classes = frozenset(policy.shed_classes)
            self._deadline_margin = float(policy.deadline_margin)
            self._retries_enabled = bool(policy.retries)
            self._brownout_level = int(policy.level)
            self._brownout_retry_after_s = float(policy.retry_after_s)

    def queued_total(self) -> float:
        """Total admitted-and-unresolved requests across classes — the
        replica-tier backlog signal (serve/signals.py queue_depth_fn)."""
        with self._lock:
            return float(sum(self._in_queue.values()))

    # -- client side --------------------------------------------------------

    def submit(
        self,
        image,
        *,
        priority: str | None = None,
        deadline_ms: float | None = None,
        ctx: RequestContext | None = None,
        model: str | None = None,
    ) -> Future:
        cls = priority or self._default_class
        if cls not in CLASSES:
            raise ValueError(f"unknown priority class {cls!r}; valid: {CLASSES}")
        # model resolution + validation FIRST: a client naming an unserved
        # model is a 400-class error regardless of brownout/breaker state —
        # reject before any policy machinery can spend a probe or a slot
        model = model or (ctx.model if ctx is not None else None) or self._default_model
        if self._models is not None and model is not None and model not in self._models:
            self._reject(cls, "serve.rejected_unknown_model")
            raise UnknownModel(model, self._models)
        if ctx is None:  # direct callers get an id too; the frontend mints its own
            ctx = RequestContext.mint(cls, deadline_ms, model=model)
        elif ctx.model is None:
            ctx.model = model
        # brownout class shed FIRST (before the breaker can spend a probe
        # slot): the cheapest possible rejection — no quota, no queue, no
        # engine load, and a Retry-After so well-behaved clients back off
        with self._lock:
            shed_classes = self._shed_classes
            level = self._brownout_level
            retry_after_s = self._brownout_retry_after_s
        if cls in shed_classes:
            self._reject(cls, "serve.rejected_brownout")
            raise BrownoutShed(
                f"class {cls!r} shed at brownout level L{level}; "
                f"retry after {retry_after_s:.1f}s",
                retry_after_s=retry_after_s,
            )
        admit, probe = self.breaker.allow()
        if not admit:
            self._reject(cls, "serve.rejected_breaker")
            raise BreakerOpen(
                f"circuit breaker open (cooldown {self.breaker._cooldown_s:.1f}s); failing fast"
            )
        deadline_s = deadline_ms / 1e3 if deadline_ms is not None else None
        if self._reject_unmeetable and deadline_s is not None:
            wait = self.predicted_wait_s(cls)
            if wait > deadline_s:
                if probe:
                    self.breaker.cancel_probe()  # probe slot not consumed
                self._reject(cls, "serve.rejected_deadline")
                raise DeadlineUnmeetable(
                    f"predicted wait {wait * 1e3:.1f}ms exceeds deadline {deadline_ms:.1f}ms"
                )
        model_cap = self._model_quota.get(model) if model is not None else None
        with self._lock:
            if self._in_queue[cls] >= self._quota[cls]:
                over_quota = "class"
            elif model_cap is not None and self._in_model.get(model, 0) >= model_cap:
                over_quota = "model"
            else:
                over_quota = None
                self._in_queue[cls] += 1
                if model is not None:
                    self._in_model[model] = self._in_model.get(model, 0) + 1
        if over_quota is not None:
            if probe:
                self.breaker.cancel_probe()
            if over_quota == "class":
                self._reject(cls, "serve.rejected_class_full")
                raise ClassQueueFull(
                    f"class {cls!r} at its weighted queue share ({self._quota[cls]})"
                )
            self._reject(cls, "serve.rejected_model_full")
            raise ModelQueueFull(
                f"model {model!r} at its in-system quota ({model_cap})"
            )
        pending = _Pending(cls, image, deadline_s, self._max_retries, probe, ctx, model=model)
        outer: Future = Future()
        try:
            inner = self._batcher.submit(
                image, deadline_ms=deadline_ms, priority=cls, ctx=ctx, model=model
            )
        except Exception:
            self._release(cls, model)
            if probe:
                self.breaker.cancel_probe()
            self._reject(cls, None)  # rejected_full already counted by the batcher
            raise
        self._reg.counter(f"serve.requests.{cls}").inc()
        if model is not None:
            self._reg.counter(f"serve.model_requests.{model}").inc()
        ctx.open_envelope()
        with self._lock:
            self._inflight_ctx[ctx.rid] = ctx
        inner.add_done_callback(lambda fut: self._on_done(pending, outer, fut))
        return outer

    def _reject(self, cls: str, cause_counter: str | None) -> None:
        self._reg.counter("serve.rejected").inc()
        self._reg.counter(f"serve.rejected.{cls}").inc()
        if cause_counter:
            self._reg.counter(cause_counter).inc()

    def _release(self, cls: str, model: str | None = None) -> None:
        with self._lock:
            self._in_queue[cls] = max(0, self._in_queue[cls] - 1)
            if model is not None and model in self._in_model:
                self._in_model[model] = max(0, self._in_model[model] - 1)

    # -- completion side (runs on batcher worker / timer threads) -----------

    def _resolve(self, pending: _Pending, outer: Future, value=None, exc: Exception | None = None) -> None:
        with self._lock:
            self._inflight_ctx.pop(pending.ctx.rid, None)
        pending.ctx.close_envelope()
        try:
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(value)
        except InvalidStateError:
            pass  # client cancelled; nothing left to deliver
        if self._heartbeat is not None:
            self._heartbeat()

    def _on_done(self, pending: _Pending, outer: Future, inner: Future) -> None:
        exc = inner.exception()
        if exc is None:
            self.breaker.on_success(pending.probe)
            latency_s = time.perf_counter() - pending.t_submit
            self._observe(pending.cls, latency_s)
            self._reg.counter(f"serve.completed.{pending.cls}").inc()
            if pending.model is not None:
                self._reg.histogram(
                    f"serve.model_latency_seconds.{pending.model}").observe(latency_s)
                self._reg.counter(f"serve.model_completed.{pending.model}").inc()
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, value=inner.result())
            return
        if isinstance(exc, (DeadlineExceeded, DrainTimeout)):
            # sheds are policy, not engine health: no breaker, no retry
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, exc=exc)
            return
        # engine failure: breaker accounting, then bounded retry
        self._reg.counter("serve.engine_failures").inc()
        self.breaker.on_failure(pending.probe)
        pending.probe = False  # the probe verdict is spent; a retry is ordinary traffic
        with self._lock:
            retries_enabled = self._retries_enabled
        if pending.retries_left <= 0 or not retries_enabled or self.breaker.state == BREAKER_OPEN or (
            pending.t_deadline is not None and time.perf_counter() >= pending.t_deadline
        ):
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, exc=exc)
            return
        pending.retries_left -= 1
        pending.attempt += 1
        delay = self._backoff_s * (2 ** (pending.attempt - 1))
        delay *= 1.0 + self._jitter * self._rng.uniform(-1.0, 1.0)
        self._reg.counter("serve.retries").inc()
        self._reg.counter(f"serve.retries.{pending.cls}").inc()
        pending.ctx.phase = "retrying"  # re-enters "queued" on the retry submit
        timer = threading.Timer(max(delay, 0.0), self._retry, args=(pending, outer, exc))
        timer.daemon = True
        timer.start()

    def _retry(self, pending: _Pending, outer: Future, prev_exc: Exception) -> None:
        if pending.t_deadline is not None and time.perf_counter() >= pending.t_deadline:
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, exc=DeadlineExceeded("deadline passed during retry backoff"))
            return
        if self.breaker.state == BREAKER_OPEN:
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, exc=prev_exc)
            return
        remaining_ms = (
            None if pending.t_deadline is None
            else max((pending.t_deadline - time.perf_counter()) * 1e3, 0.0)
        )
        try:
            inner = self._batcher.submit(
                pending.image, deadline_ms=remaining_ms, priority=pending.cls,
                ctx=pending.ctx, model=pending.model,
            )
        except Exception as e:  # noqa: BLE001 — stopped batcher / QueueFull: final answer
            self._release(pending.cls, pending.model)
            self._resolve(pending, outer, exc=e)
            return
        inner.add_done_callback(lambda fut: self._on_done(pending, outer, fut))

    # -- introspection (healthz / hang reports) ------------------------------

    def oldest_inflight(self) -> dict | None:
        """The oldest in-system request's {id, class, deadline_ms, age_s,
        phase} — the "whose request is wedged" line in hang reports and
        /varz. None when the system is idle."""
        with self._lock:
            if not self._inflight_ctx:
                return None
            oldest = min(self._inflight_ctx.values(), key=lambda c: c.t_arrival)
        return oldest.as_dict()

    def state(self) -> dict:
        """JSON-safe snapshot: breaker, per-class occupancy/quota, predictor."""
        with self._lock:
            in_queue = dict(self._in_queue)
            in_model = dict(self._in_model)
            ewma = self._ewma_s
            brownout = {
                "level": self._brownout_level,
                "shed_classes": sorted(self._shed_classes),
                "deadline_margin": self._deadline_margin,
                "retries_enabled": self._retries_enabled,
            }
        return {
            "breaker": self.breaker.state_name,
            "breaker_state": self.breaker.state,
            "brownout": brownout,
            "ewma_latency_s": ewma,
            "predictor": self._predictor,
            "predicted_wait_s": self.predicted_wait_s(),
            "oldest_request": self.oldest_inflight(),
            "queued_total": sum(in_queue.values()),
            "classes": {
                cls: {
                    "in_queue": in_queue[cls],
                    "quota": self._quota[cls],
                    "weight": self._weights[cls],
                }
                for cls in CLASSES
            },
            "models": None if self._models is None else {
                m: {
                    "in_system": in_model.get(m, 0),
                    "quota": self._model_quota.get(m),
                    "default": m == self._default_model,
                }
                for m in self._models
            },
        }

    @classmethod
    def from_config(cls, batcher, ac, *, heartbeat=None, seed: int = 0,
                    models=None, default_model: str | None = None,
                    model_quotas=None) -> "AdmissionController":
        """Build from a config.AdmissionConfig block (cli/serve.py); the zoo
        kwargs ride alongside from the serve.zoo block (serve/zoo.py)."""
        return cls(
            batcher,
            weights=tuple(ac.weights),
            default_class=ac.default_class,
            max_retries=ac.max_retries,
            retry_backoff_ms=ac.retry_backoff_ms,
            retry_jitter=ac.retry_jitter,
            breaker_threshold=ac.breaker_threshold,
            breaker_cooldown_s=ac.breaker_cooldown_s,
            ewma_alpha=ac.ewma_alpha,
            reject_unmeetable=ac.reject_unmeetable,
            predictor=ac.predictor,
            predictor_quantile=ac.predictor_quantile,
            seed=seed,
            heartbeat=heartbeat,
            models=models,
            default_model=default_model,
            model_quotas=model_quotas,
        )

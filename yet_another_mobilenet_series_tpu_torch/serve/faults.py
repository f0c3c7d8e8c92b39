# Copy of yet_another_mobilenet_series_tpu/serve/faults.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Deterministic, seeded fault injection around the inference engine.

Every recovery path in the resilience edge — bounded retry, circuit breaker,
completion-time shedding, drain timeout, watchdog hang reports — is dead
code until something actually fails, and "unplug the TPU" is not a unit
test. (The WIRE-level twin of this module is serve/netchaos.py: where
FaultyEngine injects at the engine edge inside one process, the netchaos
proxy injects between processes — blackholes, resets, half-open sockets —
the failure class only a multi-host fleet ever sees.) :class:`FaultyEngine` wraps anything speaking the engine protocol
(``predict_async(images) -> handle``, ``handle.result()``, ``predict``) and
injects failures on a SEEDED schedule, so every chaos scenario in
tests/test_fault_injection.py and the serve_bench chaos A/B is exactly
reproducible:

- **failure rate** — ``failure_rate`` is PER REQUEST ROW: a dispatch of
  ``n`` rows fails with probability ``1 - (1 - rate)**n`` (one
  ``random.Random(seed)`` draw per dispatch, deterministic in dispatch
  order — the batcher's collect thread serializes dispatches). Per-row
  compounding keeps a "5% fault rate" meaning 5% of REQUESTS affected
  regardless of how the batcher coalesces them — a flat per-dispatch rate
  would make heavy coalescing silently hide the chaos;
- **fail-N-then-recover** — the first ``fail_first_n`` dispatches fail, the
  rest succeed: the breaker drill (streak opens it, the half-open probe
  lands after recovery and closes it);
- **added latency** — ``latency_s`` of sleep with per-row probability
  ``latency_rate`` (compounded like failures), applied inside ``result()``
  (the completion thread's sync), never at dispatch — the device-feeding
  path stays non-blocking exactly as in a real slow-device episode (Kernel
  Looping discipline). ``latency_after_n`` delays the onset: the first N
  dispatches run clean, then the injection begins — a replica that
  DEGRADES mid-run (the gray-failure drill: the router must notice a
  replica that was healthy when it learned its baseline);
- **hang-until-event** — dispatch index ``hang_at`` blocks its ``result()``
  on :attr:`hang_release` indefinitely: the drain-timeout / stall-watchdog
  drill. Setting the event un-wedges the handle, which then serves the
  batch for real (recovery, not just release).

``fail_at`` picks where failures surface: ``"dispatch"`` raises out of
``predict_async`` (collect thread), ``"result"`` returns a handle that
raises at sync (completion thread) — the two failure edges the pipelined
batcher must contain independently.

Injected events are counted (``serve.faults.failures`` / ``.delays`` /
``.hangs``) so a chaos round's accounting is auditable from the same obs
registry snapshot as the recovery metrics it provoked. Attribute access
falls through to the wrapped engine (``buckets``, ``image_sizes``, ...), so
the wrapper is drop-in anywhere an engine goes.
"""

from __future__ import annotations

import inspect
import random
import threading
import time

from ..obs.registry import get_registry


class InjectedFault(RuntimeError):
    """A deterministic injected engine failure (serve/faults.py) — the
    'transient engine error' every recovery path trains against."""


class _FaultyHandle:
    """Wraps (or replaces) a pending handle: applies the injected delay /
    failure / hang at ``result()`` time, on the completion thread."""

    __slots__ = ("_fe", "_images", "_inner", "_delay_s", "_fail", "_hang", "_model_kw")

    def __init__(self, fe, images, inner, delay_s, fail, hang, model_kw=None):
        self._fe = fe
        self._images = images
        self._inner = inner
        self._delay_s = delay_s
        self._fail = fail
        self._hang = hang
        self._model_kw = model_kw or {}

    def result(self):
        if self._hang:
            # a real wedge: blocks until the operator (test) releases it,
            # then serves the batch for real — hang, then recovery
            self._fe.hang_release.wait()
            return self._fe._engine.predict(self._images, **self._model_kw)
        if self._delay_s > 0:
            time.sleep(self._delay_s)
        if self._fail:
            raise InjectedFault(f"injected result failure (dispatch #{self._fail - 1})")
        return self._inner.result()


class FaultyEngine:
    """Engine-protocol wrapper with a seeded fault schedule. See module
    docstring for the knobs; ``hang_release`` is the un-wedge event."""

    def __init__(
        self,
        engine,
        *,
        seed: int = 0,
        failure_rate: float = 0.0,
        fail_first_n: int = 0,
        fail_at: str = "dispatch",
        latency_s: float = 0.0,
        latency_rate: float = 1.0,
        latency_after_n: int = 0,
        hang_at: int | None = None,
    ):
        if fail_at not in ("dispatch", "result"):
            raise ValueError(f"fail_at must be 'dispatch' or 'result', got {fail_at!r}")
        self._engine = engine
        self._failure_rate = failure_rate
        self._fail_first_n = fail_first_n
        self._fail_at = fail_at
        self._latency_s = latency_s
        self._latency_rate = latency_rate
        self._latency_after_n = max(0, int(latency_after_n))
        self._hang_at = hang_at
        self.hang_release = threading.Event()
        self._rng = random.Random(seed)
        self._idx = 0
        self._lock = threading.Lock()
        self._reg = get_registry()
        # forward request contexts (serve/context.py) only when the wrapped
        # engine speaks the extension — test doubles with predict_async(images)
        # stay drop-in
        try:
            self._takes_ctxs = "ctxs" in inspect.signature(engine.predict_async).parameters
        except (TypeError, ValueError):
            self._takes_ctxs = False
        # F3 (ROADMAP queue 3): a zoo engine's model= goes through, so each
        # request reaches the tenant it named and not the default one
        try:
            self._takes_model = "model" in inspect.signature(engine.predict_async).parameters
        except (TypeError, ValueError):
            self._takes_model = False

    def _decide(self, n_rows: int) -> tuple[int, bool, float, bool]:
        """(dispatch index, fail?, delay_s, hang?) — one locked draw pair per
        dispatch so the schedule is deterministic in dispatch order. Rates
        compound per row: p_dispatch = 1 - (1 - rate)**n_rows."""
        with self._lock:
            idx = self._idx
            self._idx += 1
            fail = idx < self._fail_first_n or (
                self._failure_rate > 0
                and self._rng.random() < 1.0 - (1.0 - self._failure_rate) ** n_rows
            )
            delay = (
                self._latency_s
                if self._latency_s > 0
                and idx >= self._latency_after_n  # degrade-onset gate
                and self._rng.random() < 1.0 - (1.0 - self._latency_rate) ** n_rows
                else 0.0
            )
            hang = self._hang_at is not None and idx == self._hang_at
        return idx, fail, delay, hang

    def predict_async(self, images, ctxs=None, model=None):
        idx, fail, delay, hang = self._decide(int(images.shape[0]))
        model_kw = {"model": model} if self._takes_model else {}
        if hang:
            self._reg.counter("serve.faults.hangs").inc()
            return _FaultyHandle(self, images, None, 0.0, 0, hang=True, model_kw=model_kw)
        if fail:
            self._reg.counter("serve.faults.failures").inc()
            if self._fail_at == "dispatch":
                raise InjectedFault(f"injected dispatch failure (dispatch #{idx})")
            return _FaultyHandle(self, images, None, delay, idx + 1, hang=False)
        if delay > 0:
            self._reg.counter("serve.faults.delays").inc()
        if self._takes_ctxs:
            inner = self._engine.predict_async(images, ctxs=ctxs, **model_kw)
        else:
            inner = self._engine.predict_async(images, **model_kw)
        return _FaultyHandle(self, images, inner, delay, 0, hang=False)

    def predict(self, images, ctxs=None, model=None):
        return self.predict_async(images, ctxs=ctxs, model=model).result()

    def __getattr__(self, name):
        # everything not fault-related (buckets, warmup, image_sizes, ...)
        # falls through so the wrapper is drop-in
        return getattr(self._engine, name)

    @classmethod
    def from_config(cls, engine, fc, **overrides):
        """Wrap per a config.FaultsConfig block; identity when disabled."""
        if not fc.enable:
            return engine
        kw = dict(
            seed=fc.seed,
            failure_rate=fc.failure_rate,
            fail_first_n=fc.fail_first_n,
            fail_at=fc.fail_at,
            latency_s=fc.latency_ms / 1e3,
            latency_rate=fc.latency_rate,
            latency_after_n=fc.latency_after_n,
            hang_at=fc.hang_at if fc.hang_at >= 0 else None,
        )
        kw.update(overrides)
        return cls(engine, **kw)

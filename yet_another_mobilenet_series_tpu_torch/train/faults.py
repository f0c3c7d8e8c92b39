# Copy of yet_another_mobilenet_series_tpu/train/faults.py: the port keeps its own copy so that it never imports the
# JAX package. Its batches are tensors on the device, so the NaN is written into a clone of the image tensor.
"""Deterministic, seeded fault injection for the TRAIN data stream — the
training twin of serve/faults.py.

Every training-side recovery path added by the robustness PR — corrupt-record
skip + counting (data/pipeline.py resilient_batches), the non-finite step
rollback (train/guard.py), the loader-stall watchdog drill, and the SIGTERM
preemption checkpoint (cli/train.py) — is dead code until something actually
fails, and "yank the power" is not a unit test. :class:`FaultyTrainSource`
wraps the raw batch iterator (data/__init__.py's ``inject`` hook, UNDER the
resilience layers, so injected faults travel the exact path real ones take)
and injects on a seeded, batch-indexed schedule:

- **corrupt records** — each pull raises
  :class:`~..data.pipeline.CorruptRecordError` with probability
  ``corrupt_record_rate`` (one ``random.Random(seed)`` draw per pull,
  deterministic in pull order) — the resilience wrapper must skip and count
  it; a rate of 1.0 drills the bounded consecutive-failure abort;
- **step-NaN** — the batch served for a global step in ``nan_at_steps`` gets
  its first image poisoned with NaN, so the compiled step's loss goes
  non-finite and the guard's rollback path runs for real;
- **loader stall** — the pull for ``stall_at_step`` sleeps ``stall_ms``
  (stall-watchdog drill: a fat ``data/next`` span and, past the deadline, a
  hang report);
- **kill-at-step** — after serving ``kill_at_step``'s batch the injector
  sends THIS process a real ``SIGTERM`` (the preemption drill: the handler
  must checkpoint synchronously and exit 0 with a resume marker).

Step indexing is GLOBAL (``start_step`` offsets a resumed stream), matching
the train loop's host step counter — but note the loop prefetches
(``data.device_prefetch`` + the optional prefetch thread), so a pull-indexed
event fires up to that many steps before the loop processes the batch.
Injected events are counted (``train.faults.*``) so a chaos round's books
are auditable from the same registry snapshot as the recovery counters it
provoked.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Iterator

from ..data.pipeline import CorruptRecordError
from ..obs.registry import get_registry


class FaultyTrainSource:
    """Iterator wrapper with a seeded train-side fault schedule; see module
    docstring for the knobs. Built from a config.TrainFaultsConfig via
    :meth:`from_config` (identity when disabled)."""

    def __init__(
        self,
        it: Iterator[dict],
        *,
        seed: int = 0,
        corrupt_record_rate: float = 0.0,
        nan_at_steps=(),
        stall_at_step: int = -1,
        stall_ms: float = 0.0,
        kill_at_step: int = -1,
        start_step: int = 0,
    ):
        self._it = iter(it)
        self._rng = random.Random(seed)
        self._corrupt_rate = float(corrupt_record_rate)
        self._nan_at = {int(s) for s in nan_at_steps}
        self._stall_at = int(stall_at_step)
        self._stall_s = float(stall_ms) / 1e3
        self._kill_at = int(kill_at_step)
        self._step = int(start_step)  # next global step to be served
        self._reg = get_registry()

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        # one seeded draw per PULL (not per served batch): a skipped corrupt
        # pull consumes schedule position, deterministic in pull order
        if self._corrupt_rate > 0 and self._rng.random() < self._corrupt_rate:
            self._reg.counter("train.faults.corrupt_records").inc()
            raise CorruptRecordError("injected corrupt record (train.faults)")
        step = self._step
        if step == self._stall_at and self._stall_s > 0:
            self._reg.counter("train.faults.stalls").inc()
            time.sleep(self._stall_s)
        batch = next(self._it)
        if step in self._nan_at:
            self._reg.counter("train.faults.nan_steps").inc()
            image = batch["image"].clone()
            image[0] = float("nan")
            batch = dict(batch, image=image)
        self._step = step + 1
        if step == self._kill_at:
            self._reg.counter("train.faults.kills").inc()
            os.kill(os.getpid(), signal.SIGTERM)
        return batch

    @classmethod
    def from_config(cls, it, fc, start_step: int = 0):
        """Wrap per a config.TrainFaultsConfig block; identity when disabled."""
        if not fc.enable:
            return it
        return cls(
            it,
            seed=fc.seed,
            corrupt_record_rate=fc.corrupt_record_rate,
            nan_at_steps=fc.nan_at_steps,
            stall_at_step=fc.stall_at_step,
            stall_ms=fc.stall_ms,
            kill_at_step=fc.kill_at_step,
            start_step=start_step,
        )

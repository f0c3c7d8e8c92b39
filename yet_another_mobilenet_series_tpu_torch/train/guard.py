"""Step health guard: the torch twin of ``yet_another_mobilenet_series_tpu/train/guard.py``.

A non-finite step is rejected on the device (:func:`wrap_step_fn`): every
TrainState field except ``step`` is selected back to its pre-step value by
``torch.where`` on the step's own finiteness verdict, so the host never
waits on it. The step counter still advances, so the LR schedule and the
host's step count stay aligned: the bad batch is consumed and skipped.

The host half (:class:`StepGuard`) reads the verdicts once per
``train.log_every`` boundary, where the metrics are read anyway, counts
them (``train.skipped_steps`` / ``train.nonfinite_events``) and aborts with
:class:`TrainHealthError` after ``train.guard.max_skipped_steps`` skips,
writing ``train_health.json``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import torch

from ..models.convert import flatten_tree, unflatten_tree
from ..obs.registry import get_registry

HEALTH_REPORT_NAME = "train_health.json"

# the TrainState fields the rollback selects (everything but the step)
_ROLLED = ("params", "state", "opt_state", "ema_params", "ema_state", "masks", "rho_mult")


class TrainHealthError(RuntimeError):
    """More non-finite steps than train.guard.max_skipped_steps tolerates."""


def select(ok: torch.Tensor, new: list[torch.Tensor], old: list[torch.Tensor]) -> list[torch.Tensor]:
    """``where(ok, new_i, old_i)`` for every pair of the lists, as one
    ``torch.where`` per dtype over the leaves laid end to end (a handful of
    launches for any number of tensors). The results are views of that
    buffer, shaped like ``new``."""
    out: list = [None] * len(new)
    groups: dict = defaultdict(list)
    for i, t in enumerate(new):
        groups[t.dtype].append(i)
    for idx in groups.values():
        a = torch.cat([new[i].reshape(-1) for i in idx])
        b = torch.cat([old[i].reshape(-1).to(a.dtype) for i in idx])
        chosen = torch.where(ok, a, b)
        for i, piece in zip(idx, chosen.split([new[i].numel() for i in idx])):
            out[i] = piece.view(new[i].shape)
    return out


def _leaves(value) -> dict:
    if value is None:
        return {}
    if isinstance(value, torch.Tensor):
        return {"": value}
    return flatten_tree(value)


def wrap_step_fn(step_fn):
    """Wraps a (ts, batch, generator) -> (ts, metrics) step with the
    device-side skip: when the loss or the grad norm is non-finite, every
    field but ``step`` keeps its pre-step value. Adds the ``skipped`` metric
    (1.0 = this step was rejected), a 0-dim device tensor."""

    def guarded(ts, batch, generator):
        new_ts, metrics = step_fn(ts, batch, generator)
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
        keys, new, old = [], [], []
        for field in _ROLLED:
            fresh, prior = _leaves(getattr(new_ts, field)), _leaves(getattr(ts, field))
            for k, v in fresh.items():
                keys.append((field, k))
                new.append(v)
                old.append(prior[k])
        chosen = dict(zip(keys, select(ok, new, old)))
        changes = {}
        for field in _ROLLED:
            value = getattr(new_ts, field)
            if isinstance(value, torch.Tensor):
                changes[field] = chosen[(field, "")]
            elif value:
                changes[field] = unflatten_tree({k: chosen[(field, k)] for k in flatten_tree(value)})
        metrics = dict(metrics, skipped=1.0 - ok.float())
        return new_ts.replace(**changes), metrics

    return guarded


class StepGuard:
    """Host-side accounting for the guarded step: ``observe`` stashes the
    per-step ``skipped`` tensors (nothing syncs); ``check`` reads them at the
    log cadence and enforces the skip bound."""

    def __init__(self, gc, log_dir: str | None, logger=None):
        self.max_skipped = int(gc.max_skipped_steps)
        self._log_dir = log_dir
        self._logger = logger
        self._pending: list[tuple[int, object]] = []
        self.skipped_total = 0
        self.skipped_steps: list[int] = []  # recent skip step indices (bounded)

    def observe(self, step_i: int, metrics: dict) -> None:
        self._pending.append((step_i, metrics.get("skipped")))

    def check(self, step_i: int) -> None:
        """Called at the log boundary (and once at loop exit). Raises
        TrainHealthError, after writing train_health.json, when the total
        skip count exceeds the bound."""
        pending, self._pending = [(s, v) for s, v in self._pending if v is not None], []
        # one read of the window's verdicts, stacked on their device
        verdicts = torch.stack([torch.as_tensor(v, dtype=torch.float32) for _, v in pending]).tolist() \
            if pending else []
        bad = [s for (s, _), v in zip(pending, verdicts) if v > 0.0]
        if bad:
            reg = get_registry()
            reg.counter("train.skipped_steps").inc(len(bad))
            reg.counter("train.nonfinite_events").inc()
            self.skipped_total += len(bad)
            self.skipped_steps = (self.skipped_steps + bad)[-64:]
            if self._logger is not None:
                self._logger.log(
                    f"step guard: {len(bad)} non-finite step(s) skipped and rolled "
                    f"back at {bad} ({self.skipped_total}/{self.max_skipped} budget used)")
        if self.skipped_total > self.max_skipped:
            path = self._dump(step_i)
            raise TrainHealthError(
                f"{self.skipped_total} non-finite steps exceed "
                f"train.guard.max_skipped_steps={self.max_skipped}"
                + (f"; post-mortem in {path}" if path else ""))

    def info(self) -> dict:
        return {"skipped_total": self.skipped_total, "max_skipped_steps": self.max_skipped,
                "recent_skipped_steps": list(self.skipped_steps)}

    def _dump(self, step_i: int) -> str | None:
        if not self._log_dir:
            return None
        report = {"reason": "non-finite step budget exceeded", "last_step": step_i, **self.info(),
                  "registry": get_registry().snapshot()}
        path = os.path.join(self._log_dir, HEALTH_REPORT_NAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            if self._logger is not None:
                self._logger.error(f"could not write {HEALTH_REPORT_NAME}: {e}")
            return None
        return path

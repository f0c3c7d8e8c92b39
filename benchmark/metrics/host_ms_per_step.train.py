"""``host_ms_per_step.train``: host milliseconds a training step spends in the program's step call,
the ``train/step`` span around ``train/steps.py``'s ``step_fn``: the time the host takes to enqueue
a step, to set beside the device's (``forward_ms_per_step.train`` and the other phases). None unless
the traced window's ``train/step`` records are one a step; a program without the span reads None."""

from yet_another_mobilenet_series_tpu_torch.obs import trace


def read(r):
    records = getattr(trace.get_tracer(), "records", None)
    steps = r.window.get("steps")
    if not r.digest.busy_us or records is None or not steps:
        return None
    step = [s for s in records() if s.name == "train/step"]
    if len(step) != steps:
        return None
    return sum(s.end_ns - s.start_ns for s in step) / 1e6 / steps

"""``backward_ms_per_step.train``: device milliseconds a training step in its backward phase: the
program's ``train/backward`` spans (``train/steps.py``: ``torch.autograd.grad`` of the loss over the
weights), each timed on the card between two events on the step's stream. None unless the traced
window's ``train/step`` and ``train/backward`` records are one a step and each was timed on the
card; a program without the spans reads None."""

from yet_another_mobilenet_series_tpu_torch.obs import trace

SPAN = "train/backward"


def read(r):
    records = getattr(trace.get_tracer(), "records", None)
    steps = r.window.get("steps")
    if not r.digest.busy_us or records is None or not steps:
        return None
    spans = records()
    phase = [s for s in spans if s.name == SPAN]
    if sum(s.name == "train/step" for s in spans) != steps or len(phase) != steps:
        return None
    if any(s.device_start_ns is None for s in phase):
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in phase) / 1e6 / steps

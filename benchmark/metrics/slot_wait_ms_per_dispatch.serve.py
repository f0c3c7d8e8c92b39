"""``slot_wait_ms_per_dispatch.serve``: host milliseconds a serving dispatch waits for a staging
slot: the program's ``serve/slot_wait`` spans (``serve/engine.py`` ``_SlotPool.acquire``: the wait
on the fence of the replay that last read the slot; a slot whose fence has passed opens none), over
the window's dispatches (its ``serve/dispatch`` and ``serve/dispatch_fused`` records). None without
a dispatch; a program without the spans reads None."""

from yet_another_mobilenet_series_tpu_torch.obs import trace


def read(r):
    records = getattr(trace.get_tracer(), "records", None)
    if not r.digest.busy_us or records is None:
        return None
    spans = records()
    dispatches = sum(s.name.startswith("serve/dispatch") for s in spans)
    if not dispatches:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == "serve/slot_wait") / 1e6 / dispatches

"""``stage_ms_per_dispatch.serve``: host milliseconds a serving dispatch spends staging its rows:
the self time of the program's ``serve/stage`` spans (``serve/engine.py`` ``_dispatch_piece``: the
rows copied into a staging slot and the pad rows zeroed), that is each span's host time without that
of its children, the ``serve/slot_wait`` fence wait and the ``serve/h2d`` copy, over the window's
dispatches (its ``serve/dispatch`` and ``serve/dispatch_fused`` records). None without a dispatch; a
program without the spans reads None."""

from yet_another_mobilenet_series_tpu_torch.obs import trace


def read(r):
    records = getattr(trace.get_tracer(), "records", None)
    if not r.digest.busy_us or records is None:
        return None
    spans = records()
    dispatches = sum(s.name.startswith("serve/dispatch") for s in spans)
    if not dispatches:
        return None
    children: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    stage = [s.end_ns - s.start_ns - children.get(s.sid, 0) for s in spans if s.name == "serve/stage"]
    return sum(stage) / 1e6 / dispatches

"""``replay_ms_per_dispatch.serve``: device milliseconds a serving dispatch spends in its replays:
the program's ``serve/dispatch*`` spans (``serve/engine.py`` ``_run_piece``: from just after the
compute stream's wait on the copy, through the input's copy into the graph's static input, the
replay and the logits' copy to the host, to the done fence), each timed on the card between two
events on the compute stream, over the window's dispatches (its ``serve/dispatch`` and
``serve/dispatch_fused`` records). None without a dispatch, or when a ``serve/dispatch*`` record has
no device time; a program without the spans reads None."""

from yet_another_mobilenet_series_tpu_torch.obs import trace


def read(r):
    records = getattr(trace.get_tracer(), "records", None)
    if not r.digest.busy_us or records is None:
        return None
    spans = records()
    dispatches = sum(s.name.startswith("serve/dispatch") for s in spans)
    timed = [s for s in spans if s.name.startswith("serve/dispatch")]
    if not dispatches or not timed or any(s.device_start_ns is None for s in timed):
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in timed) / 1e6 / dispatches

"""``p95_ms.serve``: the 95th percentile of the traced window's requests, from the send to the
logits on the host (nearest rank). In a closed loop that keeps the engine busy the tail swings
with the host's share of the machine, so it stands here, beside the throughput it moves, and
not under a bound."""


def read(r):
    return r.window.get("serve_p95_ms")

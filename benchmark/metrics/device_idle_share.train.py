"""``device_idle_share.train``: the share of the timed window in which no kernel, copy or set ran
on the card, on any stream: 1 - the union of the device intervals over the window's own span."""


def read(r):
    if not r.digest.busy_us:
        return None
    return 100.0 * (1.0 - r.digest.busy_us / r.digest.window_us)

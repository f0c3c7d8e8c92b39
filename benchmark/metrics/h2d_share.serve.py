"""``h2d_share.serve``: device time of host-to-device copies (the staged requests crossing to the
card) over the card's busy time, from the trace."""


def read(r):
    if not r.digest.busy_us:
        return None
    return 100.0 * r.digest.h2d_us / r.digest.busy_us

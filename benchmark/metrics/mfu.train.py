"""``mfu.train``: the training step's share of the card's peak over the traced window: 6 x the
forward's MACs (counted from the reference's shapes: forward and backward, 2 FLOPs a MAC) x
images a second over the data sheet's dense peak of the configuration's compute dtype."""

from benchmark.frozen import costs


def read(r):
    peak = costs.peak_flops(r.card, r.counters["precision"])
    if peak is None or not r.digest.busy_us:
        return None
    images_per_s = r.window["images"] / (r.digest.window_us / 1e6)
    return 100.0 * r.counters["mfu_factor"] * r.counters["macs_per_image"] * images_per_s / peak

"""``mfu.serve``: the serving engine's share of the card's peak over the traced window: 2 x the
forward's MACs (counted from the reference's shapes) x images served a second over the data
sheet's dense peak of the precision the engine's convolutions run in (float32 with TF32 off,
TF32, or bfloat16; the run's ``card.precision`` names it)."""

from benchmark.frozen import costs


def read(r):
    peak = costs.peak_flops(r.card, r.counters["precision"])
    if peak is None or not r.digest.busy_us:
        return None
    images_per_s = r.window["images"] / (r.digest.window_us / 1e6)
    return 100.0 * r.counters["mfu_factor"] * r.counters["macs_per_image"] * images_per_s / peak

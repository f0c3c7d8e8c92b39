"""``k1_roofline.serve``: K1's share of its roofline: the bound of the depthwise stages the
window served (``stage_bound`` of each stage at each dispatched bucket's rows, counted from the
model's shapes and the engine's per-bucket dispatch counts) over the summed device time of the
``fused_dw_kernel`` records. The run's ``k1_records`` check holds the number of those records to
the kernel's own launch counter."""


def read(r):
    if not r.digest.k1_records:
        return None
    bound = sum(hits * r.counters["k1_bound_ms_by_bucket"][b] for b, hits in r.window["bucket_hits"].items())
    return 100.0 * bound / (r.digest.k1_us / 1e3)

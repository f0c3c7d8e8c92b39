"""Traffic kind ``bulk``: a closed loop of clients, each sending a batch of images to the serving
engine and waiting for its logits before it sends the next.

A mix of this kind gives ``clients``, the request sizes (``sizes``: ``count`` sizes spread
log-uniformly over ``min_images``..``max_images``, the same set for every seed, each client
sending them in an order of its own drawn from the seed), ``pool_rows`` (normalized f32 pixels
drawn at set-up; a request reads a slice of them from an offset drawn from the seed) and
``trace_seconds`` (a traced run's window).

Set-up builds the engine as ``cli/serve.py`` builds it (``engine_kwargs`` of the configuration's
``serve:`` section) over a bundle folded in memory from the drawn weights and running
statistics (``serve/export.py`` ``fold_network``), captures its graphs (``warmup``) and sends
every request size once. The window's entry is ``InferenceEngine.predict_async(...).result()``.
The check compares every row of the sampled requests that the window sent, one of each size,
dealt among the clients by the seed and sent first, the largest first, with the reference's eval
forward: a slow window sends fewer of them, and still sends the longest.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import inputs
from ..frozen import clients, costs
from ..reference import compare, lowp, nets

REFERENCE_ROWS = 128  # rows of one block of the reference's forward


def request_sizes(mix: dict) -> list[int]:
    lo, hi, n = math.log(mix["min_images"]), math.log(mix["max_images"]), int(mix["count"])
    return [round(math.exp(lo + (j + 0.5) / n * (hi - lo))) for j in range(n)]


def plan(mix: dict, seed: int) -> tuple[list[list[tuple[int, int]]], set[tuple[int, int]]]:
    """Each client's sequence of (size, pool offset), every size once in an order drawn from
    the seed, and the (client, index) of the requests the check samples: one of each size,
    dealt among the clients by the seed and sent first, the largest first, so that even a short
    or slow window sends the longest."""
    sizes = request_sizes(mix)
    n_clients = int(mix["clients"])
    rs = np.random.default_rng(inputs.sub_seed(seed, "bulk-plan"))
    span = int(mix["pool_rows"]) - max(sizes)
    dealt = rs.permutation(len(sizes))
    seqs, keep = [], set()
    for c in range(n_clients):
        own = sorted((int(j) for j in dealt[c::n_clients]), reverse=True)
        rest = [int(j) for j in rs.permutation(len(sizes)) if j not in set(own)]
        offsets = rs.integers(0, span + 1, size=len(sizes))
        seqs.append([(sizes[j], int(o)) for j, o in zip(own + rest, offsets)])
        keep.update((c, i) for i in range(len(own)))
    return seqs, keep


def port_config(cfg: dict):
    from yet_another_mobilenet_series_tpu_torch.config import config_from_dict

    return config_from_dict({"model": cfg["model"], "data": cfg["data"], "serve": cfg["serve"], "dist": cfg["dist"]})


class Runner:
    def __init__(self, cell, seed: int, device: torch.device, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.cfg, self.mix = cell.config, cell.traffic
        self.size = int(self.cfg["data"]["image_size"])
        self.arch = nets.from_config(self.cfg["model"])
        self.sequences, self.keep = plan(self.mix, seed)

    def setup(self) -> None:
        from yet_another_mobilenet_series_tpu_torch.cli.serve import engine_kwargs
        from yet_another_mobilenet_series_tpu_torch.models import get_model
        from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
        from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
        from yet_another_mobilenet_series_tpu_torch.serve.export import InferenceBundle, fold_network

        cfg = port_config(self.cfg)
        self.port_cfg = cfg
        net = get_model(cfg.model, image_size=self.size)
        params, state = inputs.weights(self.arch, self.seed, self.device)
        self.p0 = {k: v.cpu() for k, v in params.items()}
        self.s0 = {k: v.cpu() for k, v in state.items()}
        bundle = InferenceBundle(net=net, params=fold_network(net, inputs.nest(params), inputs.nest(state)), meta={})
        del params, state
        self.engine = InferenceEngine(bundle, device=self.device, **engine_kwargs(cfg, device=str(self.device)))
        self.engine.warmup()
        rows = int(self.mix["pool_rows"])
        self.pool = inputs.images(self.seed, "serve-pool", rows, self.size, self.device).cpu().numpy()
        for n in sorted(set(request_sizes(self.mix))):
            self.engine.predict(self.pool[:n])
        self.registry = get_registry()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _send(self, client: int, request: tuple[int, int]) -> np.ndarray:
        n, off = request
        with self.spans.span("bench/bulk.predict_async"):
            pending = self.engine.predict_async(self.pool[off: off + n])
        with self.spans.span("bench/bulk.result"):
            return pending.result()

    def _bucket_hits(self) -> dict[int, float]:
        return {b: self.registry.counter(f"serve.bucket_hits.{b}").value for b in self.engine.buckets}

    def window(self, seconds: float, tracer) -> dict:
        from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import device_launches

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if tracer.on:
            seconds = min(seconds, float(self.mix["trace_seconds"]))
            k1_before = device_launches(self.device) if cuda else 0
        hits0 = self._bucket_hits()
        tracer.start()
        records, start, end = clients.closed_loop(self._send, self.sequences, seconds,
                                                  keep=lambda c, i: (c, i) in self.keep)
        tracer.stop()
        hits = {b: v - hits0[b] for b, v in self._bucket_hits().items()}
        self.records = records
        ok = [r for r in records if r.error is None]
        in_window = [r for r in ok if r.done <= end]
        lat = sorted(r.done - r.sent for r in in_window)
        images = sum(r.request[0] for r in in_window)
        out = {"attempted": len(records), "failed": len(records) - len(ok), "requests": len(in_window),
               "images": images, "window_s": seconds, "serve_images_per_s": images / seconds,
               "bucket_hits": hits}
        if lat:
            out["serve_p95_ms"] = 1e3 * lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
        if tracer.on:
            # every image sent in the traced window, including what finished after its end
            out["images"] = sum(r.request[0] for r in ok)
            if cuda:
                out["k1_launches"] = device_launches(self.device) - k1_before
        if cuda:
            self.peak = max(self.setup_peak, torch.cuda.max_memory_allocated(self.device))
        return out

    def release(self) -> int:
        del self.engine
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return self.peak

    def layer_counters(self) -> dict:
        """What the per-layer readers need beside the trace: MACs an image, the precision of the
        engine's convolutions (TF32's flags read now), K1's stages and their bound by bucket."""
        tf32 = torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        precision = self.cfg["serve"]["compute_dtype"]
        if precision == "float32" and tf32:
            precision = "tf32"
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        itemsize = 4 if self.cfg["serve"]["compute_dtype"] == "float32" else 2
        stages = costs.depthwise_stages(self.arch, self.size)
        return {"macs_per_image": costs.forward_macs(self.arch, self.size), "mfu_factor": 2, "precision": precision,
                "k1_stages": len(stages),
                "k1_bound_ms_by_bucket": {b: costs.forward_bound_ms(self.arch, self.size, b, itemsize,
                                                                    costs.card_rates(name))
                                          for b in self.cfg["serve"]["buckets"]}}

    # -- the check -----------------------------------------------------------------------

    def sampled(self) -> list[clients.Record]:
        """The sampled requests that the window sent; every one has completed."""
        return sorted((r for r in self.records if (r.client, r.index) in self.keep), key=lambda r: (r.client, r.index))

    def compared(self) -> list[clients.Record]:
        return [r for r in self.sampled() if r.error is None]

    def reference_logits(self, requests, tf32: bool = False) -> list[np.ndarray]:
        params = {k: v.to(self.device) for k, v in self.p0.items()}
        state = {k: v.to(self.device) for k, v in self.s0.items()}
        out = []
        with torch.no_grad(), lowp.tf32(tf32):
            for n, off in requests:
                rows = []
                for a in range(0, n, REFERENCE_ROWS):
                    x = torch.from_numpy(self.pool[off + a: off + min(n, a + REFERENCE_ROWS)]).to(self.device)
                    rows.append(nets.forward(self.arch, params, state, x).double().cpu().numpy())
                out.append(np.concatenate(rows))
        return out

    def check(self) -> dict[str, dict]:
        sent, recs = self.sampled(), self.compared()
        if not recs:
            return {"logits": {"value": math.inf, "leaf": "no sampled request answered"},
                    "missing_requests": {"value": float(len(sent)), "leaf": f"none of the {len(sent)} sent answered"}}
        refs = self.reference_logits([r.request for r in recs])
        gaps = [compare.logit_gap(r.answer, ref) for r, ref in zip(recs, refs)]
        worst = max(range(len(gaps)), key=lambda i: gaps[i][0])
        r = recs[worst]
        return {"logits": {"value": gaps[worst][0],
                           "leaf": f"client {r.client} request {r.index} ({r.request[0]} images) row {gaps[worst][1]}"},
                "missing_requests": {"value": float(len(sent) - len(recs)),
                                     "leaf": f"{len(recs)} of the {len(sent)} sampled requests sent compared "
                                             f"({len(self.keep)} sampled)"}}

    def control(self) -> dict[str, dict]:
        """The reference in the program's place with TF32 on (the precision below float32 with
        TF32 off), on the requests a run compares."""
        reqs = [r.request for r in self.compared()]
        gaps = [compare.logit_gap(a, b)[0] for a, b in zip(self.reference_logits(reqs, tf32=True),
                                                          self.reference_logits(reqs))]
        return {"logits": {"value": max(gaps), "leaf": f"{len(reqs)} requests"}}

    def faults(self) -> dict:
        return {}

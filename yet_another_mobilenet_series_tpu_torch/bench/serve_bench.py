"""Serving benchmark on one card: the torch twin of the single-model arms of
``scripts/serve_bench.py`` (``measure`` and what it calls).

Every arm serves MobileNetV3-Large (seeded weights, seeded BN statistics,
folded by ``serve/export.py``) through the port's engine, whose every
executable is a CUDA graph and every depthwise stage a launch of K1; the
line carries the K1 launches the engines counted (their graphs' captured
launches x replays, and the eager warm runs and captures). The arms:

1. **direct** — ``engine.predict`` latency per (bucket, size) on exact
   bucket batches: p50/p99, QPS, the registry's quantiles of the same
   window and the H2D share (``serve.h2d_seconds`` over
   ``serve.run_seconds``) (``_direct_row``);
2. **concurrent** — closed-loop clients submitting single images through
   the sync ``MicroBatcher`` and the ``PipelinedBatcher`` in interleaved
   rounds, median QPS per mode (``_concurrent_row``);
3. **bf16** — a bf16 engine's direct rows beside the f32 ones, and the
   max |logit delta| on one batch against ``BF16_PARITY_ATOL``;
4. **fused** — whole requests of K max-bucket chunks, chained against the
   fused-K graphs: dispatches per request, bitwise logits (``_fused_ab``);
5. **structural** — sync / pipelined / fused / overlapped / ring in
   interleaved rounds at a saturated bucket, with
   ``serve.dispatches_per_wakeup``, ``serve.achieved_flops_per_s`` and the
   deterministic one-dispatch ring probe (``_structural_sweep``);
6. **quant** — f32, uint8 wire and int8 weights per bucket: QPS, H2D and
   dispatched bytes per request, the parity verdicts (``_quant_ab``);
7. **chaos** — the open-loop Poisson A/B (``_chaos_ab``) on the shipped
   serving stack (``apps/serve_mobilenet_v3.yml``'s engine and batcher,
   built by ``cli/serve.py``'s helpers): mixed priority classes through
   admission control, a healthy and a fault-injected round
   (``serve/faults.py``) on one arrival schedule, at each rate of
   ``--chaos-qps`` (absolute) or else ``--chaos-load`` (fractions of the
   stack's closed-loop peak, measured first in the same run), each round
   ``--chaos-requests`` requests. Arrivals fire on schedule whatever the
   completions; a request's latency counts from when it was due, and the
   line reports how late the generator ran. Per class and overall:
   submitted, completed, rejected, shed, failed, p50/p99; ``unresolved``
   must be 0.

It prints one JSON line (``--out`` copies it), stamped with the card
(``card_provenance``). A failure prints a line with ``value: null`` and
``error`` and exits 1, as does a request for the card (the default)
without one. ``--device cpu`` rehearses every arm for the tests: the line
says ``"platform": "cpu"``, ``cpu_rehearsal: true``, and every time, rate
and share in it is null (counts and parity verdicts stay).

Two more arms run on their own, each a fleet of the port's ``cli/serve.py``
replica processes on the card behind the router (``serve/router.py``),
as the JAX package's ``scripts/serve_bench.py`` runs them:

- ``--fleet`` (``measure_fleet``): two replicas of ``--arch``; hedged
  against unhedged on one seeded open-loop schedule offered at 0.35 / the
  warm p50, with one straggler replica (400 ms added to 30% of its answers,
  ``serve/faults.py``),
  the federation's windowed p99 against the pooled per-replica reference, a
  kill -9 of a serving replica mid-round (every request completed or
  typed-rejected, the supervisor restarts it), and the autoscaler on a
  low/high/low schedule (``--fleet-phase-s``). The line's value is the
  hedged round's p99 (ms); ``offered_qps`` stands beside it.
- ``--zoo`` (``measure_zoo``): one fleet of two replicas placed
  ``small;big``: MobileNetV3-Small with int8 weights and ``--arch`` in
  float32, at bucket 1 so that every answer compares bit for bit; three
  arms on one seeded trace: big only, a 50/50 model-pinned mix (no
  misroute), and the confidence cascade (``serve/cascade.py``) at the
  median small-model margin of a calibration set kept apart from the trace
  (escalations > 0, each answer bitwise one of the two references,
  fleet-wide dispatched FLOPs per request strictly below big-only's). The
  line's value is the cascade's FLOPs per request over big-only's, which
  the trace's measured escalation rate sets.

``--arch tiny`` runs both on the JAX bench's tiny presets, for a CPU
rehearsal.

Two more arms, each alone, with the JAX bench's flags and defaults:

- ``--overload`` (``measure_overload``): the brownout ladder's A/B under
  one seeded open-loop storm at ``--overload-multiple`` x the measured
  closed-loop capacity, the engine (``--arch`` on the card) paced at
  ``--overload-pace-ms`` a dispatch by ``serve/faults.py``; then a
  gray-failure round, a fleet of ``--overload-replicas`` replica processes
  behind the router whose last one adds ``--overload-straggler-ms`` to
  every answer, slow ejection armed a third of the way in. The line's value
  is the interactive class's availability with the ladder on
  (completed/submitted, a count ratio that stands on the CPU too); the
  ladder's trace, its recovery to L0, the time to eject and the p99 before
  and after it stand beside it;
- ``--partition`` (``measure_partition``): echo replicas behind seeded
  ``serve/netchaos.py`` proxies and one router, the blackhole, reset,
  half-open and flap rounds and the TTL-lease membership round. It touches
  no device, so it runs on any host whatever ``--device`` says, and its
  line (``"platform": "host"``, ``touches_device: false``) keeps its host
  times. The value is the blackhole round's detection time in seconds.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.serve_bench
           [--arch mobilenet_v3_large] [--image-sizes 224] [--buckets 1,8,32]
           [--arms direct,concurrent,bf16,fused,structural,quant,chaos]
           [--iters 20] [--rounds 5] [--concurrent-iters 6] [--ab-iters 10]
           [--fuse-ladder 2,4] [--fused-iters 8] [--structural-rounds 3]
           [--quant-iters 5] [--quant-rounds 3] [--quant-top1-min 0.9]
           [--chaos-requests 1000] [--chaos-qps Q1,Q2] [--chaos-load 0.5,0.9]
           [--chaos-fault-rate 0.05] [--device cpu] [--out f.json]
       ... --fleet [--fleet-requests 500] [--fleet-phase-s 5,20,10]
       ... --zoo [--zoo-requests 500]
       ... --overload [--overload-storm-s 5] [--overload-multiple 3] [--overload-pace-ms 20]
                      [--overload-replicas 2] [--overload-gray-requests 60] [--overload-straggler-ms 300]
       ... --partition [--partition-replicas 3] [--partition-requests 120] [--partition-qps 30]
                       [--partition-poll-s 0.1] [--partition-connect-timeout-s 0.4]
                       [--partition-read-timeout-s 2.0] [--partition-lease-ttl-s 1.5]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..obs import device as obs_device
from ..obs.registry import get_registry, quantiles_from_counts
from ..utils.benchkit import card_provenance, percentile
from ..utils.device import resolve_device

# the max |logit delta| of a bf16 engine against the f32 one that the JAX
# package pins (its serve/engine.py:189); the port keeps its own copy
BF16_PARITY_ATOL = 0.35
ARMS = ("direct", "concurrent", "bf16", "fused", "structural", "quant", "chaos")
CHAOS_CLASS_MIX = {"interactive": 0.5, "batch": 0.3, "best_effort": 0.2}
# the overload arm's class mix (the JAX bench's)
OVERLOAD_CLASS_MIX = {"interactive": 0.4, "batch": 0.2, "best_effort": 0.4}
# closed-loop requests each calibration client sends in turn, timed (the
# JAX bench's 48 over its 4 tiny-preset clients)
OVERLOAD_CALIBRATION_ROUNDS = 12
# the storm stack's queue in largest-bucket batches (the JAX bench's 128
# rows at its tiny preset's bucket 4): a backlog of that many dispatches is
# what the interactive deadline, 8x the healthy p50, must sit under. 128 rows
# at bucket 32 are four dispatches, a wait no deadline ever bound
OVERLOAD_QUEUE_BATCHES = 32
# what the two arms' lines say of the host they ran on (the JAX bench's caveats)
OVERLOAD_CPU_NOTE = ("cpu_rehearsal: the engine, batcher, brownout controller, load generator and replicas share "
                     "the CPU's cores, so absolute rates and latencies are the host's; the claims that hold on any "
                     "host are the A/B's ordering, the ladder's climb and its recovery to L0, no unresolved future "
                     "and the straggler's soft ejection")
PARTITION_NOTE = ("cpu_rehearsal: the router, the replicas, their proxies and the load generator share one host's "
                  "cores over loopback (no device is touched on any machine), so absolute latencies and rates are "
                  "that host's; detection within the poll budget, zero client-visible failures, readmission after "
                  "each heal and the lease's removal hold on any host")
# the fleet arms' fixed settings: the offered rate of an open-loop round is
# FLEET_LOAD / the warm p50; the --fleet arm's last replica adds
# STRAGGLER_MS to a STRAGGLER_RATE share of its answers; the --zoo arm's
# cascade threshold is the median small-model margin of ZOO_CALIB_IMAGES
# images kept apart from the timed trace
FLEET_REPLICAS = 2
FLEET_LOAD = 0.35
FLEET_SEED = 0
STRAGGLER_MS = 400.0
STRAGGLER_RATE = 0.3
ZOO_CALIB_IMAGES = 64
ZOO_INT8_TOP1_MIN = 0.5


def _hist_counts(name):
    return get_registry().histogram(name).bucket_counts()


def _hist_delta_quantiles(name, counts_before):
    """p50/p95/p99 (ms) of one window of a registry histogram: its bucket
    counts against the snapshot before the window, through the registry's
    own interpolation (what ``/metrics`` scrapes would say)."""
    h = get_registry().histogram(name)
    counts = [a - b for a, b in zip(h.bucket_counts(), counts_before)]
    p50, p95, p99 = quantiles_from_counts(h.bounds, counts, (0.5, 0.95, 0.99))
    return {"count": int(sum(counts)), "p50_ms": p50 * 1e3, "p95_ms": p95 * 1e3, "p99_ms": p99 * 1e3}


def _direct_row(engine, batch, size, iters, rng):
    """Exact-bucket ``engine.predict`` latency: one untimed call, then
    ``iters`` timed ones; the registry's quantiles and the H2D share of the
    same window ride along."""
    x = rng.normal(0, 1, (batch, size, size, 3)).astype("float32")
    engine.predict(x)
    reg = get_registry()
    run_counts0 = _hist_counts("serve.run_seconds")
    s0 = reg.snapshot()
    lat = []
    for _ in range(iters):
        t1 = time.perf_counter()
        engine.predict(x)
        lat.append(time.perf_counter() - t1)
    s1 = reg.snapshot()
    reg_q = _hist_delta_quantiles("serve.run_seconds", run_counts0)
    lat.sort()
    run_s = s1["serve.run_seconds.sum"] - s0["serve.run_seconds.sum"]
    h2d_s = s1["serve.h2d_seconds.sum"] - s0["serve.h2d_seconds.sum"]
    return {
        "batch": batch, "image_size": size, "iters": iters,
        "p50_ms": percentile(lat, 0.50) * 1e3, "p99_ms": percentile(lat, 0.99) * 1e3,
        "p50_ms_registry": reg_q["p50_ms"], "p95_ms_registry": reg_q["p95_ms"], "p99_ms_registry": reg_q["p99_ms"],
        "qps": batch / (sum(lat) / len(lat)),
        "h2d_share": h2d_s / run_s if run_s > 0 else None,
    }


def _drive_concurrent(batcher, image, n_requests, n_clients):
    """Closed-loop clients: each submits one image, waits, repeats. Returns
    (qps, sorted latencies). The batcher must already be started."""
    lock = threading.Lock()
    left = [n_requests]
    lat: list[float] = []

    def client():
        while True:
            with lock:
                if left[0] <= 0:
                    return
                left[0] -= 1
            t0 = time.perf_counter()
            batcher.submit(image).result(timeout=300)
            with lock:
                lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    lat.sort()
    return (len(lat) / wall if wall > 0 else 0.0), lat


def _concurrent_row(engine, batch, size, conc_iters, max_inflight, rounds, rng):
    """Sync against pipelined QPS through the real batchers at
    ``max_batch=batch``: 2 x batch closed-loop clients, interleaved rounds,
    the median round per mode, and how full the dispatched buckets were."""
    from ..serve.batcher import MicroBatcher
    from ..serve.pipeline import PipelinedBatcher

    image = rng.normal(0, 1, (size, size, 3)).astype("float32")
    n_clients = min(max(2 * batch, 4), 64)
    n_requests = min(max(conc_iters * batch, 48), 96)
    common = dict(max_batch=batch, max_wait_ms=10.0, queue_depth=max(64, 4 * batch))
    reg = get_registry()
    row = {"batch": batch, "image_size": size, "requests": n_requests, "clients": n_clients, "rounds": rounds}
    batchers = {"sync": MicroBatcher(engine.predict, **common).start(),
                "pipelined": PipelinedBatcher(engine, max_inflight=max_inflight, **common).start()}
    runs = {m: [] for m in batchers}
    fills = {m: [] for m in batchers}
    try:
        for b in batchers.values():
            _drive_concurrent(b, image, min(2 * batch, n_requests), n_clients)
        for _ in range(rounds):
            for mode, b in batchers.items():
                s0 = reg.snapshot()
                qps, lat = _drive_concurrent(b, image, n_requests, n_clients)
                s1 = reg.snapshot()
                d_count = s1["serve.batch_size.count"] - s0["serve.batch_size.count"]
                d_sum = s1["serve.batch_size.sum"] - s0["serve.batch_size.sum"]
                fills[mode].append(d_sum / d_count / batch if d_count else 0.0)
                runs[mode].append((qps, lat))
    finally:
        for b in batchers.values():
            b.stop()
    for mode in batchers:
        med_qps, med_lat = sorted(runs[mode], key=lambda r: r[0])[len(runs[mode]) // 2]
        row[f"qps_{mode}"] = med_qps
        row[f"qps_rounds_{mode}"] = [q for q, _ in runs[mode]]
        row[f"p50_ms_{mode}"] = percentile(med_lat, 0.50) * 1e3
        row[f"p99_ms_{mode}"] = percentile(med_lat, 0.99) * 1e3
        row[f"avg_fill_{mode}"] = sum(fills[mode]) / len(fills[mode])
    row["pipelined_speedup"] = row["qps_pipelined"] / row["qps_sync"] if row["qps_sync"] else None
    return row


def _timed_predicts(engine, x, iters):
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.predict(x)
        lat.append(time.perf_counter() - t0)
    return sorted(lat)


def _fused_ab(chained, fused, size, iters, rng):
    """Chained (per-chunk) against fused (one graph of K forwards) whole
    requests of K max-bucket chunks, for each K on the ladder and one off
    it: dispatches per request (``serve.dispatch_seconds`` count deltas),
    p50/p99, QPS, and bitwise equal logits."""
    reg = get_registry()
    cap = fused.buckets[-1]
    ladder = list(fused.fuse_ladder)
    off_k = next(k for k in range(2, max(ladder) + 2) if k not in ladder)
    rows = []
    for k in ladder + [off_k]:
        n = k * cap
        x = rng.normal(0, 1, (n, size, size, 3)).astype("float32")
        ref = chained.predict(x)
        row = {"k": k, "rows": n, "on_ladder": k in ladder, "bitwise_ok": bool(np.array_equal(fused.predict(x), ref))}
        for label, eng in (("chained", chained), ("fused", fused)):
            eng.predict(x)
            s0 = reg.snapshot()
            lat = _timed_predicts(eng, x, iters)
            s1 = reg.snapshot()
            row[f"p50_ms_{label}"] = percentile(lat, 0.50) * 1e3
            row[f"p99_ms_{label}"] = percentile(lat, 0.99) * 1e3
            row[f"qps_{label}"] = n / (sum(lat) / len(lat))
            row[f"dispatches_per_request_{label}"] = (
                s1["serve.dispatch_seconds.count"] - s0["serve.dispatch_seconds.count"]) / iters
        row["fused_speedup"] = row["qps_fused"] / row["qps_chained"] if row["qps_chained"] else None
        rows.append(row)
    return {"ladder": ladder, "off_ladder_k": off_k, "max_bucket": cap, "image_size": size, "per_k": rows,
            "peak_speedup": max(r["fused_speedup"] or 0.0 for r in rows)}


_SWEEP_KEYS = ("serve.dispatch_seconds.count", "serve.batch_size.count", "serve.batch_size.sum",
               "serve.dispatches_per_wakeup.count", "serve.dispatches_per_wakeup.sum", "serve.dispatched_flops",
               "serve.dispatched_bytes", "serve.run_seconds.sum", "serve.ring_dispatches",
               "serve.ring_slots_per_dispatch.count", "serve.ring_slots_per_dispatch.sum")


def _structural_sweep(make_engine, size, *, rounds, conc_iters, max_inflight, staging_slots, run_max,
                      fuse_ladder, rng, ring_slots=4, ring_min_fill=0.5):
    """One interleaved sweep over the five serving structures at a
    saturated bucket (``max_batch`` = 2 x the biggest bucket, 3 x that many
    closed-loop clients): ``sync`` (MicroBatcher), ``pipelined``,
    ``fused``, ``overlapped`` (staging slots, back-to-back runs) and
    ``ring``; per mode the median-round QPS and the registry deltas the
    structural claims read (dispatches per request and per wake-up,
    dispatched FLOPs and bytes, achieved FLOP/s, ring windows). Before the
    rounds, the bitwise check across the structures and the ring probe: a
    saturated R-slot window is exactly one ``serve.dispatch_seconds``
    observation."""
    from ..serve.batcher import MicroBatcher
    from ..serve.pipeline import PipelinedBatcher

    reg = get_registry()
    eng_chained = make_engine("float32")
    eng_fused = make_engine("float32", fuse=fuse_ladder)
    eng_overlap = make_engine("float32", fuse=fuse_ladder, overlap=True, staging_slots=staging_slots)
    eng_ring = make_engine("float32", overlap=True, staging_slots=staging_slots, ring_slots=ring_slots)
    for e in (eng_chained, eng_fused, eng_overlap, eng_ring):
        e.warmup()
    cap = eng_chained.buckets[-1]
    max_batch = 2 * cap
    n_clients = 3 * max_batch
    n_requests = min(max(conc_iters * max_batch, 2 * n_clients), 384)
    image = rng.normal(0, 1, (size, size, 3)).astype("float32")
    xp = rng.normal(0, 1, (max_batch, size, size, 3)).astype("float32")
    ref = eng_chained.predict(xp)
    bitwise_ok = all(np.array_equal(e.predict(xp), ref) for e in (eng_fused, eng_overlap, eng_ring))
    xr = rng.normal(0, 1, (ring_slots * cap, size, size, 3)).astype("float32")
    chunks = [np.ascontiguousarray(xr[i * cap:(i + 1) * cap]) for i in range(ring_slots)]
    ring_ref = np.concatenate([eng_chained.predict(c) for c in chunks])
    s0 = reg.snapshot()
    ring_out = eng_ring.ring_dispatch([eng_ring.ring_stage(c) for c in chunks]).result()
    s1 = reg.snapshot()
    ring_probe = {
        "slots": ring_slots, "rows": int(ring_slots * cap),
        "dispatch_seconds_count_delta": int(s1["serve.dispatch_seconds.count"] - s0["serve.dispatch_seconds.count"]),
        "ring_dispatches_delta": int(s1.get("serve.ring_dispatches", 0) - s0.get("serve.ring_dispatches", 0)),
        "fill": float(s1.get("serve.ring_fill", 0.0)),
        "bitwise_ok": bool(np.array_equal(ring_out, ring_ref)),
    }
    xb = rng.normal(0, 1, (cap, size, size, 3)).astype("float32")
    eng_chained.predict(xb)
    lat = _timed_predicts(eng_chained, xb, 5)
    flops_1 = obs_device.flops_for(f"serve_b{cap}_s{size}_k1")
    single_ref = flops_1 / percentile(lat, 0.5) if lat[0] > 0 else 0.0

    common = dict(max_batch=max_batch, max_wait_ms=10.0, queue_depth=max(256, 8 * max_batch))
    batchers = {
        "sync": MicroBatcher(eng_chained.predict, **common).start(),
        "pipelined": PipelinedBatcher(eng_chained, max_inflight=max_inflight, **common).start(),
        "fused": PipelinedBatcher(eng_fused, max_inflight=max_inflight, **common).start(),
        "overlapped": PipelinedBatcher(eng_overlap, max_inflight=max_inflight, run_max=run_max, **common).start(),
        "ring": PipelinedBatcher(eng_ring, max_inflight=max_inflight, run_max=run_max, ring_min_fill=ring_min_fill,
                                 **common).start(),
    }
    runs = {m: [] for m in batchers}
    try:
        for b in batchers.values():
            _drive_concurrent(b, image, min(2 * max_batch, n_requests), n_clients)
        for _ in range(rounds):
            for mode, b in batchers.items():
                run_counts0 = _hist_counts("serve.run_seconds")
                s0 = reg.snapshot()
                qps, lat = _drive_concurrent(b, image, n_requests, n_clients)
                s1 = reg.snapshot()
                d = {k: s1.get(k, 0) - s0.get(k, 0) for k in _SWEEP_KEYS}
                d["registry_q"] = _hist_delta_quantiles("serve.run_seconds", run_counts0)
                runs[mode].append((qps, lat, d))
    finally:
        for b in batchers.values():
            b.stop()
    modes = {}
    for mode, rows in runs.items():
        med_qps, med_lat, med_d = sorted(rows, key=lambda r: r[0])[len(rows) // 2]
        tot = {k: sum(r[2][k] for r in rows) for k in _SWEEP_KEYS}
        batches, wakeups = tot["serve.batch_size.count"], tot["serve.dispatches_per_wakeup.count"]
        slots = tot["serve.ring_slots_per_dispatch.count"]
        modes[mode] = {
            "qps": med_qps, "qps_rounds": [q for q, _, _ in rows],
            "p99_ms": percentile(med_lat, 0.99) * 1e3,
            "p50_ms_registry": med_d["registry_q"]["p50_ms"], "p99_ms_registry": med_d["registry_q"]["p99_ms"],
            "avg_fill": tot["serve.batch_size.sum"] / batches / max_batch if batches else 0.0,
            "dispatches_per_request": tot["serve.dispatch_seconds.count"] / (rounds * n_requests),
            "dispatches_per_wakeup": tot["serve.dispatches_per_wakeup.sum"] / wakeups if wakeups else None,
            "dispatched_gflops": tot["serve.dispatched_flops"] / 1e9,
            "dispatched_gbytes": tot["serve.dispatched_bytes"] / 1e9,
            "achieved_flops_per_s": (tot["serve.dispatched_flops"] / tot["serve.run_seconds.sum"]
                                     if tot["serve.run_seconds.sum"] > 0 else None),
            "ring_windows": int(tot["serve.ring_dispatches"]),
            "ring_slots_per_window": tot["serve.ring_slots_per_dispatch.sum"] / slots if slots else None,
        }
    return {
        "image_size": size, "max_bucket": cap, "max_batch": max_batch, "clients": n_clients,
        "requests_per_round": n_requests, "rounds": rounds, "max_inflight": max_inflight, "run_max": run_max,
        "staging_slots": staging_slots, "fuse_ladder": list(fuse_ladder), "bitwise_ok": bitwise_ok,
        "single_dispatch_achieved_flops_per_s": single_ref, "ring_slots": ring_slots,
        "ring_min_fill": ring_min_fill, "ring_probe": ring_probe, "modes": modes,
        "overlapped_speedup_vs_sync": (modes["overlapped"]["qps"] / modes["sync"]["qps"]
                                       if modes["sync"]["qps"] else None),
        "ring_speedup_vs_sync": modes["ring"]["qps"] / modes["sync"]["qps"] if modes["sync"]["qps"] else None,
    }


def _quant_ab(net, params, state, buckets, size, iters, rounds, rng, *, mean, std, top1_min, device, engines_out):
    """f32, uint8 wire and int8 weights (an int8 bundle exported through
    the gated calibration pass), interleaved per bucket: median-round QPS,
    p50/p99, H2D and dispatched bytes per request, and the parity verdicts
    (the zero-mean wire bitwise, the mean/std wire's delta against the
    configured atol, int8 top-1 agreement)."""
    from ..config import QuantConfig
    from ..serve import quant
    from ..serve.engine import InferenceEngine
    from ..serve.export import export_bundle, load_bundle

    wire_atol = QuantConfig().wire_atol
    reg = get_registry()
    calib = quant.normalize_reference(rng.randint(0, 256, (32, size, size, 3)).astype(np.uint8), mean, std)
    with tempfile.TemporaryDirectory(prefix="serve_bench_") as tmp:
        bundle_f32 = load_bundle(export_bundle(net, params, state, f"{tmp}/f32"))
        bundle_int8 = load_bundle(export_bundle(net, params, state, f"{tmp}/int8", quant_weights="int8",
                                                calib_images=calib, int8_top1_min=top1_min, device=device))
    int8_report = bundle_int8.quant
    common = dict(buckets=buckets, image_size=size, image_sizes=(size,), device=device)
    engines = {
        "f32": InferenceEngine(bundle_f32, **common),
        "uint8_wire": InferenceEngine(bundle_f32, wire="uint8", wire_mean=mean, wire_std=std, **common),
        "int8": InferenceEngine(bundle_int8, wire="uint8", wire_mean=mean, wire_std=std, **common),
    }
    e_id_u8 = InferenceEngine(bundle_f32, wire="uint8", **common)
    engines_out.extend([*engines.values(), e_id_u8])
    for e in (*engines.values(), e_id_u8):
        e.warmup()
    cap = buckets[-1]
    raw = rng.randint(0, 256, (cap, size, size, 3)).astype(np.uint8)
    norm = quant.normalize_reference(raw, mean, std)
    ref = engines["f32"].predict(norm)
    wire_delta = float(np.max(np.abs(engines["uint8_wire"].predict(raw) - ref)))
    id_bitwise = bool(np.array_equal(e_id_u8.predict(raw), engines["f32"].predict(quant.normalize_reference(raw))))
    int8_top1 = float(np.mean(np.argmax(engines["int8"].predict(raw), -1) == np.argmax(ref, -1)))
    inputs = {"f32": {b: np.ascontiguousarray(norm[:b]) for b in buckets},
              "uint8_wire": {b: np.ascontiguousarray(raw[:b]) for b in buckets}}
    inputs["int8"] = inputs["uint8_wire"]
    per_bucket = []
    tot = {m: {"h2d": 0.0, "cost": 0.0, "requests": 0} for m in engines}
    for b in buckets:
        row = {"batch": b}
        runs = {m: [] for m in engines}
        for m, e in engines.items():
            e.predict(inputs[m][b])
        for _ in range(rounds):
            for m, e in engines.items():
                s0 = reg.snapshot()
                lat = _timed_predicts(e, inputs[m][b], iters)
                s1 = reg.snapshot()
                runs[m].append((b / (sum(lat) / len(lat)), lat))
                tot[m]["h2d"] += s1.get("serve.h2d_bytes", 0) - s0.get("serve.h2d_bytes", 0)
                tot[m]["cost"] += s1.get("serve.dispatched_bytes", 0) - s0.get("serve.dispatched_bytes", 0)
                tot[m]["requests"] += iters
        for m in engines:
            qps, lat = sorted(runs[m], key=lambda r: r[0])[len(runs[m]) // 2]
            row[f"qps_{m}"] = qps
            row[f"p50_ms_{m}"] = percentile(lat, 0.50) * 1e3
            row[f"p99_ms_{m}"] = percentile(lat, 0.99) * 1e3
        per_bucket.append(row)
    modes = {m: {"quant_mode": e.quant_mode, "h2d_bytes_per_request": tot[m]["h2d"] / tot[m]["requests"],
                 "dispatched_bytes_per_request": tot[m]["cost"] / tot[m]["requests"]} for m, e in engines.items()}
    return {
        "image_size": size, "buckets": list(buckets), "rounds": rounds, "iters_per_round": iters,
        "mean": list(mean), "std": list(std), "per_bucket": per_bucket, "modes": modes,
        "wire_bytes_ratio": modes["f32"]["h2d_bytes_per_request"] / modes["uint8_wire"]["h2d_bytes_per_request"],
        "parity": {
            "identity_norm_bitwise": id_bitwise, "wire_max_abs_logit_delta": wire_delta, "wire_atol": wire_atol,
            "wire_parity_ok": wire_delta <= wire_atol,
            "int8_top1_agreement_calib": int8_report["top1_agreement"],
            "int8_top1_agreement_heldout": int8_top1, "int8_top1_min": top1_min,
        },
        "int8_export": {"quantized_tensors": int8_report["quantized_tensors"],
                        "bytes_f32": int8_report["bytes_f32"], "bytes_int8": int8_report["bytes_int8"],
                        "resident_shrink": int8_report["bytes_f32"] / int8_report["bytes_int8"]},
    }


def _shipped_stack(bundle, base, image_sizes, buckets, fuse_ladder, dev, engines_out):
    """The shipped serving config (``apps/serve_mobilenet_v3.yml``: the
    fused-K ladder, overlapped staging with back-to-back runs, the
    pipelined batcher) at this run's sizes and buckets: ``(engine,
    make_batcher)``, built by ``cli/serve.py``'s own helpers."""
    import dataclasses as dc
    import os

    from ..cli.serve import _make_batcher, engine_kwargs
    from ..config import parse_cli
    from ..serve.engine import InferenceEngine

    app = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "apps", "serve_mobilenet_v3.yml")
    cfg = parse_cli([f"app:{app}", f"data.image_size={base}"])
    serve = dc.replace(cfg.serve, buckets=tuple(buckets), image_sizes=tuple(image_sizes),
                       fuse_chunks=dc.replace(cfg.serve.fuse_chunks, ladder=tuple(fuse_ladder)))
    cfg = dc.replace(cfg, serve=serve)
    engine = InferenceEngine(bundle, device=dev, **engine_kwargs(cfg))
    engine.warmup()
    engines_out.append(engine)
    return engine, (lambda eng: _make_batcher(cfg, eng)), cfg.serve


def _closed_loop_peak(engine, make_batcher, size, max_batch, rounds, conc_iters, rng):
    """Closed-loop single-image clients (2 x max_batch of them) through the
    shipped stack: the median round's QPS, the peak the open-loop rates are
    fractions of."""
    image = rng.normal(0, 1, (size, size, 3)).astype("float32")
    n_clients = 2 * max_batch
    n_requests = max(conc_iters * max_batch, 4 * n_clients)
    batcher = make_batcher(engine).start()
    try:
        _drive_concurrent(batcher, image, n_clients, n_clients)
        runs = [_drive_concurrent(batcher, image, n_requests, n_clients) for _ in range(rounds)]
    finally:
        batcher.stop()
    qps, lat = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    return {"clients": n_clients, "requests": n_requests, "rounds": rounds, "qps": qps,
            "qps_rounds": [q for q, _ in runs], "p50_ms": percentile(lat, 0.5) * 1e3,
            "p99_ms": percentile(lat, 0.99) * 1e3}


def _chaos_round(engine, make_batcher, image_sizes, *, seed, n_requests, target_qps, deadline_ms_by_class,
                 fault_kwargs=None, max_retries=2, result_timeout_s=300.0):
    """One open-loop Poisson round through admission control and the
    shipped batcher. Arrivals are drawn from ``seed`` (both rounds of an
    A/B share them) and fire on schedule whatever the completions; each
    request's latency runs from when it was due to when its future
    resolved (stamped by a done-callback), and how late the generator
    submitted is reported beside it. A future still pending at the end is
    ``unresolved``."""
    from concurrent.futures import TimeoutError as FutTimeout

    from ..serve.admission import AdmissionController
    from ..serve.batcher import DeadlineExceeded, DrainTimeout
    from ..serve.faults import FaultyEngine

    reg = get_registry()
    if fault_kwargs:
        engine = FaultyEngine(engine, **fault_kwargs)
    batcher = make_batcher(engine).start()
    admission = AdmissionController(batcher, max_retries=max_retries, retry_backoff_ms=5.0, breaker_threshold=10,
                                    breaker_cooldown_s=0.5, seed=seed)
    rs = np.random.RandomState(seed)
    classes, probs = zip(*sorted(CHAOS_CLASS_MIX.items()))
    draws_cls = [classes[i] for i in rs.choice(len(classes), size=n_requests, p=probs)]
    draws_size = [image_sizes[i] for i in rs.randint(0, len(image_sizes), size=n_requests)]
    gaps = rs.exponential(1.0 / target_qps, size=n_requests)
    images = {s: rs.normal(0, 1, (s, s, 3)).astype("float32") for s in image_sizes}
    stats = {c: {"submitted": 0, "completed": 0, "rejected": 0, "shed": 0, "failed": 0} for c in classes}
    latencies = {c: [] for c in classes}
    late: list[float] = []
    pending = []
    done_at: dict[int, float] = {}
    lat_counts0 = {c: _hist_counts(f"serve.latency_seconds.{c}") for c in classes}
    s0 = reg.snapshot()
    t_start = time.perf_counter()
    t_due = t_start
    try:
        for i in range(n_requests):
            t_due += gaps[i]
            delay = t_due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)  # open loop: the schedule, not the completions, paces it
            cls = draws_cls[i]
            stats[cls]["submitted"] += 1
            late.append(time.perf_counter() - t_due)
            try:
                fut = admission.submit(images[draws_size[i]], priority=cls, deadline_ms=deadline_ms_by_class.get(cls))
            except Exception:  # noqa: BLE001 — a typed rejection at arrival (quota, breaker, deadline)
                stats[cls]["rejected"] += 1
                continue
            fut.add_done_callback(lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))
            pending.append((i, cls, t_due, fut))
        t_last = time.perf_counter()
        unresolved = 0
        for i, cls, due, fut in pending:
            try:
                fut.result(timeout=result_timeout_s)
            except (DeadlineExceeded, DrainTimeout):
                stats[cls]["shed"] += 1
                continue
            except FutTimeout:
                unresolved += 1  # a hang: the no-request-ever-hangs invariant broke
                continue
            except Exception:  # noqa: BLE001 — a typed engine failure (injected or real)
                stats[cls]["failed"] += 1
                continue
            stats[cls]["completed"] += 1
            latencies[cls].append(done_at.get(i, time.perf_counter()) - due)
    finally:
        batcher.stop()
    wall = time.perf_counter() - t_start
    s1 = reg.snapshot()

    def delta(key):
        return s1.get(key, 0) - s0.get(key, 0)

    completed = sum(s["completed"] for s in stats.values())
    late.sort()
    out = {
        "requests": n_requests, "target_qps": target_qps, "wall_s": wall,
        "offered_qps": n_requests / (t_last - t_start) if t_last > t_start else None,
        "qps": completed / wall if wall else None,
        "lateness_ms": {"p50": percentile(late, 0.5) * 1e3, "p99": percentile(late, 0.99) * 1e3,
                        "max": late[-1] * 1e3 if late else 0.0},
        "unresolved": unresolved,
        "retries": delta("serve.retries"), "injected_failures": delta("serve.faults.failures"),
        "injected_delays": delta("serve.faults.delays"), "breaker_opens": delta("serve.breaker_opens"),
        "rejected_total": delta("serve.rejected"), "shed_deadline": delta("serve.shed_deadline"),
        "classes": {},
    }
    every = sorted(v for c in classes for v in latencies[c])
    for cls in ("all",) + classes:
        lat = every if cls == "all" else sorted(latencies[cls])
        counts = ({k: sum(stats[c][k] for c in classes) for k in stats[classes[0]]} if cls == "all"
                  else dict(stats[cls]))
        row = {**counts, "samples": len(lat), "p50_ms": percentile(lat, 0.50) * 1e3,
               "p99_ms": percentile(lat, 0.99) * 1e3}
        if cls != "all":
            row["registry_quantiles"] = _hist_delta_quantiles(f"serve.latency_seconds.{cls}", lat_counts0[cls])
        out["classes"][cls] = row
    return out


def _chaos_ab(engine, make_batcher, image_sizes, t1_s, rates, *, seed, n_requests, fault_rate):
    """At each rate, a healthy and a fault-injected open-loop round on one
    arrival schedule (seeded failures at the completion edge and latency
    spikes of 3 x the bucket-1 p50, each at ``fault_rate`` a row)."""
    deadline_ms_by_class = {"interactive": max(50.0, 40 * t1_s * 1e3), "batch": max(500.0, 200 * t1_s * 1e3)}
    fault_kwargs = {"seed": seed, "failure_rate": fault_rate, "fail_at": "result", "latency_s": 3 * t1_s,
                    "latency_rate": fault_rate}
    common = dict(seed=seed, n_requests=n_requests, deadline_ms_by_class=deadline_ms_by_class)
    return {
        "requests": n_requests, "seed": seed, "class_mix": CHAOS_CLASS_MIX, "deadline_ms": deadline_ms_by_class,
        "fault": {"failure_rate": fault_rate, "latency_ms": 3 * t1_s * 1e3, "latency_rate": fault_rate,
                  "fail_at": "result"},
        "rounds": [{"target_qps": q, "load": load,
                    "healthy": _chaos_round(engine, make_batcher, image_sizes, target_qps=q, **common),
                    "faulty": _chaos_round(engine, make_batcher, image_sizes, target_qps=q,
                                           fault_kwargs=fault_kwargs, **common)}
                   for q, load in rates],
    }


def _model(arch: str, image_size: int):
    """(net, params, state): seeded weights and seeded BN statistics (a
    fold of fresh statistics would collapse random-init logits)."""
    from ..config import ModelConfig
    from ..models import get_model
    from ..models.specs import random_bn_state

    if arch == "tiny":  # the tests' preset: two blocks, one of them two branches
        mc = ModelConfig(arch="mobilenet_v2", num_classes=16, dropout=0.0,
                         block_specs=[{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5]}, {"t": 2, "c": 16, "n": 1, "s": 2}])
    else:
        mc = ModelConfig(arch=arch)
    net = get_model(mc, image_size)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    return net, params, random_bn_state(net, gen)


def _k1_count(engines) -> dict:
    """K1's launches as the engines count them: replays x the launches each
    graph captured, and the wrapper's count of the eager warm runs and
    captures (``fused_depthwise.launches``)."""
    from ..ops.fused_depthwise import fused_depthwise

    replayed = sum(g["replays"] * g["k1_launches"] for e in engines for g in e.graph_report())
    return {"replayed": replayed, "warm_and_captures": fused_depthwise.launches,
            "total": replayed + fused_depthwise.launches,
            "per_forward": next((g["k1_launches"] for e in engines for g in e.graph_report()
                                 if g["kind"] == "k" and g["key"][2] == 1), None)}


def measure(args, dev: torch.device) -> dict:
    from ..config import DataConfig
    from ..ops.fused_depthwise import fused_depthwise
    from ..serve.engine import InferenceEngine
    from ..serve.export import InferenceBundle, fold_network

    arms = set(args.arms) | {"direct", "concurrent"}
    image_sizes = tuple(args.image_sizes)
    buckets = tuple(args.buckets)
    base = image_sizes[0]
    net, params, state = _model(args.arch, base)
    bundle = InferenceBundle(net=net, params=fold_network(net, params, state), meta={})
    engines: list = []
    fused_depthwise.launches = 0

    def make_engine(dtype, fuse=(), overlap=False, staging_slots=2, ring_slots=0):
        e = InferenceEngine(bundle, buckets=buckets, compute_dtype=dtype, image_size=base, image_sizes=image_sizes,
                            fuse_ladder=fuse, overlap_staging=overlap, staging_slots=staging_slots,
                            ring_slots=ring_slots, device=dev)
        engines.append(e)
        return e

    engine = make_engine("float32")
    t0 = time.perf_counter()
    engine.warmup()
    out: dict = {"arch": args.arch, "image_sizes": list(image_sizes), "buckets": list(buckets),
                 "warmup_capture_s": time.perf_counter() - t0, "arms": [a for a in ARMS if a in arms]}
    rng = np.random.RandomState(0)
    direct = [_direct_row(engine, b, s, args.iters, rng) for s in engine.image_sizes for b in engine.buckets]
    concurrent = [_concurrent_row(engine, b, s, args.concurrent_iters, args.max_inflight, args.rounds, rng)
                  for s in engine.image_sizes for b in engine.buckets]
    peak_closed = max(max(r["qps_sync"], r["qps_pipelined"]) for r in concurrent)
    out.update(direct=direct, concurrent=concurrent, peak_closed_loop_qps=peak_closed,
               peak_qps=max([peak_closed] + [r["qps"] for r in direct]))
    ab: dict = {}
    if "bf16" in arms:
        bf16 = make_engine("bfloat16")
        bf16.warmup()
        rows = [_direct_row(bf16, b, base, args.ab_iters, rng) for b in bf16.buckets]
        xp = rng.normal(0, 1, (buckets[-1], base, base, 3)).astype("float32")
        ref = engine.predict(xp)
        delta = float(np.max(np.abs(bf16.predict(xp) - ref)))
        fp32 = {r["batch"]: r["qps"] for r in direct if r["image_size"] == base}
        ab["bf16_vs_fp32"] = {
            "buckets": [{"batch": r["batch"], "qps_bf16": r["qps"], "qps_fp32": fp32[r["batch"]],
                         "p50_ms_bf16": r["p50_ms"], "p99_ms_bf16": r["p99_ms"]} for r in rows],
            "peak_qps_fp32": max(fp32.values()), "peak_qps_bf16": max(r["qps"] for r in rows),
            "max_abs_logit_delta": delta, "mean_abs_logit": float(np.mean(np.abs(ref))),
            "parity_atol": BF16_PARITY_ATOL, "parity_ok": delta <= BF16_PARITY_ATOL,
        }
    if "fused" in arms:
        eng_fused = make_engine("float32", fuse=tuple(args.fuse_ladder))
        eng_fused.warmup()
        ab["fused_vs_chained"] = _fused_ab(engine, eng_fused, base, args.fused_iters, rng)
    if "structural" in arms:
        ab["structural_sweep"] = _structural_sweep(
            make_engine, base, rounds=max(1, args.structural_rounds), conc_iters=args.concurrent_iters,
            max_inflight=args.max_inflight, staging_slots=2, run_max=4, fuse_ladder=tuple(args.fuse_ladder), rng=rng)
    if "quant" in arms:
        dc = DataConfig()
        ab["quant"] = _quant_ab(net, params, state, buckets, base, max(1, args.quant_iters), max(1, args.quant_rounds),
                                rng, mean=dc.mean, std=dc.std, top1_min=args.quant_top1_min, device=dev,
                                engines_out=engines)
    out["ab"] = ab
    if "chaos" in arms:
        shipped, make_batcher, scfg = _shipped_stack(bundle, base, image_sizes, buckets, args.fuse_ladder, dev,
                                                     engines)
        peak = _closed_loop_peak(shipped, make_batcher, base, scfg.max_batch, args.rounds, args.concurrent_iters, rng)
        t1_s = next(r["p50_ms"] for r in direct if r["batch"] == buckets[0] and r["image_size"] == base) / 1e3
        rates = ([(q, None) for q in args.chaos_qps] if args.chaos_qps
                 else [(f * peak["qps"], f) for f in args.chaos_load])
        out["chaos"] = {"stack": {"max_batch": scfg.max_batch, "max_wait_ms": scfg.max_wait_ms,
                                  "max_inflight": scfg.max_inflight, "fuse_ladder": list(scfg.fuse_chunks.ladder),
                                  "overlap": scfg.overlap.enable, "run_max": scfg.overlap.run_max},
                        "closed_loop_peak": peak,
                        **_chaos_ab(shipped, make_batcher, list(shipped.image_sizes), t1_s, rates,
                                    seed=args.chaos_seed, n_requests=args.chaos_requests,
                                    fault_rate=args.chaos_fault_rate)}
    out["k1_launches"] = _k1_count(engines)
    snap = get_registry().snapshot()
    out["registry_quantiles"] = {
        k[: -len(".count")]: {"count": snap[k], **{q: snap.get(f"{k[:-len('.count')]}.{q}", 0.0)
                                                   for q in ("p50", "p95", "p99")}}
        for k in snap if k.startswith("serve.") and k.endswith(".count") and snap[k] > 0}
    out["value"] = out["peak_qps"]
    return out


# ---------------------------------------------------------------------------
# the fleet arms: replica processes of cli/serve.py behind the router
# ---------------------------------------------------------------------------


class _StderrLog:
    """The supervisor's progress goes to stderr: stdout holds the one line."""

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)


def _open_loop(submit, items, *, target_qps, seed, mid_hook=None, mid_at=None, result_timeout_s=120.0):
    """One open-loop Poisson round: request ``i`` submits ``items[i]`` when
    it is due, whatever the completions; every future is resolved at the
    end (a hang shows as ``unresolved``). ``mid_hook`` fires once before
    request ``mid_at`` (the kill -9). Latency is stamped when a future
    resolves. Returns the tally and the answers, indexed."""
    from concurrent.futures import TimeoutError as FutTimeout

    from ..serve.client import ClientHTTPError

    n = len(items)
    gaps = np.random.RandomState(seed).exponential(1.0 / target_qps, size=n)
    pending, lat, lat_lock = [], {}, threading.Lock()

    def stamp(i, t0):
        def cb(fut):
            if fut.exception() is None:
                with lat_lock:
                    lat[i] = time.perf_counter() - t0
        return cb

    t_start = time.perf_counter()
    t_next = t_start
    for i in range(n):
        t_next += gaps[i]
        delay = t_next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if mid_hook is not None and i == mid_at:
            mid_hook()
            mid_hook = None
        t0 = time.perf_counter()
        fut = submit(items[i])
        fut.add_done_callback(stamp(i, t0))
        pending.append(fut)
    out = {"submitted": n, "completed": 0, "rejected": 0, "failed": 0, "unresolved": 0}
    answers = [None] * n
    for i, fut in enumerate(pending):
        try:
            answers[i] = np.asarray(fut.result(timeout=result_timeout_s))
            out["completed"] += 1
        except FutTimeout:
            out["unresolved"] += 1
        except ClientHTTPError as e:
            out["rejected" if e.status < 500 else "failed"] += 1
        except Exception:  # noqa: BLE001 — a typed route failure
            out["failed"] += 1
    wall = time.perf_counter() - t_start
    ordered = sorted(lat.values())
    out.update(wall_s=wall, qps=out["completed"] / wall if wall else 0.0,
               p50_ms=percentile(ordered, 0.50) * 1e3, p99_ms=percentile(ordered, 0.99) * 1e3)
    return out, answers, lat


def _registry_delta(reg, s0, keys):
    s1 = reg.snapshot()
    return {k.split(".", 1)[1]: int(s1.get(k, 0) - s0.get(k, 0)) for k in keys}


_FLEET_AB_KEYS = ("serve.hedges", "serve.hedge_wins", "serve.hedge_wasted", "fleet.routed", "fleet.route_retries")
_FLEET_KILL_KEYS = ("fleet.route_retries", "fleet.ejections", "fleet.readmissions", "fleet.restarts",
                    "fleet.chaos_kills", "serve.hedges")


def _replica_argv(dev: torch.device, image_size: int, buckets, *extra: str) -> list[str]:
    return [f"data.image_size={image_size}", f"serve.buckets=[{','.join(str(b) for b in buckets)}]",
            "serve.drain_timeout_s=10", *extra, "--device", dev.type]


def measure_fleet(args, dev: torch.device, log_root: str) -> dict:
    """The ``--fleet`` arm (the JAX bench's ``measure_fleet``): hedged
    against unhedged with one straggler, the federation's p99 against the
    pooled reference, kill -9 availability, the autoscaler's diurnal trace."""
    from ..cli.fleet import FleetSupervisor
    from ..obs.fleet import FleetFederation, FlightRecorder
    from ..serve.autoscale import Autoscaler
    from ..serve.export import export_bundle
    from ..serve.hedge import Hedger
    from ..serve.router import Router
    from ..serve.signals import SLOTracker

    reg = get_registry()
    replicas, requests, seed = FLEET_REPLICAS, max(10, args.fleet_requests), FLEET_SEED
    straggler_ms, size = STRAGGLER_MS, args.image_sizes[0]
    net, params, state = _model(args.arch, size)
    bundle_dir = export_bundle(net, params, state, os.path.join(log_root, "bundle"), device=dev)
    replica_argv = _replica_argv(dev, size, args.buckets, f"serve.bundle={bundle_dir}", "serve.max_wait_ms=2.0")
    straggler_slot = replicas - 1
    per_slot = {straggler_slot: ["serve.faults.enable=true", f"serve.faults.latency_ms={straggler_ms}",
                                 f"serve.faults.latency_rate={STRAGGLER_RATE}", "serve.faults.fail_at=result",
                                 f"serve.faults.seed={seed + 7}"]}
    router = Router(poll_interval_s=0.25, eject_failures=2, route_attempts=3, client_timeout_s=60.0,
                    seed=seed).start()
    recorder = FlightRecorder(log_root, min_interval_s=0.0)
    router.set_event_sink(recorder.record)
    federation = FleetFederation(router.backends, slo=SLOTracker(), recorder=recorder)
    fleet = FleetSupervisor(replica_argv=replica_argv, log_dir=log_root, replicas=replicas, per_slot_argv=per_slot,
                            spawn_timeout_s=300.0, drain_timeout_s=30.0, on_change=router.set_backends,
                            logger=_StderrLog())
    image = np.random.RandomState(seed).normal(0, 1, (size, size, 3)).astype("float32")
    out = {"arch": args.arch, "replicas": replicas, "image_size": size, "seed": seed,
           "straggler": {"slot": straggler_slot, "latency_ms": straggler_ms, "latency_rate": STRAGGLER_RATE}}

    def round_(n, qps, seed_, **kw):
        return _open_loop(lambda img: router.submit(img), [image] * n, target_qps=qps, seed=seed_, **kw)[0]

    try:
        t0 = time.perf_counter()
        fleet.start()
        out["spawn_s"] = time.perf_counter() - t0
        # warm and calibrate: the router's latency histogram (the hedge
        # timer's input) and the pacing p50
        hedger = Hedger(quantile=0.8, min_samples=20, min_timer_ms=10.0)
        warm = []
        for _ in range(40):
            t1 = time.perf_counter()
            router.submit(image).result(timeout=60)
            warm.append(time.perf_counter() - t1)
        warm.sort()
        p50_s = max(percentile(warm, 0.5), 1e-3)
        target_qps = max(2.0, FLEET_LOAD / p50_s)
        out.update(warm_p50_ms=p50_s * 1e3, target_qps=target_qps)
        timer_s = hedger.timer_s("interactive")
        out["hedge_timer_ms"] = timer_s * 1e3 if timer_s is not None else None

        # 1. hedged against unhedged on one seeded schedule
        ab = {}
        for mode, h in (("unhedged", None), ("hedged", hedger)):
            router.set_hedger(h)
            s0 = reg.snapshot()
            rnd = round_(requests, target_qps, seed)
            time.sleep(2.5 * straggler_ms / 1e3)  # the hedge losers' late answers land first
            rnd.update(_registry_delta(reg, s0, _FLEET_AB_KEYS))
            ab[mode] = rnd
        router.set_hedger(None)
        ab["hedged_tail_speedup"] = (ab["unhedged"]["p99_ms"] / ab["hedged"]["p99_ms"]
                                     if ab["hedged"]["p99_ms"] else None)
        out["hedge_ab"] = ab

        # 1b. the federated windowed p99 equals the pooled per-replica one
        # recomputed from the same scraped documents
        federation.scrape_once()
        docs0 = federation.last_varz()
        obs_rnd = round_(max(30, requests // 2), target_qps, seed + 11)
        federation.scrape_once()
        docs1 = federation.last_varz()
        fam = "serve.latency_seconds.interactive"
        pooled, bounds = None, None
        for key, doc in docs1.items():
            st = (doc.get("histograms") or {}).get(fam)
            if st is None:
                continue
            cur = [int(c) for c in st["counts"]]
            prev_st = ((docs0.get(key) or {}).get("histograms") or {}).get(fam)
            prev = [int(c) for c in prev_st["counts"]] if prev_st else None
            delta = cur if prev is None or len(prev) != len(cur) else [c - p for c, p in zip(cur, prev)]
            if any(d < 0 for d in delta):
                delta = cur  # a restarted replica: its whole history is the delta
            bounds = st["bounds"]
            pooled = delta if pooled is None else [a + d for a, d in zip(pooled, delta)]
        pooled_p99_s = quantiles_from_counts(bounds, pooled, (0.99,))[0] if pooled and sum(pooled) else 0.0
        fed_p99_s = reg.gauge("fleet.window_p99_seconds.interactive").value
        if abs(fed_p99_s - pooled_p99_s) > 1e-9:
            raise AssertionError(f"federated p99 {fed_p99_s} != pooled reference {pooled_p99_s}")
        out["obs"] = {"round": obs_rnd, "federated_p99_ms": fed_p99_s * 1e3, "pooled_p99_ms": pooled_p99_s * 1e3,
                      "p99_match": True, "federated_replicas": len(docs1), "slo": federation.snapshot().get("slo")}

        # 2. kill -9 a serving replica mid-round
        s0 = reg.snapshot()

        def chaos_kill():
            recorder.trigger("chaos_kill")
            fleet.kill_replica(slot=0, sig=signal.SIGKILL)

        kill = round_(requests, target_qps, seed + 1, mid_at=requests // 3, mid_hook=chaos_kill)
        deadline = time.monotonic() + 300
        while len(fleet.addresses()) < replicas and time.monotonic() < deadline:
            time.sleep(0.25)
        kill.update(_registry_delta(reg, s0, _FLEET_KILL_KEYS))
        kill["replicas_after_restart"] = len(fleet.addresses())
        out["kill"] = kill
        federation.scrape_once()
        incident = recorder.maybe_dump(federation)
        out["obs"]["incident"] = os.path.basename(incident) if incident else None

        # 3. the autoscaler over a low/high/low schedule from one replica
        fleet.scale_to(1)
        router.poll_once()
        ab_p50_ms = max(ab["unhedged"]["p50_ms"], 1.0)
        low_s, high_s, trough_s = args.fleet_phase_s
        autoscaler = Autoscaler(fleet, router, min_replicas=1, max_replicas=min(replicas + 1, 3), interval_s=0.4,
                                cooldown_s=1.5, up_p99_ms=max(6.0 * ab_p50_ms, 30.0),
                                down_p99_ms=max(2.5 * ab_p50_ms, 12.0), up_queue_depth=2.0,
                                down_queue_depth=1.0).start()
        phases = [(0.4 * target_qps, low_s), (12.0 * target_qps, high_s), (0.4 * target_qps, trough_s)]
        diurnal = []
        for i, (qps, dur) in enumerate(phases):
            rnd = round_(max(4, int(qps * dur)), qps, seed + 2 + i)
            diurnal.append({"phase": ("low", "high", "trough")[i], "target_qps": qps, **rnd})
        settle_until = time.monotonic() + 3 * autoscaler._cooldown_s
        while time.monotonic() < settle_until:
            time.sleep(0.3)
        autoscaler.stop()
        trace = autoscaler.trace
        ns = [r["n"] for r in trace]
        action_ts = [r["t"] for r in trace if r["action"] != "hold"]
        out["autoscale"] = {
            "min_replicas": autoscaler.min_replicas, "max_replicas": autoscaler.max_replicas,
            "cooldown_s": autoscaler._cooldown_s, "phases": diurnal, "trace": trace,
            "n_start": ns[0] if ns else None, "n_peak": max(ns) if ns else None, "n_end": ns[-1] if ns else None,
            "actions": [r for r in trace if r["action"] != "hold"],
            "cooldown_respected": all(b - a >= 0.9 * autoscaler._cooldown_s for a, b in zip(action_ts, action_ts[1:])),
        }
        return out
    finally:
        router.stop()
        fleet.stop()


def _scrape(router, fn):
    return {key: fn(((client.varz(timeout_s=10.0)[1] or {}).get("metrics") or {}))
            for key, client in router.backends()}


def _zoo_models(arch: str, size: int):
    """(small, big) as (net, params, state): the JAX bench's tiny presets for
    ``--arch tiny``, else MobileNetV3-Small 1.0 and ``arch`` at full width."""
    from ..config import ModelConfig
    from ..models import get_model
    from ..models.specs import random_bn_state

    if arch == "tiny":
        mcs = (ModelConfig(arch="mobilenet_v2", num_classes=16, dropout=0.0,
                           block_specs=[{"t": 2, "c": 8, "n": 1, "s": 2}, {"t": 2, "c": 16, "n": 1, "s": 2}]),
               ModelConfig(arch="mobilenet_v2", num_classes=16, dropout=0.0,
                           block_specs=[{"t": 4, "c": 24, "n": 2, "s": 2}, {"t": 4, "c": 48, "n": 2, "s": 2},
                                        {"t": 4, "c": 96, "n": 1, "s": 1}]))
    else:
        mcs = (ModelConfig(arch="mobilenet_v3_small"), ModelConfig(arch=arch))
    out = []
    for i, mc in enumerate(mcs):
        net = get_model(mc, size)
        gen = torch.Generator().manual_seed(i)
        params, _ = net.init(gen)
        out.append((net, params, random_bn_state(net, gen)))
    return out


def measure_zoo(args, dev: torch.device, log_root: str) -> dict:
    """The ``--zoo`` arm (the JAX bench's ``measure_zoo``): one fleet placed
    ``small;big``, three arms on one trace, the cascade at the median
    small-model margin of a calibration set that the trace does not hold:
    the trace's escalation rate, and so the FLOPs ratio, is measured."""
    from ..cli.fleet import FleetSupervisor
    from ..serve.cascade import CascadeTier, softmax_margin
    from ..serve.export import export_bundle
    from ..serve.router import Router

    reg = get_registry()
    size, seed, requests = args.image_sizes[0], FLEET_SEED, max(12, args.zoo_requests)
    rng = np.random.RandomState(seed)
    (small_net, sp, ss), (big_net, bp, bs) = _zoo_models(args.arch, size)
    calib = rng.normal(0, 1, (8, size, size, 3)).astype("float32")
    small_dir = export_bundle(small_net, sp, ss, os.path.join(log_root, "small"), model_name="small",
                              quant_weights="int8", calib_images=calib, int8_top1_min=ZOO_INT8_TOP1_MIN,
                              device=dev)
    big_dir = export_bundle(big_net, bp, bs, os.path.join(log_root, "big"), model_name="big", device=dev)
    metas = {}
    for name, d in (("small", small_dir), ("big", big_dir)):
        with open(os.path.join(d, "meta.json")) as f:
            metas[name] = json.load(f)
    # bucket 1 everywhere: every arm's answers compare bit for bit
    base_argv = _replica_argv(dev, size, (1,), "serve.max_wait_ms=1.0")
    per_slot = {0: [f"serve.zoo.models=small={small_dir}", "serve.zoo.default=small"],
                1: [f"serve.zoo.models=big={big_dir}", "serve.zoo.default=big"]}
    adverts = {0: {"small": metas["small"]["digest"]}, 1: {"big": metas["big"]["digest"]}}
    router = Router(poll_interval_s=0.25, eject_failures=2, route_attempts=3, client_timeout_s=60.0,
                    seed=seed).start()
    fleet_ref: dict = {}

    def on_change(addrs):
        # membership and placement ride every supervisor notification
        router.set_backends(addrs)
        fleet = fleet_ref.get("fleet")
        if fleet is not None:
            router.set_backend_models({f"{r['addr']['host']}:{r['addr']['port']}": adverts[r["slot"] % 2]
                                       for r in fleet.replicas() if r["addr"] is not None})

    fleet = FleetSupervisor(replica_argv=base_argv, log_dir=log_root, replicas=2, per_slot_argv=per_slot,
                            spawn_timeout_s=300.0, drain_timeout_s=30.0, on_change=on_change, logger=_StderrLog())
    fleet_ref["fleet"] = fleet
    out = {"replicas": 2, "image_size": size, "seed": seed, "requests": requests,
           "models": {"small": {"arch": "tiny_small" if args.arch == "tiny" else "mobilenet_v3_small",
                                "weights": "int8", "digest": metas["small"]["digest"],
                                "int8_top1": (metas["small"].get("quant") or {}).get("top1_agreement"),
                                "flops_per_image": obs_device.forward_cost(small_net, size)["flops"]},
                      "big": {"arch": args.arch, "weights": "float32", "digest": metas["big"]["digest"],
                              "flops_per_image": obs_device.forward_cost(big_net, size)["flops"]}}}
    try:
        t0 = time.perf_counter()
        fleet.start()
        out["spawn_s"] = time.perf_counter() - t0
        slot_addr = {r["slot"]: r["addr"] for r in fleet.replicas() if r["addr"] is not None}
        small_key, big_key = (f"{slot_addr[i]['host']}:{slot_addr[i]['port']}" for i in (0, 1))
        out["placement"] = {small_key: ["small"], big_key: ["big"]}
        images = [rng.normal(0, 1, (size, size, 3)).astype("float32") for _ in range(requests)]
        # the threshold: the median small-model margin of a calibration set
        # drawn apart from the trace
        calib_rs = np.random.RandomState(seed + 9)
        calib_margins = [softmax_margin(router.submit(calib_rs.normal(0, 1, (size, size, 3)).astype("float32"),
                                                      model="small").result(timeout=120))
                         for _ in range(ZOO_CALIB_IMAGES)]
        threshold = float(np.median(calib_margins))
        # the reference pass: both models answer every image when pinned
        refs_small, refs_big, margins, warm = [], [], [], []
        for img in images:
            t1 = time.perf_counter()
            r = router.submit(img, model="small").result(timeout=120)
            warm.append(time.perf_counter() - t1)
            refs_small.append(np.asarray(r))
            margins.append(softmax_margin(r))
        for img in images:
            refs_big.append(np.asarray(router.submit(img, model="big").result(timeout=120)))
        out["threshold"] = threshold
        out["calib_images"] = ZOO_CALIB_IMAGES
        out["margins"] = {"lowest": float(np.min(margins)), "median": float(np.median(margins)),
                          "highest": float(np.max(margins)),
                          "below_threshold": int(sum(m < threshold for m in margins))}
        warm.sort()
        target_qps = max(2.0, FLEET_LOAD / max(percentile(warm, 0.5), 1e-3))
        out["target_qps"] = target_qps

        def flops():
            return sum(_scrape(router, lambda m: float(m.get("serve.dispatched_flops", 0))).values())

        def run_arm(submit, models, seed_):
            f0 = flops()
            rnd, ans, lat = _open_loop(lambda item: submit(images[item[0]], item[1]), list(enumerate(models)),
                                       target_qps=target_qps, seed=seed_)
            rnd["flops_per_request"] = (flops() - f0) / max(rnd["completed"], 1)
            by_model: dict = {}
            for i, m in enumerate(models):
                if i in lat:
                    by_model.setdefault(m or "cascade", []).append(lat[i])
            rnd["per_model"] = {m: {"n": len(v), "p50_ms": percentile(sorted(v), 0.5) * 1e3,
                                    "p99_ms": percentile(sorted(v), 0.99) * 1e3} for m, v in sorted(by_model.items())}
            return rnd, ans

        arms = {}
        rnd, ans = run_arm(lambda img, m: router.submit(img, model=m), ["big"] * requests, seed + 2)
        rnd["bitwise_match_big"] = all(a is not None and np.array_equal(a, refs_big[i]) for i, a in enumerate(ans))
        arms["big_only"] = rnd

        mix_rs = np.random.RandomState(seed + 3)
        mix = ["small" if mix_rs.rand() < 0.5 else "big" for _ in range(requests)]
        mix[0], mix[1] = "small", "big"

        def model_requests():
            return _scrape(router, lambda m: {k: int(m.get(f"serve.model_requests.{k}", 0)) for k in ("small", "big")})

        mr0 = model_requests()
        rnd, ans = run_arm(lambda img, m: router.submit(img, model=m), mix, seed + 4)
        mr1 = model_requests()
        rnd["mix"] = {"small": mix.count("small"), "big": mix.count("big")}
        rnd["misroutes"] = (mr1[small_key]["big"] - mr0[small_key]["big"]
                            + mr1[big_key]["small"] - mr0[big_key]["small"])
        rnd["bitwise_match"] = all(a is not None and np.array_equal(a, (refs_small if mix[i] == "small"
                                                                         else refs_big)[i]) for i, a in enumerate(ans))
        arms["sharded"] = rnd
        if rnd["misroutes"] or rnd["failed"] or rnd["unresolved"]:
            raise AssertionError(f"sharded arm broke placement: {rnd}")

        tier = CascadeTier(router, small="small", big="big", threshold=threshold)
        s0 = reg.snapshot()
        rnd, ans = run_arm(lambda img, _m: tier.submit(img), [None] * requests, seed + 5)
        s1 = reg.snapshot()
        for key in ("escalations", "answered_small", "deadline_skips", "escalation_failures"):
            rnd[key] = int(s1.get(f"serve.cascade.{key}", 0) - s0.get(f"serve.cascade.{key}", 0))
        decided = rnd["escalations"] + rnd["answered_small"]
        rnd["escalation_rate"] = rnd["escalations"] / decided if decided else 0.0
        small_hits = sum(1 for i, a in enumerate(ans) if a is not None and np.array_equal(a, refs_small[i]))
        big_hits = sum(1 for i, a in enumerate(ans) if a is not None and not np.array_equal(a, refs_small[i])
                       and np.array_equal(a, refs_big[i]))
        rnd.update(answers_small_bitwise=small_hits, answers_big_bitwise=big_hits,
                   answer_mismatches=rnd["completed"] - small_hits - big_hits)
        arms["cascade"] = rnd
        if rnd["escalations"] <= 0 or rnd["answered_small"] <= 0 or rnd["answer_mismatches"]:
            raise AssertionError(f"cascade arm: {rnd}")
        out["arms"] = arms
        big_fpr = arms["big_only"]["flops_per_request"]
        ratio = arms["cascade"]["flops_per_request"] / big_fpr if big_fpr else None
        out["cost"] = {"big_only_flops_per_request": big_fpr,
                       "sharded_flops_per_request": arms["sharded"]["flops_per_request"],
                       "cascade_flops_per_request": arms["cascade"]["flops_per_request"],
                       "cascade_vs_big_only": ratio}
        if ratio is None or ratio >= 1.0:
            raise AssertionError(f"cascade FLOPs per request did not beat big-only: ratio={ratio}")
        if any(a["unresolved"] for a in arms.values()):
            raise AssertionError("a zoo arm left futures unresolved")
        return out
    finally:
        router.stop()
        fleet.stop()


# ---------------------------------------------------------------------------
# the overload and partition arms (the JAX bench's measure_overload and
# measure_partition)
# ---------------------------------------------------------------------------


def _overload_round(admission, images, *, seed, n_requests, target_qps, deadline_ms_by_class, level_fn=None):
    """One open-loop Poisson storm through an admission controller: the
    arrivals and classes are drawn from ``seed`` and fire on schedule
    whatever the completions, every future is resolved at the end (a hang is
    ``unresolved``), and each class's books balance. Latency is stamped when
    a future resolves. ``interactive_fates`` counts each interactive
    request's fate by the ladder's level at its arrival (``level_fn``, 0
    without a ladder): ``completed``, ``rejected:<cause>`` at the door or
    ``shed:<cause>`` after it was queued."""
    from concurrent.futures import TimeoutError as FutTimeout

    from ..serve.batcher import DeadlineExceeded, DrainTimeout

    rs = np.random.RandomState(seed)
    classes, probs = zip(*sorted(OVERLOAD_CLASS_MIX.items()))
    draws_cls = [classes[i] for i in rs.choice(len(classes), size=n_requests, p=probs)]
    gaps = rs.exponential(1.0 / target_qps, size=n_requests)
    stats = {c: {"submitted": 0, "completed": 0, "rejected": 0, "shed": 0, "failed": 0} for c in classes}
    lat: dict = {c: [] for c in classes}
    lat_lock = threading.Lock()
    fates: dict = {}
    pending = []
    t_start = time.perf_counter()
    t_next = t_start
    for i in range(n_requests):
        t_next += gaps[i]
        delay = t_next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        cls = draws_cls[i]
        stats[cls]["submitted"] += 1
        level = level_fn() if level_fn is not None else 0
        t0 = time.perf_counter()
        try:
            fut = admission.submit(images[cls], priority=cls, deadline_ms=deadline_ms_by_class.get(cls))
        except Exception as e:  # noqa: BLE001 — a typed arrival rejection (quota, brownout, deadline)
            stats[cls]["rejected"] += 1
            if cls == "interactive":
                key = f"rejected:{type(e).__name__} at L{level}"
                fates[key] = fates.get(key, 0) + 1
            continue

        def stamp(fut, cls=cls, t0=t0):
            if fut.exception() is None:
                with lat_lock:
                    lat[cls].append(time.perf_counter() - t0)

        fut.add_done_callback(stamp)
        pending.append((cls, fut, level))
    unresolved = 0
    for cls, fut, level in pending:
        fate = "completed"
        try:
            fut.result(timeout=300)
            stats[cls]["completed"] += 1
        except (DeadlineExceeded, DrainTimeout) as e:
            stats[cls]["shed"] += 1
            fate = f"shed:{type(e).__name__}"
        except FutTimeout:
            unresolved += 1
            fate = "unresolved"
        except Exception as e:  # noqa: BLE001 — a typed rejection or an engine failure
            stats[cls]["failed"] += 1
            fate = f"failed:{type(e).__name__}"
        if cls == "interactive":
            key = f"{fate} at L{level}"
            fates[key] = fates.get(key, 0) + 1
    out = {"wall_s": time.perf_counter() - t_start, "unresolved": unresolved, "classes": {},
           "interactive_fates": dict(sorted(fates.items()))}
    for cls in classes:
        s, ls = stats[cls], sorted(lat[cls])
        out["classes"][cls] = {**s, "availability": s["completed"] / s["submitted"] if s["submitted"] else None,
                               "p50_ms": percentile(ls, 0.50) * 1e3, "p99_ms": percentile(ls, 0.99) * 1e3}
    return out


def measure_overload(args, dev: torch.device, log_root: str) -> dict:
    """The ``--overload`` arm (the JAX bench's ``measure_overload``), two
    halves:

    1. the brownout A/B, in this process: a closed-loop calibration of the
       stack's capacity, then ONE seeded open-loop Poisson storm at
       ``--overload-multiple`` x that capacity, played twice through fresh
       ``PipelinedBatcher`` + ``AdmissionController`` stacks, the brownout
       ladder (``serve/brownout.py``) off and then on. The engine is paced
       by ``serve/faults.py``'s ``FaultyEngine`` at ``--overload-pace-ms``
       per dispatch, so that the capacity, and so the storm, is the same on
       any host. Interactive availability per arm, the ladder's trace, its
       recovery to L0;
    2. the gray-failure round: replica processes of the port's
       ``cli/serve.py`` behind ``serve/router.py``, the last slot slowed by
       ``--overload-straggler-ms`` at every dispatch (slow, never failing).
       Slow ejection is armed a third of the way in, so the time to eject
       has a known zero; the latencies, split at the ejection by submit
       time, give the p99 before and after.
    """
    from concurrent.futures import TimeoutError as FutTimeout

    from ..cli.fleet import FleetSupervisor
    from ..serve.admission import AdmissionController
    from ..serve.brownout import BrownoutController
    from ..serve.engine import InferenceEngine
    from ..serve.export import InferenceBundle, export_bundle, fold_network
    from ..serve.faults import FaultyEngine
    from ..serve.pipeline import PipelinedBatcher
    from ..serve.router import Router
    from ..serve.signals import SignalReader

    from ..ops.fused_depthwise import fused_depthwise

    reg = get_registry()
    fused_depthwise.launches = 0
    seed, size, buckets = args.overload_seed, args.image_sizes[0], tuple(args.buckets)
    storm_s, multiple = max(1.0, args.overload_storm_s), max(1.5, args.overload_multiple)
    pace_ms, replicas = max(1.0, args.overload_pace_ms), max(2, args.overload_replicas)
    gray_requests, straggler_ms = max(20, args.overload_gray_requests), args.overload_straggler_ms
    net, params, state = _model(args.arch, size)
    bundle = InferenceBundle(net=net, params=fold_network(net, params, state), meta={})
    # F13 (ROADMAP queue 3): a CPU rehearsal shares its host with other work. On one
    # torch thread the tiny engine's forward stays well under the pace, so the paced
    # dispatch, not the host's oversubscribed cores, sets the capacity that the
    # storm and the interactive deadline are calibrated on
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        engine = InferenceEngine(bundle, buckets=buckets, image_size=size, device=dev)
        engine.warmup()
        paced = FaultyEngine(engine, seed=seed, latency_s=pace_ms / 1e3, latency_rate=1.0)
        rng = np.random.RandomState(seed)
        images = {c: rng.normal(0, 1, (size, size, 3)).astype("float32") for c in OVERLOAD_CLASS_MIX}
        max_batch = max(buckets)
        out = {"arch": args.arch, "image_size": size, "seed": seed, "storm_s": storm_s, "pace_ms": pace_ms,
               "class_mix": dict(OVERLOAD_CLASS_MIX)}

        def stack():
            b = PipelinedBatcher(paced, max_batch=max_batch, max_wait_ms=5.0,
                                 queue_depth=OVERLOAD_QUEUE_BATCHES * max_batch, drain_timeout_s=60.0).start()
            return b, AdmissionController(b, max_retries=1, retry_backoff_ms=5.0, breaker_threshold=50,
                                          breaker_cooldown_s=0.5, seed=seed)

        # the capacity: closed-loop interactive clients, brownout off, each
        # sending OVERLOAD_CALIBRATION_ROUNDS requests one after the other, so
        # that the loop reaches its steady state at any largest bucket, timed
        # after one untimed request a client (a fresh stack's first dispatch is
        # cold: about 1 s on the CPU). The JAX bench times 48 requests over
        # max_batch clients from cold: at bucket 32, one request a client
        b, a = stack()
        warm_lat: list = []
        n_clients = max_batch

        def warm_client(n, timed):
            for _ in range(n):
                t0 = time.perf_counter()
                a.submit(images["interactive"], priority="interactive").result(timeout=60)
                if timed:
                    warm_lat.append(time.perf_counter() - t0)

        def closed_loop(n, timed):
            threads = [threading.Thread(target=warm_client, args=(n, timed), daemon=True) for _ in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        closed_loop(1, timed=False)
        t0 = time.perf_counter()
        closed_loop(OVERLOAD_CALIBRATION_ROUNDS, timed=True)
        warm_wall = time.perf_counter() - t0
        b.stop()
        warm_lat.sort()
        capacity_qps = len(warm_lat) / warm_wall if warm_wall > 0 else 1.0
        p50_ms = max(percentile(warm_lat, 0.5) * 1e3, 0.5)
        storm_qps = multiple * capacity_qps
        # the ladder needs seconds of overload to climb: the count follows the rate
        requests = max(40, int(storm_qps * storm_s))
        out["requests"] = requests
        # far above the healthy latency, far below what a sustained backlog gives
        deadlines = {"interactive": max(8.0 * p50_ms, 100.0)}
        out["capacity"] = {"closed_loop_qps": capacity_qps, "clients": n_clients, "warm_p50_ms": p50_ms,
                           "storm_qps": storm_qps, "multiple": multiple,
                           "interactive_deadline_ms": deadlines["interactive"]}

        # one seeded storm, brownout off and then on
        arms = {}
        for mode in ("off", "on"):
            b, a = stack()
            controller = None
            if mode == "on":
                controller = BrownoutController(
                    SignalReader(latency_family="serve.latency_seconds", signal_class="interactive",
                                 queue_depth_fn=a.queued_total),
                    (b, a), interval_s=0.1, up_p99_ms=max(4.0 * p50_ms, 40.0), down_p99_ms=max(1.5 * p50_ms, 10.0),
                    up_queue_depth=1.5 * max_batch, down_queue_depth=0.5 * max_batch, hold_up_s=0.3, cooldown_s=0.5,
                    retry_after_s=1.0, log_fn=lambda m: print(m, file=sys.stderr, flush=True)).start()
            s0 = reg.snapshot()
            rnd = _overload_round(a, images, seed=seed + 1, n_requests=requests, target_qps=storm_qps,
                                  deadline_ms_by_class=deadlines,
                                  level_fn=None if controller is None else (lambda c=controller: c.level))
            s1 = reg.snapshot()
            rnd["shed_at_door_brownout"] = int(s1.get("serve.rejected_brownout", 0) - s0.get("serve.rejected_brownout", 0))
            # every class's arrival rejections by cause (the counters carry no class)
            rnd["rejected_by_cause"] = {c: int(s1.get(f"serve.rejected_{c}", 0) - s0.get(f"serve.rejected_{c}", 0))
                                        for c in ("deadline", "class_full", "brownout", "breaker")}
            if controller is not None:
                # recovery: idle windows are relaxed, one level per cooldown
                settle_until = time.monotonic() + 6 * controller._cooldown_s + 2.0
                while controller.level > 0 and time.monotonic() < settle_until:
                    time.sleep(0.1)
                trace = controller.trace
                controller.stop()
                rnd["brownout"] = {
                    "peak_level": max((r["level"] for r in trace), default=0),
                    "final_level": trace[-1]["level"] if trace else None,
                    "recovered_to_l0": bool(trace and trace[-1]["level"] == 0),
                    "transitions_up": sum(1 for r in trace if r["action"] == "up"),
                    "transitions_down": sum(1 for r in trace if r["action"] == "down"),
                    "trace": trace}
            b.stop()
            arms[mode] = rnd
        out["storm"] = {"off": arms["off"], "on": arms["on"],
                        "interactive_availability_off": arms["off"]["classes"]["interactive"]["availability"],
                        "interactive_availability_on": arms["on"]["classes"]["interactive"]["availability"]}
    finally:
        torch.set_num_threads(threads)

    engines = [engine]

    # the gray failure: a slow, never failing replica
    bundle_dir = export_bundle(net, params, state, os.path.join(log_root, "bundle"), device=dev)
    replica_argv = _replica_argv(dev, size, buckets, f"serve.bundle={bundle_dir}", "serve.max_wait_ms=2.0")
    straggler_slot = replicas - 1
    per_slot = {straggler_slot: ["serve.faults.enable=true", f"serve.faults.latency_ms={straggler_ms}",
                                 "serve.faults.latency_rate=1.0", "serve.faults.fail_at=result",
                                 f"serve.faults.seed={seed + 7}"]}
    # slow ejection configured but off while warming: arming it mid-round
    # gives the time to eject a known zero
    router = Router(poll_interval_s=0.25, eject_failures=2, route_attempts=3, client_timeout_s=60.0, seed=seed,
                    slow_eject=False, slow_factor=3.0, slow_eject_after=3, slow_cooldown_s=60.0, slow_min_ms=1.0)
    fleet = FleetSupervisor(replica_argv=replica_argv, log_dir=log_root, replicas=replicas, per_slot_argv=per_slot,
                            spawn_timeout_s=300.0, drain_timeout_s=30.0, on_change=router.set_backends,
                            logger=_StderrLog())
    gray = {"replicas": replicas, "straggler": {"slot": straggler_slot, "latency_ms": straggler_ms,
                                                "latency_rate": 1.0}}
    try:
        t0 = time.perf_counter()
        # F13: on the CPU each replica runs on one torch thread too, so the
        # straggler's added latency, not the host's load, sets it apart
        omp = os.environ.get("OMP_NUM_THREADS")
        if dev.type == "cpu":
            os.environ["OMP_NUM_THREADS"] = "1"
        try:
            fleet.start()
        finally:
            if omp is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = omp
        router.start()
        gray["spawn_s"] = time.perf_counter() - t0
        img = images["interactive"]
        warm = []
        for _ in range(24):  # every replica's per-leg EWMA learns its pace
            t1 = time.perf_counter()
            router.submit(img).result(timeout=60)
            warm.append(time.perf_counter() - t1)
        warm.sort()
        healthy_p50_s = max(warm[len(warm) // 4], 1e-3)  # the lower quartile: the healthy replicas
        # well below capacity: the round measures detection and the tail
        gray_qps = min(max(3.0, 0.4 / healthy_p50_s), 20.0)
        gray["target_qps"] = gray_qps
        s_before = reg.snapshot()
        slow0, eject0 = s_before.get("fleet.slow_ejections", 0), s_before.get("fleet.ejections", 0)
        armed: dict = {}
        eject_at: dict = {}

        def watch():
            while "t" not in eject_at:
                t_armed = armed.get("t")
                if t_armed is not None and time.perf_counter() - t_armed > 120:
                    return
                if reg.snapshot().get("fleet.slow_ejections", 0) > slow0:
                    eject_at["t"] = time.perf_counter()
                    return
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        lat_rows: list = []
        lat_lock = threading.Lock()
        gaps = np.random.RandomState(seed + 9).exponential(1.0 / gray_qps, size=gray_requests)
        pending = []
        t_next = time.perf_counter()
        for i in range(gray_requests):
            t_next += gaps[i]
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if i == gray_requests // 3 and "t" not in armed:
                armed["t"] = time.perf_counter()
                router.set_slow_ejection(True)
            t1 = time.perf_counter()
            fut = router.submit(img)

            def stamp(fut, t1=t1):
                # keyed by submit time: a request submitted after the
                # ejection was routed to healthy replicas only
                if fut.exception() is None:
                    with lat_lock:
                        lat_rows.append((t1, time.perf_counter() - t1))

            fut.add_done_callback(stamp)
            pending.append(fut)
        unresolved = failed = 0
        for fut in pending:
            try:
                fut.result(timeout=120)
            except FutTimeout:
                unresolved += 1
            except Exception:  # noqa: BLE001 — a typed verdict; hangs are counted apart
                failed += 1
        watcher.join(timeout=5)
        t_eject, t_armed = eject_at.get("t"), armed.get("t")
        s_end = reg.snapshot()
        gray.update(submitted=gray_requests, completed=len(lat_rows), failed=failed, unresolved=unresolved,
                    slow_ejections=int(s_end.get("fleet.slow_ejections", 0) - slow0),
                    ejections_total=int(s_end.get("fleet.ejections", 0) - eject0),
                    time_to_eject_s=t_eject - t_armed if t_eject is not None and t_armed is not None else None)
        if t_eject is not None:
            before = sorted(d for t, d in lat_rows if t <= t_eject)
            after = sorted(d for t, d in lat_rows if t > t_eject)
            gray["p99_ms_before_eject"] = percentile(before, 0.99) * 1e3
            gray["p99_ms_after_eject"] = percentile(after, 0.99) * 1e3
            gray["post_eject_samples"] = len(after)
            gray["tail_recovery"] = (gray["p99_ms_before_eject"] / gray["p99_ms_after_eject"]
                                     if gray["p99_ms_after_eject"] else None)
        out["gray"] = gray
        out["k1_launches"] = _k1_count(engines)
        if dev.type == "cpu":
            out["cpu_rehearsal_note"] = OVERLOAD_CPU_NOTE
        return out
    finally:
        router.stop()
        fleet.stop()


def _partition_round(router, image, *, n_requests, target_qps, seed, hooks=(), result_timeout_s=60.0):
    """One open-loop Poisson round through the router, ``hooks`` ``[(index,
    fn), ...]`` fired just before their request (the fault's onset); a hook
    indexed past the end still fires. Every future resolves at the end."""
    from concurrent.futures import TimeoutError as FutTimeout

    from ..serve.client import ClientHTTPError

    gaps = np.random.RandomState(seed).exponential(1.0 / target_qps, size=n_requests)
    hooks = sorted(hooks, key=lambda h: h[0])
    pending, lat, lat_lock = [], [], threading.Lock()

    def stamp(t0):
        def cb(fut):
            if fut.exception() is None:
                with lat_lock:
                    lat.append(time.perf_counter() - t0)
        return cb

    t_start = time.perf_counter()
    t_next, hook_i = t_start, 0
    for i in range(n_requests):
        t_next += gaps[i]
        delay = t_next - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        while hook_i < len(hooks) and i >= hooks[hook_i][0]:
            hooks[hook_i][1]()
            hook_i += 1
        t0 = time.perf_counter()
        fut = router.submit(image)
        fut.add_done_callback(stamp(t0))
        pending.append(fut)
    while hook_i < len(hooks):
        hooks[hook_i][1]()
        hook_i += 1
    out = {"submitted": n_requests, "completed": 0, "rejected": 0, "failed": 0, "unresolved": 0}
    for fut in pending:
        try:
            fut.result(timeout=result_timeout_s)
            out["completed"] += 1
        except FutTimeout:
            out["unresolved"] += 1
        except ClientHTTPError as e:
            out["rejected" if e.status < 500 else "failed"] += 1
        except Exception:  # noqa: BLE001 — a typed route failure is client-visible
            out["failed"] += 1
    wall = time.perf_counter() - t_start
    lat.sort()
    out.update(wall_s=wall, qps=out["completed"] / wall if wall else 0.0, p50_ms=percentile(lat, 0.50) * 1e3,
               p99_ms=percentile(lat, 0.99) * 1e3)
    return out


_PARTITION_ROUND_KEYS = ("fleet.route_retries", "fleet.ejections", "fleet.readmissions",
                         "fleet.partition_ejections", "serve.client.connect_timeouts")


class _EchoEngine:
    """An engine that answers each image with its first pixel's first
    channel: the partition rounds measure the transport, not a model."""

    def predict_async(self, images):
        class _Handle:
            def result(_self):
                return images[:, 0, 0, :1].astype(np.float32)

        return _Handle()

    def predict(self, images):
        return self.predict_async(images).result()


def measure_partition(args) -> dict:
    """The ``--partition`` arm (the JAX bench's ``measure_partition``):
    ``--partition-replicas`` echo replicas in this process (the real
    ``Frontend`` and ``PipelinedBatcher`` over :class:`_EchoEngine`), each
    behind its own seeded ``serve/netchaos.py`` proxy, one router over the
    proxies. Four rounds on one schedule family, ``blackhole``, ``reset``,
    ``half_open`` and ``flap``, each injecting its fault at the socket a
    second in and healing it on a timer sized to the detection budget:
    detection (onset to ejection, stamped by a counter watcher), the
    client-visible failures (none allowed) and recovery (heal to every
    replica routable again). Then the membership round: a leased replica
    joins by heartbeat, vanishes silently, and must be removed by its
    lease's expiry within the TTL and one poll sweep. It touches no
    device."""
    from ..serve.admission import AdmissionController
    from ..serve.frontend import Frontend
    from ..serve.netchaos import NetChaosProxy
    from ..serve.pipeline import PipelinedBatcher
    from ..serve.router import Router

    reg = get_registry()
    replicas, seed = max(2, args.partition_replicas), args.partition_seed
    requests, target_qps = max(30, args.partition_requests), max(5.0, args.partition_qps)
    poll_interval_s, connect_timeout_s = args.partition_poll_s, args.partition_connect_timeout_s
    read_timeout_s, lease_ttl_s = args.partition_read_timeout_s, args.partition_lease_ttl_s
    eject_failures, eject_cooldown_s, flap_period_s, flap_down_s = 2, 0.3, 1.0, 0.5

    def echo_replica(tag):
        b = PipelinedBatcher(_EchoEngine(), max_batch=8, max_wait_ms=1.0, queue_depth=256,
                             drain_timeout_s=5.0).start()
        return b, Frontend(AdmissionController(b), port=0, replica_id=tag).start()

    stacks = [echo_replica(f"p{i}") for i in range(replicas)]
    proxies = [NetChaosProxy("127.0.0.1", fe.port, seed=seed + i).start() for i, (_, fe) in enumerate(stacks)]
    router = Router([p.addr for p in proxies], poll_interval_s=poll_interval_s, eject_failures=eject_failures,
                    route_attempts=replicas + 1, client_timeout_s=read_timeout_s,
                    connect_timeout_s=connect_timeout_s, eject_cooldown_s=eject_cooldown_s,
                    lease_ttl_s=lease_ttl_s, seed=seed).start()
    leased = None
    poll_read_s = max(connect_timeout_s, 2 * poll_interval_s)
    # ejection within the poll budget, with slack for a loaded host: far
    # below the read timeout
    detect_bound_s = eject_failures * (poll_interval_s + poll_read_s) + 2.0
    # the fault outlasts the expected detection, and the round outlasts
    # lead + fault + a recovery tail
    window_s = eject_failures * (poll_interval_s + poll_read_s) + 0.6
    flap_window_s = max(window_s, 2.2 * flap_period_s)
    lead_s, tail_s = 1.0, 2.5
    requests = max(requests, int(target_qps * (lead_s + flap_window_s + tail_s)) + 1)
    out = {"replicas": replicas, "seed": seed, "requests_per_round": requests, "target_qps": target_qps,
           "touches_device": False,
           "config": {"poll_interval_s": poll_interval_s, "eject_failures": eject_failures,
                      "connect_timeout_s": connect_timeout_s, "read_timeout_s": read_timeout_s,
                      "poll_read_s": poll_read_s, "eject_cooldown_s": eject_cooldown_s, "lease_ttl_s": lease_ttl_s,
                      "flap_period_s": flap_period_s, "flap_down_s": flap_down_s},
           "detect_bound_s": detect_bound_s}
    image = np.full((8, 8, 3), 3.0, np.float32)

    def watch_counter(key, baseline, holder, stamp_key, t0, timeout_s=60.0):
        def watch():
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                if reg.snapshot().get(key, 0) > baseline:
                    holder[stamp_key] = time.perf_counter() - t0
                    return
                time.sleep(0.02)

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        return t

    def watch_routable(n, holder, stamps, timeout_s=60.0):
        """Stamps the recovery: the first instant every replica is routable
        again after the heal."""
        def watch():
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                t_heal = stamps.get("_t_heal")
                if t_heal is not None and router.n_routable() >= n:
                    holder["recovery_s"] = time.perf_counter() - t_heal
                    return
                time.sleep(0.02)

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        return t

    try:
        for _ in range(3 * replicas):  # every replica's keep-alive path, and a poll
            router.submit(image).result(timeout=30)
        rounds = {}
        for r_i, shape in enumerate(("blackhole", "reset", "half_open", "flap")):
            victim = proxies[r_i % replicas]
            s0 = reg.snapshot()
            stamps: dict = {}
            extra: dict = {}
            t_round0 = time.perf_counter()
            this_window = flap_window_s if shape == "flap" else window_s

            def heal(victim=victim, stamps=stamps, t_round0=t_round0):
                stamps["heal_at"] = time.perf_counter() - t_round0
                stamps["_t_heal"] = time.perf_counter()
                victim.clear()

            def inject(shape=shape, victim=victim, stamps=stamps, t_round0=t_round0, s0=s0, heal=heal,
                       this_window=this_window):
                stamps["fault_at"] = time.perf_counter() - t_round0
                stamps["_t_fault"] = time.perf_counter()
                if shape == "flap":
                    victim.set_fault(None, flap_period_s=flap_period_s, flap_down_s=flap_down_s)
                else:
                    victim.set_fault(shape)
                # detection is stamped by a counter watcher, never by the
                # submit loop; the heal rides a timer sized to the budget
                stamps["_watch"] = watch_counter("fleet.ejections", s0.get("fleet.ejections", 0), stamps,
                                                 "detection_s", stamps["_t_fault"])
                t = threading.Timer(this_window, heal)
                t.daemon = True
                t.start()
                stamps["_heal_timer"] = t

            recovery_watch = watch_routable(replicas, extra, stamps)
            rnd = _partition_round(router, image, n_requests=requests, target_qps=target_qps,
                                   seed=seed + 11 * (r_i + 1), hooks=[(max(1, int(lead_s * target_qps)), inject)])
            w = stamps.pop("_watch", None)
            if w is not None:
                w.join(timeout=30)
            timer = stamps.pop("_heal_timer", None)
            if timer is not None:
                timer.join(timeout=2 * this_window + 5)
            recovery_watch.join(timeout=60)
            # converge before reading the books: a round's readmission is its own
            deadline = time.monotonic() + 30
            while router.n_routable() < replicas and time.monotonic() < deadline:
                time.sleep(0.05)
            rnd.update(_registry_delta(reg, s0, _PARTITION_ROUND_KEYS))
            rnd.update(fault_at_s=stamps.get("fault_at", 0.0), heal_at_s=stamps.get("heal_at", 0.0),
                       detection_s=stamps.get("detection_s"), recovery_s=extra.get("recovery_s"),
                       routable_after=router.n_routable())
            rounds[shape] = rnd
        out["rounds"] = rounds

        # membership: a leased replica joins, vanishes and expires out
        leased = echo_replica("leased")
        proxy_d = NetChaosProxy("127.0.0.1", leased[1].port, seed=seed + 99).start()
        leased = leased + (proxy_d,)
        s0 = reg.snapshot()
        router.register(*proxy_d.addr, ttl_s=lease_ttl_s, replica_id="leased")
        renewing = threading.Event()
        renewing.set()

        def renew_loop():
            while renewing.is_set():
                try:
                    router.register(*proxy_d.addr, ttl_s=lease_ttl_s)
                except Exception:  # noqa: BLE001 — the heartbeat is best effort
                    pass
                time.sleep(lease_ttl_s / 3.0)

        renew_thread = threading.Thread(target=renew_loop, daemon=True)
        renew_thread.start()
        deadline = time.monotonic() + 30
        while router.n_routable() < replicas + 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        joined = router.n_routable() == replicas + 1
        stamps_m: dict = {}

        def vanish():
            # the heartbeat stops and the link blackholes: nothing refuses a
            # connection or sends a FIN, only the lease can remove it
            stamps_m["_t_vanish"] = time.perf_counter()
            renewing.clear()
            proxy_d.set_fault("blackhole")
            stamps_m["_watch"] = watch_counter("fleet.lease_expirations", s0.get("fleet.lease_expirations", 0),
                                               stamps_m, "removed_s", stamps_m["_t_vanish"])

        rnd = _partition_round(router, image, n_requests=requests, target_qps=target_qps, seed=seed + 77,
                               hooks=[(requests // 3, vanish)])
        w = stamps_m.pop("_watch", None)
        if w is not None:
            w.join(timeout=30)
        renew_thread.join(timeout=5)
        rnd.update(_registry_delta(reg, s0, ("fleet.registrations", "fleet.lease_renewals",
                                             "fleet.lease_expirations", "fleet.route_retries")))
        rnd.update(joined=joined, removed_s=stamps_m.get("removed_s"),
                   removal_bound_s=lease_ttl_s + 1.2 * poll_interval_s + 2.0,
                   total_after=len(router.replicas_state()))
        out["membership"] = rnd
        out["cpu_rehearsal_note"] = PARTITION_NOTE
        return out
    finally:
        router.stop()
        for p in proxies:
            p.stop()
        if leased is not None:
            for part in reversed(leased):
                part.stop()
        for b, fe in stacks:
            fe.stop()
            b.stop()


# what a CPU rehearsal nulls: every time, rate and share (counts, bytes,
# FLOPs per key and parity verdicts stay)
_DEVICE_METRIC = re.compile(r"(qps|_ms$|_ms_|_s$|speedup|share$|^value$|^p\d\d$|^max$)")


def _null_device_metrics(obj):
    if isinstance(obj, dict):
        return {k: None if _DEVICE_METRIC.search(k) else _null_device_metrics(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_null_device_metrics(v) for v in obj]
    return obj


def _main_partition(args) -> int:
    """The ``--partition`` line: the arm touches no device, so it runs on
    any host whatever ``--device`` says, and its times are the host's own
    (the transport's detection and recovery), kept on the CPU too."""
    out: dict = {"metric": "partition_blackhole_detect_seconds", "value": None, "unit": "seconds",
                 "platform": "host", "touches_device": False, "cpu_rehearsal": False, "n_cards": 0,
                 "device_kind": None}
    rc = 0
    try:
        out["partition"] = measure_partition(args)
        out["value"] = out["partition"]["rounds"]["blackhole"]["detection_s"]
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    out["provenance"] = card_provenance(args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


def _ints(s: str) -> list[int]:
    return [int(v) for v in s.split(",") if v]


def _floats(s: str) -> list[float]:
    return [float(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mobilenet_v3_large")
    ap.add_argument("--image-sizes", type=_ints, default=[224])
    ap.add_argument("--buckets", type=_ints, default=[1, 8, 32])
    ap.add_argument("--arms", type=lambda s: [a for a in s.split(",") if a], default=list(ARMS),
                    help="direct and concurrent always run; the rest: " + ",".join(ARMS[2:]))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5, help="interleaved rounds of the concurrent A/B")
    ap.add_argument("--concurrent-iters", type=int, default=6)
    ap.add_argument("--ab-iters", type=int, default=10)
    ap.add_argument("--max-inflight", type=int, default=2)
    ap.add_argument("--fuse-ladder", type=_ints, default=[2, 4])
    ap.add_argument("--fused-iters", type=int, default=8)
    ap.add_argument("--structural-rounds", type=int, default=3)
    ap.add_argument("--quant-iters", type=int, default=5)
    ap.add_argument("--quant-rounds", type=int, default=3)
    ap.add_argument("--quant-top1-min", type=float, default=0.9)
    ap.add_argument("--chaos-requests", type=int, default=1000)
    ap.add_argument("--chaos-qps", type=_floats, default=[], help="open-loop rates (requests/s); overrides --chaos-load")
    ap.add_argument("--chaos-load", type=_floats, default=[0.5, 0.9],
                    help="open-loop rates as fractions of the shipped stack's closed-loop peak QPS")
    ap.add_argument("--chaos-fault-rate", type=float, default=0.05)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--fleet", action="store_true", help="the fleet arm alone (measure_fleet)")
    ap.add_argument("--fleet-requests", type=int, default=500, help="open-loop requests per round")
    ap.add_argument("--fleet-phase-s", type=_floats, default=[5.0, 20.0, 10.0],
                    help="the autoscaler's low,high,trough phases in seconds")
    ap.add_argument("--zoo", action="store_true", help="the zoo and cascade arm alone (measure_zoo)")
    ap.add_argument("--zoo-requests", type=int, default=500, help="open-loop requests per arm")
    ap.add_argument("--overload", action="store_true",
                    help="the overload arm alone (measure_overload): brownout off against on under one seeded "
                         "storm, and the gray-failure round")
    ap.add_argument("--overload-storm-s", type=float, default=5.0, help="each storm's length (requests = rate x it)")
    ap.add_argument("--overload-multiple", type=float, default=3.0, help="the storm's rate over the capacity")
    ap.add_argument("--overload-pace-ms", type=float, default=20.0, help="the seeded latency floor of a dispatch")
    ap.add_argument("--overload-replicas", type=int, default=2, help="the gray round's fleet (the last one slow)")
    ap.add_argument("--overload-gray-requests", type=int, default=60, help="open-loop requests of the gray round")
    ap.add_argument("--overload-straggler-ms", type=float, default=300.0, help="the straggler's added latency")
    ap.add_argument("--overload-seed", type=int, default=0)
    ap.add_argument("--partition", action="store_true",
                    help="the partition arm alone (measure_partition): echo replicas behind netchaos proxies, four "
                         "fault rounds and the lease round; touches no device")
    ap.add_argument("--partition-replicas", type=int, default=3)
    ap.add_argument("--partition-requests", type=int, default=120, help="open-loop requests per round")
    ap.add_argument("--partition-qps", type=float, default=30.0, help="open-loop rate per round")
    ap.add_argument("--partition-poll-s", type=float, default=0.1, help="the router's health-poll interval")
    ap.add_argument("--partition-connect-timeout-s", type=float, default=0.4,
                    help="the client's connect budget (it bounds the poll reads too)")
    ap.add_argument("--partition-read-timeout-s", type=float, default=2.0,
                    help="the client's read budget: detection must beat it")
    ap.add_argument("--partition-lease-ttl-s", type=float, default=1.5, help="the membership round's lease TTL")
    ap.add_argument("--partition-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if args.partition:
        return _main_partition(args)
    if args.overload:
        out: dict = {"metric": f"{args.arch}_overload_interactive_availability", "value": None,
                     "unit": "completed/submitted"}
    elif args.zoo:
        out = {"metric": f"{args.arch}_zoo_cascade_flops_vs_big_only", "value": None,
                     "unit": "dispatched FLOPs per request, cascade / big only"}
    elif args.fleet:
        out = {"metric": f"{args.arch}_fleet_hedged_p99_ms", "value": None,
               "unit": (f"ms: p99 of the hedged open-loop round at offered_qps ({FLEET_LOAD} / the warm p50), "
                        f"one of {FLEET_REPLICAS} replicas adding {STRAGGLER_MS:.0f} ms to "
                        f"{STRAGGLER_RATE:.0%} of its answers")}
    else:
        out = {"metric": f"{args.arch}_serve_peak_qps", "value": None, "unit": "requests/s"}
    rc = 0
    try:
        unknown = set(args.arms) - set(ARMS)
        if unknown:
            raise ValueError(f"unknown arms {sorted(unknown)}; the arms are {ARMS}")
        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu", n_cards=1 if dev.type == "cuda" else 0,
                   device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        if args.zoo or args.fleet or args.overload:
            log_root = tempfile.mkdtemp(prefix="serve_bench_fleet_")
            try:
                if args.overload:
                    res = {"overload": measure_overload(args, dev, log_root)}
                    res["value"] = res["overload"]["storm"]["interactive_availability_on"]
                elif args.zoo:
                    res = {"zoo": measure_zoo(args, dev, log_root)}
                    res["value"] = res["zoo"]["cost"]["cascade_vs_big_only"]
                else:
                    res = {"fleet": measure_fleet(args, dev, log_root)}
                    res["value"] = res["fleet"]["hedge_ab"]["hedged"]["p99_ms"]
                    res["offered_qps"] = res["fleet"]["target_qps"]
            finally:
                shutil.rmtree(log_root, ignore_errors=True)
        else:
            res = measure(args, dev)
        out.update(_null_device_metrics(res) if dev.type == "cpu" else res)
        if args.zoo or args.overload:  # a count ratio, not a device metric: it stands on the CPU too
            out["value"] = res["value"]
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out["value"] = None
        out["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    out["provenance"] = card_provenance(args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

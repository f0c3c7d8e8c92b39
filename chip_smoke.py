#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``yet_another_mobilenet_series_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package, and it fails
(exit code other than 0, no result line) on a machine without CUDA or when
the port is not beside it. In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the torch,
   CUDA and ``nvcc`` versions;
2. builds every kernel of the serving path from the sources in the checkout
   (one ``nvcc`` per source, all started together) and prints the time and
   what ``ptxas`` reports;
3. holds each kernel against its plain PyTorch version on the card: the 15
   depthwise stages of MobileNetV3-Large at 224 at each serving bucket
   (batch 1, 8 and 32, whose plans tile differently), in float32 (atol =
   rtol = 1e-5, TF32 off) and bfloat16 (BF16_ATOL/BF16_RTOL), the grid of
   the JAX package's Pallas tests, AtomNAS-style channel slices of a wider
   tensor on the scalar and the vector path, and a tiny multi-branch net's
   folded logits against the port's CPU forward (SLICE_ATOL/SLICE_RTOL).
   Then, per stage at batch 32 and in both types, it times the kernel warm,
   back to back (``cuda_time_ms``: the host's pace where a launch costs the
   host more than the device), warm on the device alone (``device_ms``: the
   stream idles first while the host enqueues the launches, as a CUDA graph
   would replay them) and cold (a 128 MB buffer written before each launch,
   so L2 holds none of its inputs), and, as a diagnostic, cold with a clean
   L2 (the flush read back from another buffer, so the launch pays no
   write-back of dirty lines); then F.conv2d(groups=C, bias) the same three
   ways and the plain version; prints the bound and the cold share of it;
   and the host microseconds per call of the wrapper and of F.conv2d;
4. serves MobileNetV3-Large 1.0 at 224 in float32 with seeded weights,
   three loads through the port's entry point, ``cli/serve.py``'s
   ``run(cfg, device)``, which captures every graph at warmup: (a) the
   shipped ``apps/serve_mobilenet_v3.yml`` as shipped (buckets 1/8/32, the
   fused-K ladder [2, 4], overlapped staging), (b) the same with
   ``serve.ring.enable=true``, (c) the same with ``serve.quant.wire=uint8``;
   each 256 single-image requests from 8 closed-loop clients, the counts
   set to 0 just before and read just after. Gates: every request
   completes, 0 shed, 0 rejected; the graphs are the ladder's, each
   captured once; every dispatch is a graph replay; each graph holds 15 K1
   launches per forward it runs and K1 launched nothing outside warm runs
   and captures. Then, per load, an engine built the same way
   (``engine_kwargs``, the batcher of ``_make_batcher``) takes what single
   images do not make, under ``torch.profiler``: a bulk client's requests
   of 40-128 rows to ``engine.predict`` (the fused ladder) beside a burst
   client's 128 images at once, three times (ring windows). Gates: every
   dispatch a replay, fused dispatches (and ring windows) ran, the card's
   own count of K1 launches equals replays x captured launches, and the
   logits match the port's CPU forward within SLICE_ATOL/SLICE_RTOL;
5. holds on the card, bit for bit: graph replay against the eager forward
   per bucket, fused K=2 and K=4 against per-chunk, ring fills 1..4
   against the per-batch path at bucket 32, overlap on against off, two
   unsynced in-flight dispatches of one key against their own eager
   results, and the shift-free u8 wire against the f32 wire fed
   ``normalize_reference`` pixels; then an int8 bundle against its own
   dequantized f32 forward within the int8 gate (top-1 agreement);
6. times, per bucket, the eager forward against the graph replay (host
   enqueue, device time back to back and alone), the serving dispatch's
   host cost, the fused K=4 graph per chunk and the ring R=4 graph per
   slot, graph memory, a new thread's first forward, and breaks five
   batch-32 replays down by kernel with ``torch.profiler``, whose count of
   K1 launches must be 5 x 15;
7. trains MobileNetV3-Large 1.0 at 224 (``apps/mobilenet_v3_large.yml``,
   the port's training path): (a) one f32 step at batch 8 on the card and on
   the port's CPU path from one state and batch, TF32 off, loss, grad norm
   and updated params held at TRAIN_*_TOL; (b) ``cli/train.py``'s
   ``run()`` (here ``train()``, which also returns the state) on the
   shipped config as shipped (bf16, batch TRAIN_BATCH, TF RMSProp, EMA)
   with the fake dataset, TRAIN_STEPS steps and the EMA eval, under
   ``torch.cuda.set_sync_debug_mode("warn")``: gates every step finite, the
   step counter equal to the steps taken, no host sync inside a step
   between log points, the run on cuda, and no K1 launch (the training
   forward has no folded stage); (c) OVERFIT_STEPS steps on one repeated
   batch of OVERFIT_BATCH at a constant LR, the loss below OVERFIT_FACTOR
   of its first value; (d) the trained EMA weights exported
   (``export_bundle``) and served (``InferenceEngine``), logits against
   ``Network.apply(train=False)`` of the same weights within FOLD_ATOL, and
   15 K1 launches per forward, in the graph's capture and by the profiler's
   count over SERVED_FORWARDS forwards; (e) ms per step,
   synchronized, and images/s in bf16 and f32, peak memory, and five bf16
   steps under ``torch.profiler``: device-busy share, top kernels, the
   optimizer update's share (its ``multi_tensor_apply`` kernels, and the
   update timed alone);
8. runs the AtomNAS search (``apps/atomnas_a_search.yml``: atomnas_supernet
   1.0 at 224, relu6, bf16, TF RMSProp, EMA, target 258M MACs; one card, the
   cuts of the SEARCH_* constants): (a) one f32 search step, with the
   penalty, and one prune event on the card and on the port's CPU path from
   one state: loss and penalty at TRAIN_LOSS_TOL, the masks equal, grad norm
   and params at the larger of TRAIN_*_TOL and SEARCH_SPREAD_FACTOR times
   the card's own spread between cuDNN and its native convolutions (the
   supernet's first step is ill-conditioned in float32); (b) the search through
   ``cli/train.py``'s ``train()`` under ``set_sync_debug_mode("warn")``:
   gates every step finite, atoms dead and a rematerialization mid-run that
   rebuilt the trainer and freed the supernet's memory, searched_arch.json
   below the supernet's MACs, no host sync inside a step or a prune event,
   no K1 launch; then the supernet's and the searched net's step timed
   alone; (c) the masked supernet's eval forward against the
   rematerialized one on the card at the f32 bar, and a dead-mask export
   whose spec is the rematerialized one; (d) the searched EMA weights
   exported and served through ``cli/serve.py``'s ``run()`` (buckets
   1/8/32, f32), K1 one launch per surviving branch per forward in the
   graphs and by the profiler (in a fresh process), logits against
   ``Network.apply`` within
   FOLD_ATOL; (e) K1 against its plain version at every branch of the
   supernet and of the searched net as channel slices in place (batches 1
   and 32, f32 and bf16), then timed beside F.conv2d at the searched net's
   branches; (f) a few steps of ``apps/retrain_searched.yml`` on
   searched_arch.json;
9. prints the ``kernels`` JSON line, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Details too long for the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")

# float32 kernel vs plain version (tests/test_pallas.py's bar), TF32 off
F32_TOL = 1e-5
# bfloat16: kernel and plain version both accumulate in float32 and round
# the result once to bfloat16 (8 significant bits), so they differ by at
# most one bfloat16 ulp where their float32 sums fall on opposite sides of a
# rounding boundary: 2**-7 relative at worst. The largest error measured on
# the card is printed beside this bar.
BF16_ATOL = 1e-2
BF16_RTOL = 2.0 ** -7
# the served logits on the card vs the port's CPU forward of the same
# bundle, both float32 (TF32 off): the repository's float32 forward parity
# bar (rtol 1e-4, atol 1e-5)
SLICE_ATOL = 1e-5
SLICE_RTOL = 1e-4

# published memory bandwidth and float32 (non-tensor-core) rate of the
# H100 variants (NVIDIA data sheets); the SXM part is the default
_BW = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
_F32 = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}

# the serving buckets of apps/serve_mobilenet_v3.yml
BUCKETS = (1, 8, 32)
IMAGE_SIZE = 224
SERVE_REQUESTS = 256
SERVE_CLIENTS = 8
# beside the closed-loop clients of each load: a bulk client sending
# requests of more than 32 rows to engine.predict (the fused ladder: 40 rows
# = K=2 with a padded tail, 64 = K=2, 100 = K=2 + K=1 + a bucket-8 tail, 128
# = K=4), and a burst client submitting BURST_IMAGES single images at once
# (a queue deep enough for ring windows), BURSTS times
BULK_ROWS = (40, 64, 100, 128)
BULK_REQUESTS = 8
BURST_IMAGES = 128
BURSTS = 3
# rows of each load held against the port's CPU forward (besides a bulk
# request and the closed-loop image)
CPU_ROWS = 8
# phase 4's loads: the shipped config as shipped, then the ring, then the
# uint8 wire (raw pixels, denormalized with data.mean/std on the card)
LOADS = (("shipped", []), ("ring", ["serve.ring.enable=true"]), ("uint8", ["serve.quant.wire=uint8"]))
TIMING_ITERS = 50
# phase 7, training: the shipped config, the fake dataset at 224
TRAIN_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "mobilenet_v3_large.yml")
TRAIN_BATCH = 512  # apps/mobilenet_v3_large.yml's train.batch_size
TRAIN_STEPS = 20
TRAIN_LOG_EVERY = 10
TRAIN_CHECK_BATCH = 8
# one f32 step on the card against the port's CPU path (TF32 off): loss and
# grad norm relative, updated params as |diff| / (1 + |p|). Measured once on
# an H100 80GB HBM3 at 700 W: loss 0 (equal to 8 digits), grad norm 3.1e-5,
# params 1.7e-7 (BN state 1.2e-7, nu 1.3e-7)
TRAIN_LOSS_TOL = 1e-5
TRAIN_NORM_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-6
OVERFIT_STEPS = 30
OVERFIT_BATCH = 32
OVERFIT_LR = 0.02
OVERFIT_FACTOR = 0.7
TIMING_STEPS = 10
PROFILED_STEPS = 5
# phase 8, the AtomNAS search: apps/atomnas_a_search.yml at full width
# (atomnas_supernet 1.0 at 224), cut to one card and a short run
SEARCH_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "atomnas_a_search.yml")
RETRAIN_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "retrain_searched.yml")
SEARCH_BATCH = 256  # the config's 2048 is spread over 16 chips
SEARCH_STEPS_PER_EPOCH = 8
SEARCH_EPOCHS = 3
SEARCH_LOG_EVERY = 4
SEARCH_EVAL_IMAGES = 512
# an event every 2 steps (the config's 500 would fire none in this run) and a
# rematerialization at every epoch boundary, so the trainer is rebuilt
# mid-run and trains on the shrunk network
SEARCH_MASK_INTERVAL = 2
SEARCH_REMAT_EPOCHS = 1
# gammas start at 1, so |gamma| < 1.0 kills each atom whose gamma the first
# steps moved down; the config's 1e-3 kills none in a run this short
SEARCH_GAMMA_THRESHOLD = 1.0
SEARCH_TIMING_STEPS = 5
RETRAIN_BATCH = 256  # the config's 1024 is spread over many chips
RETRAIN_STEPS = 4
# the search's one-step parity check on the card: these gammas of every
# prunable block start far below this threshold, so the event kills them on
# both devices whatever float32 rounding does to the rest
PARITY_GAMMA_THRESHOLD = 0.1
PARITY_DEAD_EVERY = 7
# The supernet's first f32 step at init is ill-conditioned: its early-layer
# gradients are sums with heavy cancellation (grad norm 24, against 1.0 for
# MobileNetV3-Large). Measured on an NVIDIA H100 80GB HBM3 at 700 W, three
# float32 implementations of the same step differ pairwise in params by
# 4.3e-6 (the CPU at 1 and at 8 threads), 2.7e-5 (the card's cuDNN against
# the CPU) and 4.4e-5 (the card's cuDNN against its native convolutions,
# cuDNN off), above TRAIN_PARAM_TOL, which MobileNetV3-Large meets at 3e-8.
# So the search step's grad norm and params are held at the larger of
# TRAIN_*_TOL and this factor times the same measure between the card's two
# convolution implementations on the same input; loss and penalty stay at
# TRAIN_LOSS_TOL, the masks exact.
SEARCH_SPREAD_FACTOR = 4
# the folded logits against the unfolded forward (tests/test_serve.py)
FOLD_ATOL = 1e-4
SERVED_FORWARDS = 5
SEARCH_SERVE_REQUESTS = 64
# phase 8 (d) counts K1 under the profiler in a fresh process: in this
# process, after the profiled windows of phases 4-7, the profiler dropped a
# constant few K1 records of each window of graph replays (249 and 252 of
# 255 on an NVIDIA H100 80GB HBM3 at 700 W), where a fresh process counted
# every launch in each of 12 windows
PROFILE_CHILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                 "print(json.dumps(chip_smoke.profile_served_forwards(*sys.argv[2:])))")
# cold timing: a write of this many bytes (more than the H100's 50 MB L2)
# before each timed launch evicts what the last launch left in L2
FLUSH_BYTES = 128 << 20
COLD_REPS = 15
# torch.cuda._sleep counts GPU cycles: at most the H100's 1.98 GHz, so a
# sleep sized at this rate lasts at least as long as asked
SLEEP_HZ = 2.0e9
MAX_IDLE_S = 0.5
HOST_ITERS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float, str]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return _BW[key], _F32[key], key
    return _BW["SXM"], _F32["SXM"], "SXM"


def cuda_time_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events, after three warm-up calls: the device's time, or the host's
    pace where enqueueing a call takes longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _idle_while_host_enqueues(host_seconds: float) -> None:
    """Keep the stream busy for twice ``host_seconds`` (torch.cuda._sleep at
    a clock of at most SLEEP_HZ), so that work the host enqueues meanwhile
    is queued before the next event and timed on the device alone."""
    import torch

    torch.cuda._sleep(int(min(2.0 * host_seconds, MAX_IDLE_S) * SLEEP_HZ))


def _host_seconds(fn) -> float:
    """Wall time of one synchronized call of ``fn``: more than its host cost."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_time_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after three warm-up calls. The stream idles first while the host
    enqueues the calls, so a call that costs the host more than the device
    is still timed on the device (what a CUDA graph would replay); inputs
    that fit in the 50 MB L2 stay warm there."""
    import torch

    for _ in range(3):
        fn()
    host_s = _host_seconds(fn)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _idle_while_host_enqueues(iters * host_s)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_time_ms(fn, flush, clean=None) -> float:
    """Median device time of one call of ``fn`` with a cold L2: before each
    call the stream writes ``flush`` (larger than L2), then idles while the
    host enqueues the call; CUDA events around the call alone. With
    ``clean`` (another buffer larger than L2), the stream reads it after the
    write, so L2 holds clean lines and the call pays no write-back of the
    flush's dirty ones (a diagnostic of that cost)."""
    import torch

    fn()
    host_s = _host_seconds(fn)
    pairs = []
    for _ in range(COLD_REPS):
        flush.zero_()
        if clean is not None:
            clean.sum()
        _idle_while_host_enqueues(host_s)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def host_us_per_call(fn, iters: int = HOST_ITERS) -> float:
    """Host time of one call of ``fn`` in microseconds: a host clock over
    ``iters`` calls with no synchronize inside (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def stage_bound(n, h, c, k, s, itemsize, rates) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes) of one depthwise stage: each input
    read once and each output written once (x and y in ``itemsize`` bytes,
    the taps and the three (C,) vectors in float32) over the memory rate,
    against 2k^2 + 4 float32 operations per output over the float32 rate."""
    bw, f32_rate, _ = rates
    oh = (h - 1) // s + 1
    out_elems = n * oh * oh * c
    nbytes = itemsize * (n * h * h * c + out_elems) + 4 * (k * k * c + 3 * c)
    flops = out_elems * (2 * k * k + 4)
    by_bytes, by_ops = nbytes / bw, flops / f32_rate
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations", nbytes


def mbv3_depthwise_shapes(batch: int = 32):
    """(n, h, c, k, stride, act) of every depthwise branch of
    MobileNetV3-Large 1.0 at 224, in forward order, from the port's own
    ``get_model``."""
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    net = get_model(ModelConfig(arch="mobilenet_v3_large"), image_size=224)
    h = (224 - 1) // net.stem.stride + 1
    shapes = []
    for blk in net.blocks:
        for _, k, g, _ in blk._branches():
            shapes.append((batch, h, g, k, blk.stride, blk.active_fn))
        h = (h - 1) // blk.stride + 1
    return net, shapes


def kernel_operands(n, h, c, k, dtype, gen, device):
    import torch

    x = torch.randn((n, h, h, c), generator=gen, device=device).to(dtype)
    w = (torch.randn((k, k, c), generator=gen, device=device) * 0.2).contiguous()
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    shift = (torch.rand(c, generator=gen, device=device) - 0.5) * 0.6
    mask = torch.ones(c, device=device)
    mask[::3] = 0.0
    return x, w, scale, shift, mask


def compare(y, ref, atol, rtol) -> tuple[float, bool]:
    import torch

    err = (y.float() - ref.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * ref.float().abs()).item()) and bool(torch.isfinite(y).all().item())
    return float(err.max().item()), ok


def phase_build() -> dict:
    """Build every kernel source of the path, one nvcc each, all at once."""
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    names = ["fused_depthwise"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(cuda_build.build, names))
    wall = time.perf_counter() - t0
    for name, path in zip(names, paths):
        info = cuda_build.BUILD_INFO[name]
        ptxas = [line for line in info["log"].splitlines() if "registers" in line or "spill" in line]
        log(f"build {name}: {info['seconds']:.1f}s{' (cached)' if info['cached'] else ''} -> {path}")
        for line in ptxas:
            log(f"  ptxas: {line.strip()}")
    log(f"build wall: {wall:.1f}s")
    return {"seconds": wall}


def phase_kernel_checks(device, tmp: str) -> dict:
    """Kernel vs plain version on the card: the MBV3-L stages, the Pallas
    grid, channel slices on both paths, and a multi-branch net's logits."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import (
        fused_depthwise, fused_depthwise_reference)

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    gen = torch.Generator(device=device).manual_seed(0)
    # every serving bucket: the plan tiles each batch differently
    shapes = [shape for batch in BUCKETS for shape in mbv3_depthwise_shapes(batch)[1]]
    plans = {(n, h, c, k, s, item): fdw.plan(n, h, h, c, k, s, item, True)
             for (n, h, c, k, s, _) in shapes for item in (4, 2)}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failures = []

    def check(tag, y, ref, dtype, case):
        tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err, ok = compare(y, ref, *tol)
        errs[dtype] = max(errs[dtype], err)
        if not ok or y.shape != ref.shape:
            failures.append((tag, *case, str(dtype), err))

    grid = [(2, 12, 16, k, s, act) for k in (3, 5, 7) for s in (1, 2)
            for act in ("relu6", "hswish", "swish", "relu")]
    grid += [(2, 9, c, 3, s, "hswish") for c in (160, 200) for s in (1, 2)]
    with torch.inference_mode():
        for tag, cases in (("mbv3", shapes), ("grid", grid)):
            for case in cases:
                n, h, c, k, s, act = case
                for dtype in (torch.float32, torch.bfloat16):
                    ops = kernel_operands(n, h, c, k, dtype, gen, device)
                    y = fused_depthwise(*ops, s, act)
                    torch.cuda.synchronize()
                    check(tag, y, fused_depthwise_reference(*ops, s, act), dtype, case)
        slices = check_channel_slices(device, gen, check)
    log(f"kernel vs plain: {len(shapes)} MBV3-L stages (15 at each of batches {'/'.join(map(str, BUCKETS))}, "
        f"{len(set(plans.values()))} distinct tilings) + {len(grid)} grid cases + {slices} channel slices, "
        f"f32 and bf16: max |err| f32 {errs[torch.float32]:.3e} (tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} "
        f"(atol {BF16_ATOL}, rtol {BF16_RTOL:.4g})")
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures[:5]}")
    branch_err = check_branch_net(device, tmp)
    return {"max_f32": errs[torch.float32], "max_bf16": errs[torch.bfloat16], "branch_net_max_abs_err": branch_err}


def check_channel_slices(device, gen, check) -> int:
    """AtomNAS-style branches: channel slices of one wide NHWC input written
    into slices of one wide output, in place. A slice at a channel offset
    that is not a multiple of the 16-byte vector takes the scalar path, one
    at a multiple of it the vector path; both against the plain version on
    contiguous copies, and the channels outside the slices stay untouched."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    n, h, wide, k, s, act = 8, 28, 120, 5, 1, "hswish"
    count = 0
    for dtype in (torch.float32, torch.bfloat16):
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        # (offset, channels, vector path?): off 3 and 53 are not multiples
        # of 4 or 8; 64 is a multiple of both
        branches = [(3, 45, False), (64, 48, True), (53, 8, False)]
        x = torch.randn((n, h, h, wide), generator=gen, device=device).to(dtype)
        out = torch.full((n, h, h, wide), float("nan"), device=device, dtype=dtype)
        for off, g, vector in branches:
            ops = kernel_operands(n, h, g, k, dtype, gen, device)[1:]
            xs, ys = x[..., off: off + g], out[..., off: off + g]
            p = fdw.launch_plan(xs, k, s, ys)
            if (p.vec == vec) != vector:
                raise AssertionError(f"slice at offset {off}, {g} channels, {dtype}: vec {p.vec}, "
                                     f"{'vector' if vector else 'scalar'} path expected")
            fdw.fused_depthwise(xs, *ops, s, act, out=ys)
            torch.cuda.synchronize()
            check("slice", ys, fdw.fused_depthwise_reference(xs.contiguous(), *ops, s, act), dtype,
                  (n, h, g, k, s, act, off))
            count += 1
        untouched = torch.ones(wide, dtype=torch.bool, device=device)
        for off, g, _ in branches:
            untouched[off: off + g] = False
        if not torch.isnan(out[..., untouched].float()).all():
            raise AssertionError("a slice launch wrote outside its channels")
    return count


def check_branch_net(device, tmp: str) -> float:
    """A tiny net whose blocks split their channels into k = 3/5/7 branches
    (one branch at an offset off the 16-byte vector): the card's folded
    logits against the port's CPU forward of the same bundle."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    specs = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
             {"t": 3, "c": 16, "n": 2, "s": 2, "k": [3, 5, 7]},
             {"t": 2.5, "c": 24, "n": 1, "s": 1, "k": [3, 5, 7]}]
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, dropout=0.0, block_specs=specs),
                    image_size=32)
    groups = [b.group_channels for b in net.blocks if len(b.group_channels) > 1]
    if not any(g % 4 for gs in groups for g in gs):
        raise AssertionError(f"no branch off the 16-byte vector in {groups}")
    gen = torch.Generator().manual_seed(3)
    params, _ = net.init(gen)
    bundle_dir = os.path.join(tmp, "branch_bundle")
    export_bundle(net, params, random_bn_state(net, gen), bundle_dir, model_name="branches")
    bundle = load_bundle(bundle_dir)
    x = np.random.RandomState(4).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    on_card = InferenceEngine(bundle, device=str(device), buckets=(4,)).predict(x)
    on_cpu = InferenceEngine(bundle, device="cpu", buckets=(4,)).predict(x)
    err = float(np.abs(on_card - on_cpu).max())
    ok = on_card.shape == (4, 10) and bool(np.all(np.abs(on_card - on_cpu) <= SLICE_ATOL + SLICE_RTOL * np.abs(on_cpu)))
    log(f"multi-branch net (branches {groups}), card vs CPU forward (f32): max |err| {err:.3e}, max |logit| "
        f"{float(np.abs(on_cpu).max()):.3e} (atol {SLICE_ATOL}, rtol {SLICE_RTOL})")
    if not ok:
        raise AssertionError(f"multi-branch logits on the card differ from the CPU forward by {err:.3e}")
    return err


def time_stages(device, rates, shapes=None) -> dict:
    """Times at the main path's shapes (batch 32; ``shapes``, (n, h, c, k,
    stride, act) each, default MobileNetV3-Large's 15 stages), float32 and
    bfloat16: the kernel warm back to back (``ms``), warm on the device
    alone (``device_ms``) and cold, F.conv2d(groups=C, bias) the same three
    ways, the plain version, the bound and the cold share of it; then the
    host cost of the wrapper and of F.conv2d. Uses only the wrapper's
    positional API, which every version of the port has
    (scripts/ab_fused_depthwise.py runs it on two checkouts)."""
    import torch
    import torch.nn.functional as F

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import (
        fused_depthwise, fused_depthwise_reference)

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = shapes or mbv3_depthwise_shapes(32)[1]
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    clean = torch.zeros(FLUSH_BYTES // 4, device=device)
    rows = []
    with torch.inference_mode():
        for (n, h, c, k, s, act) in shapes:
            row = {"n": n, "h": h, "c": c, "k": k, "stride": s, "act": act}
            for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
                x, w, scale, shift, mask = kernel_operands(n, h, c, k, dtype, gen, device)
                x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the NHWC input
                w_oihw = w.permute(2, 0, 1).unsqueeze(1).to(dtype).contiguous()
                bias = shift.to(dtype)

                def kernel():
                    fused_depthwise(x, w, scale, shift, mask, s, act)

                def library():
                    F.conv2d(x_cl, w_oihw, bias, stride=s, padding=k // 2, groups=c)

                row[tag + "ms"] = cuda_time_ms(kernel)
                row[tag + "device_ms"] = device_time_ms(kernel)
                row[tag + "cold_ms"] = cold_time_ms(kernel, flush)
                row[tag + "cold_clean_ms"] = cold_time_ms(kernel, flush, clean)
                row[tag + "plain_ms"] = cuda_time_ms(
                    lambda: fused_depthwise_reference(x, w, scale, shift, mask, s, act))
                row[tag + "library_ms"] = cuda_time_ms(library)
                row[tag + "library_device_ms"] = device_time_ms(library)
                row[tag + "library_cold_ms"] = cold_time_ms(library, flush)
                bound = stage_bound(n, h, c, k, s, x.element_size(), rates)
                row[tag + "bound_ms"], row[tag + "bound_by"], row[tag + "bytes"] = bound
                row[tag + "share"] = row[tag + "bound_ms"] / row[tag + "cold_ms"]
            rows.append(row)
            log(f"  dw n={n} h={h:3d} c={c:3d} k={k} s={s} {act:6s}: "
                + "; ".join(f"{name} kernel {row[t + 'ms']:.4f} back to back / {row[t + 'device_ms']:.4f} device "
                            f"/ {row[t + 'cold_ms']:.4f} cold ms, conv2d {row[t + 'library_ms']:.4f} / "
                            f"{row[t + 'library_device_ms']:.4f} / {row[t + 'library_cold_ms']:.4f}, "
                            f"plain {row[t + 'plain_ms']:.4f}, bound {row[t + 'bound_ms']:.4f} "
                            f"({100 * row[t + 'share']:.1f}% cold)"
                            for name, t in (("f32", ""), ("bf16", "bf16_"))))
        del flush, clean
        # host cost of the wrapper and of F.conv2d: calls over the stages
        # in turn, no synchronize
        operands = [(kernel_operands(n, h, c, k, torch.float32, gen, device), k, s, act)
                    for (n, h, c, k, s, act) in shapes]
        conv_operands = [(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1).contiguous(), shift, k, s)
                         for (x, w, _, shift, _), k, s, _ in operands]

        def all_stages():
            for ops, _, s, act in operands:
                fused_depthwise(*ops, s, act)

        def all_convs():
            for x_cl, w_oihw, bias, k, s in conv_operands:
                F.conv2d(x_cl, w_oihw, bias, stride=s, padding=k // 2, groups=x_cl.shape[1])

        host_us = host_us_per_call(all_stages) / len(operands)
        library_host_us = host_us_per_call(all_convs) / len(operands)
    keys = [t + m for t in ("", "bf16_") for m in ("ms", "device_ms", "cold_ms", "cold_clean_ms", "plain_ms",
                                                   "library_ms", "library_device_ms", "library_cold_ms",
                                                   "bound_ms")]
    totals = {key: sum(r[key] for r in rows) for key in keys}
    totals["host_us_per_launch"] = host_us
    totals["library_host_us_per_call"] = library_host_us
    for name, t in (("f32", ""), ("bf16", "bf16_")):
        totals[t + "share"] = totals[t + "bound_ms"] / totals[t + "cold_ms"]
        log(f"{len(rows)} stages at batch 32, {name}: kernel {totals[t + 'ms']:.4f} ms back to back / "
            f"{totals[t + 'device_ms']:.4f} ms device / {totals[t + 'cold_ms']:.4f} ms cold, F.conv2d(groups=C, "
            f"bias) without the activation {totals[t + 'library_ms']:.4f} / {totals[t + 'library_device_ms']:.4f} / "
            f"{totals[t + 'library_cold_ms']:.4f} ms, plain {totals[t + 'plain_ms']:.4f} ms, bound "
            f"{totals[t + 'bound_ms']:.4f} ms ({sum(r[t + 'bytes'] for r in rows) / 1e6:.1f} MB at "
            f"{rates[0] / 1e12:.2f} TB/s, H100 {rates[2]}); cold share of the bound {100 * totals[t + 'share']:.1f}%; "
            f"cold with a clean L2 (no write-back of the flush) {totals[t + 'cold_clean_ms']:.4f} ms")
    log(f"host cost: wrapper {host_us:.2f} us per launch, F.conv2d {library_host_us:.2f} us per call "
        f"({len(rows)} stages in turn, no synchronize)")
    return {"rows": rows, "totals": totals, "bytes": sum(r["bytes"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"}


def _fresh_bundle(tmp: str) -> tuple[str, object]:
    """MobileNetV3-Large 1.0 at 224 with seeded weights, exported as the
    serving bundle; returns its directory and the net."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle

    net, _ = mbv3_depthwise_shapes(32)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    bundle_dir = os.path.join(tmp, "bundle")
    export_bundle(net, params, random_bn_state(net, gen), bundle_dir, model_name="mobilenet_v3_large")
    return bundle_dir, net


def _k1_accounting(graphs: list[dict], wrapper_launches: int, per_forward: int) -> dict:
    """K1's launches in one run of the engine, from its graph report (every
    key was captured in this run): each graph must hold ``per_forward``
    launches per forward it runs (K for a fused key, R for a ring), its
    eager warm run the same, and the wrapper must have launched nothing
    outside warm runs and captures (every dispatch a replay). The card ran
    the warm runs' launches plus replays x captured launches: a product of
    counters, held against the device's own count by ``_profiled_k1``."""
    bad = [g for g in graphs if g["k1_launches"] != per_forward * g["key"][2]
           or g["warm_k1"] != per_forward * g["key"][2]]
    if bad:
        raise AssertionError(f"graphs without {per_forward} K1 launches per forward: {bad}")
    warm = sum(g["warm_k1"] for g in graphs)
    captured = sum(g["k1_launches"] for g in graphs)
    if wrapper_launches != warm + captured:
        raise AssertionError(f"the wrapper launched {wrapper_launches} times, but warm runs and captures account "
                             f"for {warm + captured}: a dispatch ran eagerly")
    replayed = sum(g["replays"] * g["k1_launches"] for g in graphs)
    return {"launches": warm + replayed, "replayed": replayed, "captured": captured, "warm": warm,
            "forwards": sum(g["key"][2] * (1 + g["replays"]) for g in graphs)}


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device us, count) of every kernel a ``torch.profiler`` run saw
    on the card, busiest first. Device-side events only: a CPU op's self
    device time repeats the kernels it launched."""
    import torch

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    return sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0), key=lambda r: -r[1])


def _profiled_k1(prof, want: int, what: str) -> int:
    """K1's launches as the card's own trace counts them (CUPTI sees each
    kernel of a graph replay); fails unless they are ``want``."""
    count = sum(c for name, _, c in _device_kernels(prof) if "fused_dw_kernel" in name)
    if count != want:
        raise AssertionError(f"{what}: the profiler saw {count} fused_dw_kernel launches on the card, "
                             f"the graphs' replays account for {want}")
    return count


def _cpu_check(tag: str, on_card, on_cpu) -> float:
    import numpy as np

    if on_card.shape != on_cpu.shape or not np.isfinite(on_card).all():
        raise AssertionError(f"{tag}: bad logits from the card: shape {on_card.shape}")
    err = float(np.abs(on_card - on_cpu).max())
    if not np.all(np.abs(on_card - on_cpu) <= SLICE_ATOL + SLICE_RTOL * np.abs(on_cpu)):
        raise AssertionError(f"{tag}: card logits differ from the CPU forward by {err:.3e}")
    return err


def _ladder_keys(cfg) -> set:
    """The (kind, key) of every graph an engine of ``cfg`` captures at
    warmup: each (bucket, size), the fused (cap, size, K) and the ring."""
    cap = max(cfg.serve.buckets)
    keys = set()
    for size in set(cfg.serve.image_sizes or ()) | {cfg.data.image_size}:
        keys |= {("k", (b, size, 1)) for b in cfg.serve.buckets}
        if cfg.serve.fuse_chunks.enable:
            keys |= {("k", (cap, size, k)) for k in cfg.serve.fuse_chunks.ladder if k >= 2}
        if cfg.serve.ring.enable:
            keys.add(("ring", (cap, size, cfg.serve.ring.slots)))
    return keys


def phase_load(device, tmp: str, bundle_dir: str, tag: str, overrides: list[str], per_forward: int) -> dict:
    """One load of the shipped config (plus ``overrides``) on the card.

    First the port's entry point, ``cli/serve.py``'s ``run(cfg, device)``:
    it loads the bundle, captures every key at warmup and drives
    SERVE_REQUESTS single-image requests from SERVE_CLIENTS closed-loop
    clients through the pipelined batcher. The counts are set to 0 just
    before and read just after. Gates: every request completes, 0 shed, 0
    rejected; the graphs are the ladder's, each captured once at warmup;
    every dispatch is a replay; K1 runs ``per_forward`` launches per
    forward and none outside warm runs and captures.

    Then traffic that single images do not make, on an engine built the
    same way (``engine_kwargs``, ``_make_batcher``): a bulk client sending
    requests of more than 32 rows to ``engine.predict`` (the fused ladder)
    beside a burst client submitting BURST_IMAGES images at once, BURSTS
    times (a queue deep enough for the ring), under ``torch.profiler``.
    Gates: every dispatch a replay, fused dispatches (and ring windows with
    the ring) ran, the card's own count of K1 launches equals the graphs'
    replays x captured launches, and the logits match the port's CPU
    forward (SLICE_ATOL/SLICE_RTOL)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", f"serve.requests={SERVE_REQUESTS}",
                     f"serve.clients={SERVE_CLIENTS}", "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_' + tag)}", *overrides])
    wire = cfg.serve.quant.wire

    # the main path: the CLI's run(), counts at 0 just before, read just after
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    result = serve_cli.run(cfg, device=str(device))
    run_s = time.perf_counter() - t0
    launches = fused_depthwise.launches
    graphs = result["graphs"]
    k1 = _k1_accounting(graphs, launches, per_forward)
    keys = {(g["kind"], tuple(g["key"])) for g in graphs}
    result.update(tag=tag, overrides=overrides, run_s=run_s, k1=k1, wrapper_launches=launches)
    order = result.pop("latency_ms_by_completion")
    slowest = sorted(range(len(order)), key=lambda i: -order[i])[:3]
    log(f"load {tag} (cli.serve.run): {result['completed']}/{result['requests']} requests, {result['shed']} shed, "
        f"{result['rejected_full']} rejected, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} ms, "
        f"p99 {result['p99_ms']:.2f} ms (slowest by completion index: "
        + ", ".join(f"#{i} {order[i]:.2f} ms" for i in slowest)
        + f"); {result['dispatches']} dispatches = {result['replays']} graph replays; {result['warmup_forwards']} "
        f"captures for {len(graphs)} graphs; K1 {k1['launches']} launches = {k1['warm']} in warm runs + "
        f"{k1['replayed']} in replays ({per_forward} x {k1['forwards']} forwards; wrapper {launches} = warm "
        f"runs + captures); {run_s:.2f} s")
    if result["completed"] != SERVE_REQUESTS or result["shed"] or result["rejected_full"] or result["client_crashes"]:
        raise AssertionError(f"load {tag}: not every request completed: {result}")
    if keys != _ladder_keys(cfg) or result["warmup_forwards"] != len(graphs):
        raise AssertionError(f"load {tag}: graphs {sorted(keys)} from {result['warmup_forwards']} captures, the "
                             f"ladder is {sorted(_ladder_keys(cfg))}")
    if not result["dispatches"] or result["dispatches"] != result["replays"]:
        raise AssertionError(f"load {tag}: {result['dispatches']} dispatches, {result['replays']} replays")

    # bulk and burst traffic on an engine built the same way, profiled
    reg = get_registry()
    rng = np.random.RandomState(7)

    def images(n):
        if wire == "uint8":
            return rng.randint(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
        return rng.normal(0, 1, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)

    bulk_in = [images(BULK_ROWS[i % len(BULK_ROWS)]) for i in range(BULK_REQUESTS)]
    burst_in = images(BURST_IMAGES)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), **serve_cli.engine_kwargs(cfg))
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    graph_mb = (torch.cuda.memory_reserved(device) - mem0) / 1e6
    warm, wrapper0 = reg.snapshot(), fused_depthwise.launches
    batcher = serve_cli._make_batcher(cfg, engine).start()
    box: dict = {"bulk": [], "burst": [], "errors": []}

    def bulk():
        try:
            for x in bulk_in:
                t = time.perf_counter()
                box["bulk"].append((engine.predict(x), (time.perf_counter() - t) * 1e3))
        except BaseException as e:  # re-raised below, in the main thread
            box["errors"].append(e)

    def burst():
        try:
            for _ in range(BURSTS):
                futs = [batcher.submit(img) for img in burst_in]
                box["burst"].append(np.stack([f.result(timeout=120) for f in futs]))
        except BaseException as e:  # re-raised below, in the main thread
            box["errors"].append(e)

    closed_loop_image = serve_cli._synthetic_image(np.random.RandomState(0), IMAGE_SIZE, wire)
    extra = [threading.Thread(target=bulk), threading.Thread(target=burst)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_load = time.perf_counter()
        try:
            for t in extra:
                t.start()
        finally:
            for t in extra:
                t.join()
            load_s = time.perf_counter() - t_load
            single = batcher.submit(closed_loop_image).result(timeout=60) if not box["errors"] else None
            batcher.stop()
        torch.cuda.synchronize()
    after = reg.snapshot()
    if box["errors"]:
        raise box["errors"][0]

    def delta(key: str) -> int:
        return int(after.get(key, 0) - warm.get(key, 0))

    report = engine.graph_report()
    replayed = sum(g["replays"] * g["k1_launches"] for g in report)
    traffic = {"warmup_s": warmup_s, "graph_mb": graph_mb, "dispatches": delta("serve.dispatch_seconds.count"),
               "replays": delta("serve.graph_replays"), "fused_dispatches": delta("serve.fused_dispatches"),
               "ring_dispatches": delta("serve.ring_dispatches"), "h2d_bytes": delta("serve.h2d_bytes"),
               "captures": delta("serve.compile_seconds.count"),
               "eager_k1": fused_depthwise.launches - wrapper0,
               "k1_replayed": replayed, "k1_device_count": _profiled_k1(prof, replayed, f"load {tag} traffic"),
               "bulk_ms": [ms for _, ms in box["bulk"]], "quant_mode": engine.quant_mode,
               "images_per_s": (sum(len(b) for b in bulk_in) + BURSTS * BURST_IMAGES + 1) / load_s}
    result["traffic"] = traffic
    log(f"load {tag} traffic: {BULK_REQUESTS} bulk requests of {'/'.join(map(str, BULK_ROWS))} rows "
        f"({min(traffic['bulk_ms']):.1f}-{max(traffic['bulk_ms']):.1f} ms each) beside {BURSTS} bursts of "
        f"{BURST_IMAGES}, {traffic['images_per_s']:.0f} images/s under the profiler; {traffic['dispatches']} "
        f"dispatches = {traffic['replays']} graph replays ({traffic['fused_dispatches']} fused, "
        f"{traffic['ring_dispatches']} ring), {traffic['captures']} captures; K1 on the card (profiler) "
        f"{traffic['k1_device_count']} launches = replays x captured launches {replayed}, {traffic['eager_k1']} "
        f"eager; warmup {warmup_s:.2f} s, {len(report)} graphs, {graph_mb:.1f} MB reserved; {engine.quant_mode}")
    if len(box["bulk"]) != BULK_REQUESTS or len(box["burst"]) != BURSTS:
        raise AssertionError(f"load {tag}: {len(box['bulk'])} bulk requests, {len(box['burst'])} bursts completed")
    if (traffic["dispatches"] != traffic["replays"] or traffic["captures"] or traffic["eager_k1"]
            or not traffic["fused_dispatches"]):
        raise AssertionError(f"load {tag} traffic: {traffic}")
    if engine.ring_slots and not traffic["ring_dispatches"]:
        raise AssertionError(f"load {tag}: the ring never engaged")
    del engine

    # the card's logits against the port's CPU forward of the same bundle
    cpu = InferenceEngine(load_bundle(bundle_dir), device="cpu", buckets=(32,), wire=wire,
                          wire_mean=cfg.data.mean, wire_std=cfg.data.std)
    errs = [_cpu_check(f"{tag} bulk", box["bulk"][0][0], cpu.predict(bulk_in[0])),
            _cpu_check(f"{tag} burst", box["burst"][-1][:CPU_ROWS], cpu.predict(burst_in[:CPU_ROWS])),
            _cpu_check(f"{tag} closed loop", single[None], cpu.predict(closed_loop_image[None]))]
    result["logits_max_abs_err"] = max(errs)
    log(f"load {tag} logits, card vs CPU forward (f32): max |err| {max(errs):.3e} "
        f"(atol {SLICE_ATOL}, rtol {SLICE_RTOL}) over a {BULK_ROWS[0]}-row bulk request, "
        f"{CPU_ROWS} burst rows and the closed-loop image")
    return result


def phase_loads(device, tmp: str) -> dict:
    """The three loads of phase 4: the shipped config as shipped (fusion and
    overlap on), then with the ring, then with the uint8 wire."""
    bundle_dir, net = _fresh_bundle(tmp)
    per_forward = sum(1 for blk in net.blocks for _ in blk._branches())
    loads = {tag: phase_load(device, tmp, bundle_dir, tag, overrides, per_forward)
             for tag, overrides in LOADS}
    return {"bundle_dir": bundle_dir, "per_forward": per_forward, "loads": loads,
            "launches": sum(r["k1"]["launches"] for r in loads.values())}


def phase_graph_checks(device, tmp: str, bundle_dir: str) -> dict:
    """Bit for bit on the card: eager forward against graph replay per
    bucket; fused K=2 and K=4 against per-chunk; ring fills 1..R against the
    per-batch path at the same bucket; overlap on against off; two unsynced
    in-flight dispatches of one key against their own eager results; the
    shift-free u8 wire against the f32 wire fed ``normalize_reference``
    pixels. Then an int8 bundle against its own dequantized f32 forward,
    within the JAX package's int8 gate (top-1 agreement >=
    ``serve.quant.int8_top1_min``)."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import QuantConfig
    from yet_another_mobilenet_series_tpu_torch.models import convert
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve import quant
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import InferenceBundle, export_bundle, load_bundle

    bundle = load_bundle(bundle_dir)
    rng = np.random.RandomState(11)
    dev = str(device)
    r = 4
    eng = InferenceEngine(bundle, device=dev, fuse_ladder=(2, 4), ring_slots=r)
    eng.warmup()
    failures = []

    def same(tag, a, b):
        if not np.array_equal(a, b):
            failures.append((tag, float(np.abs(a - b).max())))

    def x(n):
        return rng.normal(0, 1, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)

    def eager(a):
        return eng._forward(torch.from_numpy(a).to(device)).cpu().numpy()

    for b in eng.buckets:
        a = x(b)
        same(f"graph vs eager, bucket {b}", eng.predict(a), eager(a))
    for k in (2, 4):
        a = x(32 * k)
        same(f"fused K={k} vs per-chunk", eng.predict(a), np.concatenate([eng.predict(a[i: i + 32])
                                                                          for i in range(0, 32 * k, 32)]))
    per_batch = InferenceEngine(bundle, device=dev, buckets=(32,))
    for fill in range(1, r + 1):
        parts = [x(32) for _ in range(fill - 1)] + [x(17)]
        out = eng.ring_dispatch([eng.ring_stage(p) for p in parts]).result()
        same(f"ring fill {fill}", out, np.concatenate([per_batch.predict(p) for p in parts]))
    over = InferenceEngine(bundle, device=dev, fuse_ladder=(2, 4), overlap_staging=True, staging_slots=2)
    batches = [x(n) for n in (5, 32, 5, 70, 5, 128)]
    handles = [over.predict_async(a) for a in batches]
    for a, h in zip(batches, handles):
        same(f"overlap on vs off, {len(a)} rows", h.result(), eng.predict(a))
    a1, a2 = x(32), x(32)
    h1, h2 = eng.predict_async(a1), eng.predict_async(a2)  # two replays of one key, unsynced
    same("in-flight dispatch 2 of one key", h2.result(), eager(a2))
    same("in-flight dispatch 1 of one key", h1.result(), eager(a1))
    u8 = InferenceEngine(bundle, device=dev, wire="uint8", fuse_ladder=(2,))
    raw = rng.randint(0, 256, (40, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
    if not u8.wire_parity_exact:
        raise AssertionError("the u8 engine is not shift-free")
    same("u8 wire vs f32 wire on normalize_reference pixels", u8.predict(raw),
         InferenceEngine(bundle, device=dev, fuse_ladder=(2,)).predict(quant.normalize_reference(raw)))
    log(f"graph checks (bit for bit): {len(eng.buckets)} buckets, fused K=2/4, ring fills 1..{r}, overlap, "
        f"2 in-flight dispatches, u8 wire: {len(failures)} failures {failures}")
    if failures:
        raise AssertionError(f"graph results differ bitwise: {failures}")

    # int8: the bundle's own f32 weights quantized with the gated pass (the
    # gate is recorded, not enforced, on these random weights), served on the
    # card against the f32 bundle of its dequantized weights
    gate = QuantConfig().int8_top1_min
    net = bundle.net
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    calib = quant.normalize_reference(rng.randint(0, 256, (16, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8))
    q_dir = export_bundle(net, params, random_bn_state(net, gen), os.path.join(tmp, "int8"), quant_weights="int8",
                          calib_images=calib, int8_top1_min=0.0, device=dev)
    qb = load_bundle(q_dir)
    if not qb.quant["calib"]["device"].startswith("cuda"):
        raise AssertionError(f"the int8 calibration ran on {qb.quant['calib']['device']}, not on the card")
    with np.load(os.path.join(q_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    deq = {}
    for key, v in flat.items():
        if key.endswith("/w_q"):  # a/w_q + a/w_scale -> a/w
            deq[key[:-2]] = quant.dequantize_array(v, flat[key[:-1] + "scale"])
        elif not key.endswith("/w_scale"):
            deq[key] = v
    f32 = InferenceBundle(net=net, params=convert.from_jax(deq), meta={})
    a = rng.randint(0, 256, (64, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
    got = InferenceEngine(qb, device=dev, wire="uint8").predict(a)
    want = InferenceEngine(f32, device=dev, wire="uint8").predict(a)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    err = float(np.abs(got - want).max())
    log(f"int8 bundle ({qb.quant['quantized_tensors']} tensors, {qb.quant['bytes_int8'] / 1e6:.2f} MB against "
        f"{qb.quant['bytes_f32'] / 1e6:.2f} MB; export-time top-1 agreement with the f32 fold "
        f"{qb.quant['top1_agreement']:.3f} on 16 calibration images, calibrated on {qb.quant['calib']['device']}) on "
        f"the card vs its dequantized f32 forward: "
        f"top-1 agreement {agree:.3f} (gate {gate}), max |err| {err:.3e}, bitwise {np.array_equal(got, want)}")
    if agree < gate or not np.isfinite(got).all():
        raise AssertionError(f"int8 bundle agrees with its dequantized forward on {agree:.3f} < {gate}")
    return {"failures": failures, "int8_agreement": agree, "int8_max_abs_err": err,
            "int8_export_agreement": qb.quant["top1_agreement"]}


def phase_forward(device, bundle_dir: str, card: str, per_forward: int) -> dict:
    """Where a forward's time goes on the card, eager against graph replay,
    per bucket: the host's enqueue per forward, the device time per forward
    back to back (CUDA events) and on the device alone, the serving path's
    host cost per dispatch (``predict_async``: staging, copy, replay); the
    fused K=4 graph per chunk and the ring R=4 graph per slot; graph memory;
    a new thread's first forward; and a torch.profiler breakdown of five
    batch-32 graph replays by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    log(f"timings on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, f32, eager forward against graph replay")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(device)
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), fuse_ladder=(2, 4), ring_slots=4,
                             overlap_staging=True)
    engine.warmup()
    torch.cuda.synchronize()
    out: dict = {"buckets": {}, "graph_mb": (torch.cuda.memory_reserved(device) - mem0) / 1e6}
    gen = torch.Generator(device=device).manual_seed(2)
    rng = np.random.RandomState(3)

    def enqueue_ms(fn, iters=20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return ms

    def idle_host_ms(fn, iters=10) -> float:
        """Host time of one call made with the card idle (no fence to wait
        on): what one dispatch costs the host by itself."""
        total = 0.0
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / iters * 1e3

    for b in engine.buckets:
        x = torch.randn((b, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
        x_np = rng.normal(0, 1, (b, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
        graph = engine._compiled[("default", b, IMAGE_SIZE, 1)].graph
        row = {"eager_device_ms": cuda_time_ms(lambda: engine._forward(x), iters=20),
               "eager_enqueue_ms": enqueue_ms(lambda: engine._forward(x)),
               "graph_device_ms": cuda_time_ms(graph.replay, iters=20),
               "graph_device_alone_ms": device_time_ms(graph.replay, iters=20),
               "graph_enqueue_ms": enqueue_ms(graph.replay),
               "dispatch_host_ms": idle_host_ms(lambda: engine.predict_async(x_np)),
               "dispatch_pace_ms": enqueue_ms(lambda: engine.predict_async(x_np)),
               "predict_ms": enqueue_ms(lambda: engine.predict(x_np), iters=5)}
        out["buckets"][b] = row
        log(f"forward bucket {b:2d}: eager {row['eager_device_ms']:.3f} ms back to back, host enqueue "
            f"{row['eager_enqueue_ms']:.3f} ms; graph replay {row['graph_device_ms']:.3f} ms back to back / "
            f"{row['graph_device_alone_ms']:.3f} ms on the device alone, host enqueue {row['graph_enqueue_ms']:.4f} "
            f"ms; serving dispatch (predict_async, overlap) {row['dispatch_host_ms']:.3f} ms of host with the card "
            f"idle, {row['dispatch_pace_ms']:.3f} ms each back to back (2 staging slots), predict synchronized "
            f"{row['predict_ms']:.3f} ms")
    k4 = engine._compiled[("default", 32, IMAGE_SIZE, 4)].graph
    ring = engine._compiled[("default", 32, IMAGE_SIZE, 4, "ring")].graph
    out["fused_k4_ms_per_chunk"] = cuda_time_ms(k4.replay, iters=10) / 4
    out["ring_r4_ms_per_slot"] = cuda_time_ms(ring.replay, iters=10) / 4
    # the overlap path's device-to-device copy into a batch-32 graph's
    # static input, from a staging slot's device buffer
    exe32 = engine._compiled[("default", 32, IMAGE_SIZE, 1)]
    slot_dev = engine._staging[(32, IMAGE_SIZE, 1)].slots[0].dev
    out["d2d_copy_ms"] = cuda_time_ms(lambda: exe32.x.copy_(slot_dev), iters=20)
    log(f"batch 32 per forward: K=1 graph {out['buckets'][32]['graph_device_ms']:.3f} ms, fused K=4 graph "
        f"{out['fused_k4_ms_per_chunk']:.3f} ms per chunk, ring R=4 graph {out['ring_r4_ms_per_slot']:.3f} ms per "
        f"slot; the overlap path's copy into the static input {out['d2d_copy_ms'] * 1e3:.1f} us "
        f"({exe32.x.numel() * 4 / 1e6:.1f} MB); graphs and staging of this engine (6 keys, overlap): "
        f"{out['graph_mb']:.1f} MB reserved")

    # the first forward of a thread, eager and through the graph: PyTorch
    # keeps cuDNN/cuBLAS handles per thread, which a replay does not use
    x1 = torch.randn((1, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
    x1_np = x1.cpu().numpy()

    def eager_ms() -> float:
        t0 = time.perf_counter()
        engine._forward(x1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def graph_ms() -> float:
        t0 = time.perf_counter()
        engine.predict(x1_np)
        return (time.perf_counter() - t0) * 1e3

    def in_new_thread(fn) -> list[float]:
        box: dict = {}

        def run():
            try:
                box["ms"] = [fn(), fn()]
            except BaseException as e:  # re-raised below, in the main thread
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in box:
            raise box["error"]
        return box["ms"]

    out["thread_first_forward_ms"] = {"graph_new_thread": in_new_thread(graph_ms),
                                      "graph_main": graph_ms(),
                                      "eager_new_thread": in_new_thread(eager_ms), "eager_main": eager_ms()}
    t = out["thread_first_forward_ms"]
    log(f"batch-1 forward, synchronized: graph (predict) main thread {t['graph_main']:.2f} ms, a new thread's "
        f"first and second {t['graph_new_thread'][0]:.2f} / {t['graph_new_thread'][1]:.2f} ms; eager main "
        f"{t['eager_main']:.2f} ms, a new thread's {t['eager_new_thread'][0]:.2f} / {t['eager_new_thread'][1]:.2f} ms")

    graph32 = engine._compiled[("default", 32, IMAGE_SIZE, 1)].graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            graph32.replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = _device_kernels(prof)
    busy_us = sum(us for _, us, _ in kernels)
    dw_count = _profiled_k1(prof, 5 * per_forward, "5 batch-32 graph replays")
    dw_us = sum(us for name, us, _ in kernels if "fused_dw_kernel" in name)
    out["profile"] = {"wall_us": wall_us, "device_us": busy_us, "fused_dw_us": dw_us, "fused_dw_count": dw_count,
                      "top": [{"kernel": n[:120], "device_us": us, "count": c} for n, us, c in kernels[:15]]}
    log(f"profile, 5 graph replays at batch 32: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({100 * busy_us / wall_us:.1f}%); fused_dw_kernel {dw_count} launches, {dw_us / 1e3:.3f} ms "
        f"({100 * dw_us / busy_us:.1f}% of device time)")
    for name, us, c in kernels[:8]:
        log(f"  {us / 5e3:8.4f} ms/forward  x{c // 5:<4d} {name[:100]}")
    return out


def _train_cfg(tmp: str, tag: str, *overrides: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                      f"train.log_dir={os.path.join(tmp, 'train_' + tag)}", *overrides])


def _scaled_max(a: dict, b: dict) -> float:
    """max |a - b| / (1 + |b|) over two trees of tensors."""
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    return max(float(((fa[k].cpu() - fb[k].cpu()).abs() / (1.0 + fb[k].cpu().abs())).max()) for k in fb)


def phase_train_parity(device, tmp: str) -> dict:
    """One f32 train step of MobileNetV3-Large at batch TRAIN_CHECK_BATCH on
    the card and on the port's CPU path, from one state and one batch (the
    shipped config in f32, dropout off so that no random draw differs, no
    warmup so that the LR is not 0). TF32 is off (main)."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = _train_cfg(tmp, "parity", "train.compute_dtype=float32", "model.dropout=0.0", "schedule.warmup_epochs=0")
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, TRAIN_CHECK_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    step = steps.make_train_step(net, cfg, opt, lr_fn)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    y = (np.arange(TRAIN_CHECK_BATCH) * 37 % cfg.model.num_classes).astype(np.int32)
    runs = []
    for dev in (torch.device("cpu"), device):
        ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=dev)
        batch = {"image": torch.from_numpy(x).to(dev), "label": torch.from_numpy(y).to(dev)}
        t0 = time.perf_counter()
        new, m = step(ts, batch, torch.Generator(device=dev).manual_seed(0))
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        runs.append((new, loss, norm, time.perf_counter() - t0))
    (cpu, loss_c, norm_c, s_c), (card, loss_g, norm_g, s_g) = runs
    res = {"loss_cpu": loss_c, "loss_card": loss_g, "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm_cpu": norm_c, "grad_norm_card": norm_g, "grad_norm_rel": abs(norm_g - norm_c) / abs(norm_c),
           "params": _scaled_max(card.params, cpu.params), "bn_state": _scaled_max(card.state, cpu.state),
           "opt_nu": _scaled_max(card.opt_state["nu"], cpu.opt_state["nu"]), "cpu_s": s_c, "card_s": s_g}
    log(f"train step, card vs CPU (f32, TF32 off, batch {TRAIN_CHECK_BATCH}, lr {float(lr_fn(0)):.4g}): loss "
        f"{loss_g:.7f} / {loss_c:.7f} (rel {res['loss_rel']:.2e}, tol {TRAIN_LOSS_TOL}), grad norm {norm_g:.6f} / "
        f"{norm_c:.6f} (rel {res['grad_norm_rel']:.2e}, tol {TRAIN_NORM_TOL}); |diff|/(1+|x|): params "
        f"{res['params']:.2e} (tol {TRAIN_PARAM_TOL}), BN state {res['bn_state']:.2e}, nu {res['opt_nu']:.2e}; "
        f"step {s_g:.2f} s on the card (first), {s_c:.2f} s on the CPU")
    if (res["loss_rel"] > TRAIN_LOSS_TOL or res["grad_norm_rel"] > TRAIN_NORM_TOL or res["params"] > TRAIN_PARAM_TOL
            or not np.isfinite(loss_g)):
        raise AssertionError(f"the card's train step differs from the CPU path's: {res}")
    return res


def _record_syncs(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: returns
    its result and every synchronizing CUDA call's (message, stack of
    function names)."""
    import traceback
    import warnings

    import torch

    syncs: list = []

    def record(message, category, filename, lineno, file=None, line=None):
        syncs.append((str(message)[:80], [f.name for f in traceback.extract_stack()]))

    mode = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return out, syncs


def phase_train_run(device, tmp: str) -> tuple[dict, object, object]:
    """The shipped config through cli/train.py (``train()``: ``run()`` that
    also returns the state), TRAIN_STEPS steps at batch TRAIN_BATCH, with
    every synchronizing CUDA call recorded with its stack."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    cfg = _train_cfg(tmp, "shipped", f"data.fake_train_size={TRAIN_BATCH * TRAIN_STEPS}", "train.epochs=1",
                     f"train.log_every={TRAIN_LOG_EVERY}")
    if cfg.train.batch_size != TRAIN_BATCH or cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"the shipped config changed: batch {cfg.train.batch_size}, {cfg.train.compute_dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    (summary, ts, net), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    wall = time.perf_counter() - t0
    k1 = fused_depthwise.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    in_step = [(msg, stack) for msg, stack in syncs if "_one_step" in stack]
    sites: dict = {}
    for msg, stack in syncs:
        where = next((name for name in reversed(stack) if name in ("_log_point", "evaluate", "_train", "train")),
                     "?")
        sites[where] = sites.get(where, 0) + 1
    res = {k: v for k, v in summary.items() if k != "log"}
    res.update(wall_s=wall, peak_allocated_gb=peak_gb, syncs=len(syncs), sync_sites=sites,
               syncs_in_a_step=len(in_step), k1_launches=k1,
               losses=[row["loss"] for row in summary["log"]])
    log(f"train run (cli/train.py, apps/mobilenet_v3_large.yml: bf16, batch {TRAIN_BATCH}, TF RMSProp, EMA; fake "
        f"data): {summary['steps']} steps (counter {summary['step']}), {summary['finite_steps']} finite, on "
        f"{summary['device']}; log-point losses {[round(v, 4) for v in res['losses']]}; EMA eval top-1 "
        f"{summary['eval_top1']:.4f} loss {summary['eval_loss']:.4f} over {summary['eval_n']}; {wall:.1f} s "
        f"(set-up, {summary['seconds']:.1f} s of steps and eval); peak allocated {peak_gb:.2f} GB; synchronizing "
        f"calls {len(syncs)} by site {sites}, {len(in_step)} inside a step; K1 launches {k1}")
    if (summary["finite_steps"] != TRAIN_STEPS or summary["steps"] != TRAIN_STEPS or summary["step"] != TRAIN_STEPS
            or not summary["device"].startswith("cuda")):
        raise AssertionError(f"train run: {res}")
    if in_step:
        raise AssertionError(f"train run: {len(in_step)} host syncs inside a step, e.g. {in_step[0]}")
    if k1:
        raise AssertionError(f"train run: K1 launched {k1} times on the training path")
    return res, ts, net


def phase_overfit(device, tmp: str) -> dict:
    """OVERFIT_STEPS steps of the shipped config on one repeated batch at a
    constant LR (tests/test_train.py's overfit test at full size)."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = _train_cfg(tmp, "overfit", "schedule.schedule=constant", "schedule.scale_by_batch=false",
                     f"schedule.base_lr={OVERFIT_LR}", "schedule.warmup_epochs=0")
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, OVERFIT_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=device)
    step = steps.make_train_step(net, cfg, opt, lr_fn)
    gen = torch.Generator(device=device).manual_seed(3)
    batch = {"image": torch.randn((OVERFIT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
             "label": torch.arange(OVERFIT_BATCH, device=device, dtype=torch.int32) % 4}
    losses = []
    for _ in range(OVERFIT_STEPS):
        ts, m = step(ts, batch, gen)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    factor = losses[-1] / losses[0]
    log(f"overfit ({OVERFIT_STEPS} steps on one batch of {OVERFIT_BATCH}, bf16, constant lr {OVERFIT_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({factor:.3f}x, gate < {OVERFIT_FACTOR}); "
        f"every 5th: {[round(v, 3) for v in losses[::5]]}")
    if not factor < OVERFIT_FACTOR:
        raise AssertionError(f"overfit: the loss fell only to {factor:.3f}x of its first value")
    return {"losses": losses, "factor": factor}


def phase_export_serve(device, tmp: str, ts, net, per_forward: int) -> dict:
    """The trained EMA weights through export_bundle (a float32 bundle) into
    the engine on the card: its logits against Network.apply(train=False) of
    the same weights on the card, within FOLD_ATOL, and K1's launches in one
    served forward counted by the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    def cpu(tree):
        return unflatten_tree({k: v.detach().cpu() for k, v in flatten_tree(tree).items()})

    bundle_dir = export_bundle(net, cpu(ts.ema_params), cpu(ts.ema_state), os.path.join(tmp, "trained"),
                               model_name="mobilenet_v3_large_trained", device=str(device))
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    (graph,) = engine.graph_report()
    if graph["k1_launches"] != per_forward:
        raise AssertionError(f"the served graph of the trained weights holds {graph['k1_launches']} K1 launches")
    x = np.random.RandomState(5).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    # a first profiled window, discarded, then the counted one: a window of
    # one forward on a graph never replayed under the profiler saw 8 of its
    # 15 K1 launches once (phases 4 and 6 count many replays and never
    # missed one)
    seen = []
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SERVED_FORWARDS):
                got = engine.predict(x)
            torch.cuda.synchronize()
        seen.append(sum(c for name, _, c in _device_kernels(prof) if "fused_dw_kernel" in name))
    k1 = _profiled_k1(prof, per_forward * SERVED_FORWARDS, f"{SERVED_FORWARDS} served forwards of the trained weights")
    with torch.inference_mode():
        want = net.apply(ts.ema_params, ts.ema_state, torch.from_numpy(x).to(device)).cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"train -> export -> serve: the engine's logits (f32, bucket {TRAIN_CHECK_BATCH}) vs Network.apply of the "
        f"EMA weights on the card: max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| "
        f"{float(np.abs(want).max()):.3e}; "
        f"K1 {k1} launches in {SERVED_FORWARDS} forwards (profiler; {seen[0]} in the discarded first window), "
        f"{graph['k1_launches']} captured in the graph")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"served logits of the trained weights differ by {err:.3e}")
    return {"max_abs_err": err, "k1_launches": k1 // SERVED_FORWARDS, "k1_profiled": seen,
            "max_logit": float(np.abs(want).max())}


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, for the training profile's breakdown."""
    if "multi_tensor_apply" in name:
        return "optimizer+EMA (multi_tensor_apply)"
    if any(k in name for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")):
        return "convolutions and matmuls"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in name.lower():
        return "copies and casts"
    return "elementwise"


def phase_train_timing(device, tmp: str) -> dict:
    """ms per step (synchronized) and images/s of the trainer's step (with
    its device-side data) in bf16 and f32 at TRAIN_BATCH, peak memory, then
    PROFILED_STEPS bf16 steps under torch.profiler, and the optimizer update
    with EMA timed alone by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.train import ema as ema_lib, optim

    out: dict = {}
    fake = None
    for dtype in ("bfloat16", "float32"):
        cfg = _train_cfg(tmp, "timing_" + dtype, f"train.compute_dtype={dtype}")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
        net = get_model(cfg.model, IMAGE_SIZE)
        trainer = train_cli.Trainer(cfg, net, device)
        fake = fake or pipeline.FakeImages(cfg.data, device)
        batches = fake.train_batches(TRAIN_BATCH, 0)
        gen = torch.Generator(device=device).manual_seed(0)
        ts = trainer.init_state(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for _ in range(3):
            ts, m = trainer.train_step(ts, next(batches), gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMING_STEPS):
            ts, m = trainer.train_step(ts, next(batches), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMING_STEPS * 1e3
        row = {"ms_per_step": ms, "images_per_s": TRAIN_BATCH / ms * 1e3,
               "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9, "loss": float(m["loss"])}
        if dtype == "bfloat16":
            fused_depthwise.launches = 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_STEPS):
                    ts, m = trainer.train_step(ts, next(batches), gen)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            kernels = _device_kernels(prof)
            busy = sum(us for _, us, _ in kernels)
            opt_us = sum(us for name, us, _ in kernels if "multi_tensor_apply" in name)
            k1_dev = sum(c for name, _, c in kernels if "fused_dw_kernel" in name)
            shares: dict = {}
            for name, us, _ in kernels:
                shares[_kernel_kind(name)] = shares.get(_kernel_kind(name), 0.0) + us / busy
            row["profile"] = {"wall_us": wall_us, "device_us": busy, "busy_share": busy / wall_us,
                              "multi_tensor_apply_us": opt_us, "multi_tensor_apply_share": opt_us / busy,
                              "kernel_launches": sum(c for _, _, c in kernels), "k1_device_count": k1_dev,
                              "shares_by_kind": shares,
                              "top": [{"kernel": n[:120], "device_us": us, "count": c} for n, us, c in kernels[:12]]}
            # the optimizer update + EMA alone, on gradients shaped like the params
            flat = flatten_tree(ts.params)
            grads = unflatten_tree({k: torch.randn_like(v) * 1e-2 for k, v in flat.items()})

            def update():
                upd, new_opt = trainer.optimizer.update(grads, ts.opt_state, ts.params)
                new_p = optim.apply_updates(ts.params, upd)
                ema_lib.ema_update(cfg.ema, ts.ema_params, new_p, ts.step)
                ema_lib.ema_update(cfg.ema, ts.ema_state, ts.state, ts.step)

            row["optimizer_ema_ms"] = cuda_time_ms(update, iters=20)
            row["optimizer_ema_device_ms"] = device_time_ms(update, iters=20)
            row["optimizer_ema_share"] = row["optimizer_ema_ms"] / ms
            if k1_dev or fused_depthwise.launches:
                raise AssertionError(f"K1 ran in a train step: {k1_dev} on the device, {fused_depthwise.launches}")
        out[dtype] = row
        log(f"train step timing ({dtype}, batch {TRAIN_BATCH}, MobileNetV3-Large 1.0 at {IMAGE_SIZE}, step with its "
            f"device-side data): {ms:.2f} ms per step synchronized, {row['images_per_s']:.0f} images/s, peak "
            f"allocated {row['peak_allocated_gb']:.2f} GB")
        del trainer, ts, m, batches
        torch.cuda.empty_cache()
    p = out["bfloat16"]["profile"]
    log(f"profile, {PROFILED_STEPS} bf16 steps: device busy {p['device_us'] / 1e3:.2f} ms of {p['wall_us'] / 1e3:.2f} "
        f"ms wall ({100 * p['busy_share']:.1f}%), {p['kernel_launches'] // PROFILED_STEPS} kernels a step; "
        f"multi_tensor_apply (optimizer + EMA) {100 * p['multi_tensor_apply_share']:.2f}% of device time; the "
        f"update + EMA alone {out['bfloat16']['optimizer_ema_ms']:.3f} ms back to back (host-paced), "
        f"{out['bfloat16']['optimizer_ema_device_ms']:.3f} ms on the device alone "
        f"({100 * out['bfloat16']['optimizer_ema_share']:.2f}% of a step back to back); K1 {p['k1_device_count']} "
        f"launches; device time by kind: "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in sorted(p["shares_by_kind"].items(), key=lambda kv: -kv[1])))
    for row in p["top"][:10]:
        log(f"  {row['device_us'] / PROFILED_STEPS / 1e3:8.3f} ms/step  x{row['count'] // PROFILED_STEPS:<5d} "
            f"{row['kernel'][:100]}")
    return out


def _search_cfg(tmp: str, tag: str, *overrides: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{SEARCH_APP}", "dist.num_devices=1", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                      f"train.log_dir={os.path.join(tmp, 'search_' + tag)}", *overrides])


def phase_search_parity(device, tmp: str) -> dict:
    """One f32 search step of the supernet at batch TRAIN_CHECK_BATCH, with
    the penalty, then one prune event, on the card and on the port's CPU
    path from one state and batch, and once more on the card with cuDNN off
    (PyTorch's native convolutions): loss and penalty at TRAIN_LOSS_TOL, the
    masks after the event equal, grad norm and params at the larger of
    TRAIN_*_TOL and SEARCH_SPREAD_FACTOR times the card's cuDNN-vs-native
    spread. Every PARITY_DEAD_EVERY-th gamma of each prunable block starts
    at 0.01, below PARITY_GAMMA_THRESHOLD, so the event has deaths to agree
    on."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.nas import masking, penalty
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = _search_cfg(tmp, "parity", "train.compute_dtype=float32", "model.dropout=0.0", "schedule.warmup_epochs=0",
                      "prune.mask_interval=1", "prune.target_flops=0",
                      f"prune.gamma_threshold={PARITY_GAMMA_THRESHOLD}")
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, TRAIN_CHECK_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    y = (np.arange(TRAIN_CHECK_BATCH) * 37 % cfg.model.num_classes).astype(np.int32)
    runs = []
    try:
        for dev, cudnn in ((torch.device("cpu"), True), (device, True), (device, False)):
            torch.backends.cudnn.enabled = cudnn
            ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=dev)
            for k in ts.masks:
                ts.params["blocks"][k]["dw_bn"]["gamma"][::PARITY_DEAD_EVERY] = 0.01
            step = steps.make_train_step(net, cfg, opt, lr_fn,
                                         penalty_fn=penalty.make_penalty_fn(net, cfg.prune, 1, device=dev))
            event = masking.make_prune_event(net, cfg.prune, stop_step=1, device=dev)
            batch = {"image": torch.from_numpy(x).to(dev), "label": torch.from_numpy(y).to(dev)}
            new, m = step(ts, batch, torch.Generator(device=dev).manual_seed(0))
            masks, _ = event(new.params, new.masks, new.rho_mult, new.step)
            runs.append((new, float(m["loss"]), float(m["grad_norm"]), float(m["penalty"]),
                         {k: v.cpu() for k, v in masks.items()}))
    finally:
        torch.backends.cudnn.enabled = True
    (cpu, loss_c, norm_c, pen_c, masks_c), (card, loss_g, norm_g, pen_g, masks_g), native = runs
    spread = {"grad_norm_rel": abs(native[2] - norm_g) / abs(norm_g), "params": _scaled_max(native[0].params,
                                                                                            card.params)}
    norm_tol = max(TRAIN_NORM_TOL, SEARCH_SPREAD_FACTOR * spread["grad_norm_rel"])
    param_tol = max(TRAIN_PARAM_TOL, SEARCH_SPREAD_FACTOR * spread["params"])
    alive = int(sum(float(v.sum()) for v in masks_g.values()))
    total = sum(v.numel() for v in masks_g.values())
    res = {"loss_rel": abs(loss_g - loss_c) / abs(loss_c), "grad_norm_rel": abs(norm_g - norm_c) / abs(norm_c),
           "penalty_card": pen_g, "penalty_cpu": pen_c, "penalty_rel": abs(pen_g - pen_c) / abs(pen_c),
           "params": _scaled_max(card.params, cpu.params), "opt_nu": _scaled_max(card.opt_state["nu"],
                                                                                 cpu.opt_state["nu"]),
           "masks_equal": all(torch.equal(masks_c[k], masks_g[k]) for k in masks_c),
           "alive_atoms": alive, "total_atoms": total, "card_spread": spread, "grad_norm_tol": norm_tol,
           "params_tol": param_tol, "grad_norm": norm_c}
    log(f"search step + prune event, card vs CPU (atomnas_supernet 1.0 at {IMAGE_SIZE}, f32, TF32 off, batch "
        f"{TRAIN_CHECK_BATCH}): loss rel {res['loss_rel']:.2e} (tol {TRAIN_LOSS_TOL}), grad norm {norm_c:.4f}, rel "
        f"{res['grad_norm_rel']:.2e} (tol {norm_tol:.2e}), penalty {pen_g:.6e} / {pen_c:.6e} (rel "
        f"{res['penalty_rel']:.2e}), params {res['params']:.2e} (tol {param_tol:.2e}), nu {res['opt_nu']:.2e}; "
        f"the card's cuDNN vs native convolutions: grad norm rel {spread['grad_norm_rel']:.2e}, params "
        f"{spread['params']:.2e} (tols: the larger of TRAIN_*_TOL and {SEARCH_SPREAD_FACTOR}x these); masks after "
        f"the event equal: {res['masks_equal']} ({alive}/{total} atoms alive)")
    if (res["loss_rel"] > TRAIN_LOSS_TOL or res["grad_norm_rel"] > norm_tol or res["params"] > param_tol
            or res["penalty_rel"] > TRAIN_LOSS_TOL or not res["masks_equal"] or not 0 < alive < total):
        raise AssertionError(f"the card's search step differs from the CPU path's: {res}")
    return res


def _time_train_steps(trainer, cfg, device, fake) -> dict:
    """ms per step (synchronized, the step with its device-side data),
    images/s and peak memory of a trainer's step at cfg's batch."""
    import torch

    batches = fake.train_batches(cfg.train.batch_size, 0)
    gen = torch.Generator(device=device).manual_seed(0)
    ts = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        ts, m = trainer.train_step(ts, next(batches), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEARCH_TIMING_STEPS):
        ts, m = trainer.train_step(ts, next(batches), gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SEARCH_TIMING_STEPS * 1e3
    return {"ms_per_step": ms, "images_per_s": cfg.train.batch_size / ms * 1e3,
            "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9, "loss": float(m["loss"])}


def phase_search_run(device, tmp: str) -> tuple[dict, object, object, object]:
    """The search through cli/train.py (``train()``: ``run()`` that also
    returns the state): apps/atomnas_a_search.yml at full width with the
    cuts of the SEARCH_* constants, every synchronizing CUDA call recorded
    with its stack. Then the step of the supernet and of the searched
    network timed alone, bf16 at SEARCH_BATCH."""
    import dataclasses as dc

    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

    cuts = [f"train.batch_size={SEARCH_BATCH}", f"data.fake_train_size={SEARCH_BATCH * SEARCH_STEPS_PER_EPOCH}",
            f"data.fake_eval_size={SEARCH_EVAL_IMAGES}", f"train.eval_batch_size={SEARCH_BATCH}",
            f"train.epochs={SEARCH_EPOCHS}", f"train.log_every={SEARCH_LOG_EVERY}",
            f"prune.mask_interval={SEARCH_MASK_INTERVAL}", f"prune.remat_epochs={SEARCH_REMAT_EPOCHS}",
            f"prune.gamma_threshold={SEARCH_GAMMA_THRESHOLD}"]
    cfg = _search_cfg(tmp, "run", *cuts)
    supernet = get_model(cfg.model, IMAGE_SIZE)
    super_macs = profile_network(supernet).total_macs
    rebuilds0 = get_registry().snapshot().get("train.rebuilds", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    (summary, ts, net), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    wall = time.perf_counter() - t0
    k1 = fused_depthwise.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    rebuilds = get_registry().snapshot().get("train.rebuilds", 0) - rebuilds0
    in_step = [(msg, st) for msg, st in syncs if "_one_step" in st]
    in_event = [(msg, st) for msg, st in syncs if "_prune_event" in st]
    sites: dict = {}
    for msg, st in syncs:
        where = next((name for name in reversed(st) if name in (
            "_log_point", "evaluate", "remat_point", "_write_searched", "_train", "train")), "?")
        sites[where] = sites.get(where, 0) + 1
    remats = summary["remats"]
    searched = summary["searched"]
    total_steps = SEARCH_STEPS_PER_EPOCH * SEARCH_EPOCHS
    res = {k: v for k, v in summary.items() if k != "log"}
    res.update(cuts=cuts, wall_s=wall, peak_allocated_gb=peak_gb, syncs=len(syncs), sync_sites=sites,
               syncs_in_a_step=len(in_step), syncs_in_an_event=len(in_event), rebuilds=rebuilds, k1_launches=k1,
               supernet_macs=super_macs, log=[{k: row[k] for k in ("step", "loss", "penalty", "effective_macs")}
                                              for row in summary["log"]])
    log(f"search run (cli/train.py, apps/atomnas_a_search.yml: atomnas_supernet 1.0 at {IMAGE_SIZE}, relu6, bf16, "
        f"TF RMSProp, EMA, rho {cfg.prune.rho}, target {cfg.prune.target_flops / 1e6:.0f}M MACs; fake data; cut: "
        f"dist.num_devices=1 (SyncBN over one device is exact BN), {' '.join(cuts)} — the threshold raised so that "
        f"atoms die in a run this short): {summary['steps']} steps (counter {summary['step']}), "
        f"{summary['finite_steps']} finite, on {summary['device']}; log points "
        + ", ".join(f"step {r['step']} loss {r['loss']:.4f} penalty {r['penalty']:.3e} effective "
                    f"{r['effective_macs'] / 1e6:.1f}M" for r in res["log"])
        + f"; EMA eval top-1 {summary['eval_top1']:.4f} over {summary['eval_n']}; {wall:.1f} s; peak allocated "
        f"{peak_gb:.2f} GB; synchronizing calls {len(syncs)} by site {sites}, {len(in_step)} inside a step, "
        f"{len(in_event)} inside a prune event; train.rebuilds {rebuilds}; K1 launches {k1}")
    for r in remats:
        log(f"  rematerialize at step {r['step']}: atoms {r['atoms_before']} -> {r['atoms_after']}, dropped blocks "
            f"{r['dropped_blocks']}, MACs {r['macs_before'] / 1e6:.1f}M -> {r['macs_after'] / 1e6:.1f}M, device "
            f"memory allocated {r['memory_allocated_before'] / 1e9:.3f} -> {r['memory_allocated_after'] / 1e9:.3f} GB")
    log(f"  searched_arch.json: MACs {super_macs / 1e6:.1f}M (supernet) -> {searched['macs'] / 1e6:.1f}M, "
        f"{searched['params'] / 1e6:.3f}M params, step {searched['step']}")
    if (summary["steps"] != total_steps or summary["finite_steps"] != total_steps or summary["step"] != total_steps
            or not summary["device"].startswith("cuda")):
        raise AssertionError(f"search run: {res}")
    if not remats or remats[0]["step"] >= total_steps or remats[0]["atoms_after"] >= remats[0]["atoms_before"]:
        raise AssertionError(f"search run: no rematerialization mid-run with dead atoms: {remats}")
    if rebuilds != len(remats) or searched["macs"] >= super_macs or searched["step"] != total_steps:
        raise AssertionError(f"search run: rebuilds {rebuilds}, searched {searched}")
    if remats[0]["memory_allocated_after"] >= remats[0]["memory_allocated_before"]:
        raise AssertionError(f"search run: the supernet's memory was not freed: {remats[0]}")
    if in_step or in_event:
        raise AssertionError(f"search run: host syncs inside a step ({len(in_step)}) or an event ({len(in_event)}): "
                             f"{(in_step + in_event)[0]}")
    if k1:
        raise AssertionError(f"search run: K1 launched {k1} times on the training path")

    # the step of the supernet and of the searched network alone (bf16)
    tcfg = dc.replace(cfg, data=dc.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    fake = pipeline.FakeImages(tcfg.data, device)
    timing = {}
    for tag, tnet in (("supernet", supernet), ("searched", net)):
        timing[tag] = _time_train_steps(train_cli.Trainer(tcfg, tnet, device), tcfg, device, fake)
        torch.cuda.empty_cache()
    del fake
    res["timing"] = timing
    log(f"search step timing (bf16, batch {SEARCH_BATCH}, with the penalty, step with its device-side data): "
        + "; ".join(f"{tag} {r['ms_per_step']:.2f} ms per step, {r['images_per_s']:.0f} images/s, peak "
                    f"{r['peak_allocated_gb']:.2f} GB" for tag, r in timing.items()))
    return res, ts, net, supernet


def _dead_masks(net, seed: int) -> dict:
    """Random masks of ``net``'s prunable blocks (about 40% dead), a
    residual block dead whole and, in another block, a whole branch."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.nas.masking import prunable_blocks

    rng = np.random.RandomState(seed)
    blocks = prunable_blocks(net)
    masks = {str(i): (rng.uniform(size=net.blocks[i].expanded_channels) > 0.4).astype(np.float32) for i in blocks}
    residual = next(i for i in blocks if net.blocks[i].has_residual)
    masks[str(residual)][:] = 0.0
    other = next(i for i in blocks if i != residual and len(net.blocks[i].kernel_sizes) > 1)
    off, g = net.blocks[other].group_channels[0], net.blocks[other].group_channels[1]
    masks[str(other)][off: off + g] = 0.0  # its second branch
    masks[str(other)][0] = 1.0
    return masks


def phase_masked_vs_remat(device, tmp: str, supernet) -> dict:
    """On the card: the supernet's eval forward under dead masks against
    the rematerialized network's (sliced on the card), f32, TF32 off, at the
    f32 bar; then export_bundle with the same masks, whose spec must be the
    rematerialized one."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.nas import rematerialize
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import masked_macs, profile_network

    def to(tree, dev):
        return unflatten_tree({k: v.to(dev) for k, v in flatten_tree(tree).items()})

    gen = torch.Generator().manual_seed(5)
    params, _ = supernet.init(gen)
    state = random_bn_state(supernet, gen)
    np_masks = _dead_masks(supernet, 6)
    masks = {k: torch.from_numpy(v).to(device) for k, v in np_masks.items()}
    p, s = to(params, device), to(state, device)
    x = torch.from_numpy(np.random.RandomState(7).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
                         .astype(np.float32)).to(device)
    new_net, new_p, new_s, _, _, report = rematerialize.rematerialize(supernet, p, s, masks)
    with torch.inference_mode():
        masked = supernet.apply(p, s, x, masks={int(k): v for k, v in masks.items()}).cpu().numpy()
        rebuilt = new_net.apply(new_p, new_s, x).cpu().numpy()
    err = float(np.abs(rebuilt - masked).max())
    ok = np.all(np.abs(rebuilt - masked) <= SLICE_ATOL + SLICE_RTOL * np.abs(masked)) and np.isfinite(rebuilt).all()
    eff = masked_macs(supernet, {int(k): v for k, v in np_masks.items()})
    bundle = load_bundle(export_bundle(supernet, params, state, os.path.join(tmp, "masked_bundle"), masks=masks,
                                       device=str(device)))
    res = {"max_abs_err": err, "max_logit": float(np.abs(masked).max()), "atoms_before": report.atoms_before,
           "atoms_after": report.atoms_after, "dropped_blocks": report.dropped_blocks,
           "dropped_branches": {str(k): v for k, v in report.dropped_branches.items()},
           "masked_macs": eff, "rematerialized_macs": profile_network(new_net).total_macs,
           "bundle_prune": bundle.meta.get("prune")}
    log(f"masked vs rematerialized forward on the card (supernet 1.0 at {IMAGE_SIZE}, f32, batch "
        f"{TRAIN_CHECK_BATCH}; atoms {report.atoms_before} -> {report.atoms_after}, dropped blocks "
        f"{report.dropped_blocks}, dropped branches {report.dropped_branches}): max |err| {err:.3e}, max |logit| "
        f"{res['max_logit']:.3e} (atol {SLICE_ATOL}, rtol {SLICE_RTOL}); masked MACs {eff / 1e6:.2f}M = rebuilt "
        f"{res['rematerialized_macs'] / 1e6:.2f}M; the dead-mask bundle's spec is the rebuilt one: "
        f"{bundle.net.blocks == new_net.blocks}")
    if not ok or abs(eff - res["rematerialized_macs"]) > 1e-6 * eff or bundle.net.blocks != new_net.blocks \
            or not report.dropped_blocks or not report.dropped_branches:
        raise AssertionError(f"masked vs rematerialized forward: {res}")
    return res


def net_branch_stages(net, batch: int) -> list[tuple]:
    """(block, n, h, expanded, offset, channels, k, stride, act) of every
    depthwise branch of ``net`` at IMAGE_SIZE, in forward order: the channel
    slices the folded forward runs K1 on."""
    h = (IMAGE_SIZE - 1) // net.stem.stride + 1
    out = []
    for i, blk in enumerate(net.blocks):
        for _, k, g, off in blk._branches():
            out.append((i, batch, h, blk.expanded_channels, off, g, k, blk.stride, blk.active_fn))
        h = (h - 1) // blk.stride + 1
    return out


def check_net_stages(device, nets: dict, batches=(1, 32)) -> dict:
    """K1 against its plain version at every depthwise branch of each net,
    as the folded forward launches it: the branch's channel slice of one
    wide NHWC tensor written in place into a slice of one wide output (the
    supernet's block 0: 32 channels at 112x112 in branches of 11/11/10; k=7
    at every stage), f32 and bf16, at each batch."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    gen = torch.Generator(device=device).manual_seed(8)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failures, count, scalar = [], 0, 0
    with torch.inference_mode():
        for tag, net in nets.items():
            for batch in batches:
                by_block: dict = {}
                for stage in net_branch_stages(net, batch):
                    by_block.setdefault(stage[0], []).append(stage)
                for stages in by_block.values():
                    _, n, h, e, _, _, _, s, act = stages[0]
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn((n, h, h, e), generator=gen, device=device).to(dtype)
                        out = torch.full(((n, (h - 1) // s + 1, (h - 1) // s + 1, e)), float("nan"), device=device,
                                         dtype=dtype)
                        for (blk, _, _, _, off, g, k, _, _) in stages:
                            ops = kernel_operands(n, h, g, k, dtype, gen, device)[1:]
                            xs, ys = x[..., off: off + g], out[..., off: off + g]
                            scalar += fdw.launch_plan(xs, k, s, ys).vec == 1
                            fdw.fused_depthwise(xs, *ops, s, act, out=ys)
                            torch.cuda.synchronize()
                            ref = fdw.fused_depthwise_reference(xs.contiguous(), *ops, s, act)
                            tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
                            err, ok = compare(ys, ref, *tol)
                            errs[dtype] = max(errs[dtype], err)
                            count += 1
                            if not ok:
                                failures.append((tag, batch, blk, off, g, k, s, str(dtype), err))
                        if torch.isnan(out.float()).any():
                            failures.append((tag, batch, stages[0][0], "a channel left unwritten"))
    log(f"K1 vs plain at the search path's branches ({', '.join(f'{t}: {len(net_branch_stages(n, 1))} branches' for t, n in nets.items())}; "
        f"batches {'/'.join(map(str, batches))}; channel slices in place, {scalar} of {count} launches on the "
        f"scalar path): max |err| f32 {errs[torch.float32]:.3e} (tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} "
        f"(atol {BF16_ATOL}, rtol {BF16_RTOL:.4g})")
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version at the search path's branches: {failures[:5]}")
    return {"cases": count, "scalar_launches": scalar, "max_f32": errs[torch.float32],
            "max_bf16": errs[torch.bfloat16]}


def profile_served_forwards(bundle_dir: str, batch: str, forwards: str) -> dict:
    """Run in a fresh process (PROFILE_CHILD): an engine of the bundle on the
    card, one warm forward, then ``forwards`` served forwards under
    torch.profiler; K1's launches and device time, all kernels' count and
    device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    batch, forwards = int(batch), int(forwards)
    engine = InferenceEngine(load_bundle(bundle_dir), device="cuda", buckets=(batch,))
    engine.warmup()
    x = np.random.RandomState(12).normal(0, 1, (batch, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    engine.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            engine.predict(x)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    return {"k1": sum(c for name, _, c in kernels if "fused_dw_kernel" in name),
            "k1_us": sum(us for name, us, _ in kernels if "fused_dw_kernel" in name),
            "kernels": sum(c for _, _, c in kernels), "busy_us": sum(us for _, us, _ in kernels)}


def phase_search_serve(device, tmp: str, ts, net) -> dict:
    """The searched network's EMA weights through export_bundle into the
    port's serving entry point, ``cli/serve.py``'s ``run(cfg, device)``
    (the shipped serving config: buckets 1/8/32, f32), the counts at 0 just
    before and read just after; then an engine of the bundle: its logits
    against Network.apply of the same weights on the card within FOLD_ATOL,
    and K1's launches per forward, counted by the profiler in a fresh
    process (PROFILE_CHILD), equal to the searched network's surviving
    branches."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    def cpu(tree):
        return unflatten_tree({k: v.detach().cpu() for k, v in flatten_tree(tree).items()})

    per_forward = sum(1 for blk in net.blocks for _ in blk._branches())
    bundle_dir = export_bundle(net, cpu(ts.ema_params), cpu(ts.ema_state), os.path.join(tmp, "searched"),
                               masks=ts.masks, model_name="atomnas_a_searched", device=str(device))
    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", f"serve.requests={SEARCH_SERVE_REQUESTS}",
                     f"serve.clients={SERVE_CLIENTS}", "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_searched')}"])
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    result = serve_cli.run(cfg, device=str(device))
    launches = fused_depthwise.launches
    k1 = _k1_accounting(result["graphs"], launches, per_forward)
    log(f"searched bundle (cli.serve.run, buckets {'/'.join(map(str, cfg.serve.buckets))}, f32): "
        f"{result['completed']}/{result['requests']} requests, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} "
        f"ms, p99 {result['p99_ms']:.2f} ms; {result['dispatches']} dispatches = {result['replays']} graph replays; "
        f"K1 {k1['launches']} launches = {k1['warm']} warm + {k1['replayed']} replayed ({per_forward} per forward, "
        f"one per surviving branch)")
    if result["completed"] != SEARCH_SERVE_REQUESTS or result["shed"] or result["rejected_full"] \
            or result["dispatches"] != result["replays"]:
        raise AssertionError(f"searched bundle: {result}")

    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    x = np.random.RandomState(12).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    got = engine.predict(x)
    child = subprocess.run([sys.executable, "-c", PROFILE_CHILD, REPO, bundle_dir, str(TRAIN_CHECK_BATCH),
                            str(SERVED_FORWARDS)], capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise AssertionError(f"the profiling process failed: {child.stderr[-2000:]}")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    profiled = prof["k1"]
    if profiled != per_forward * SERVED_FORWARDS:
        raise AssertionError(f"{SERVED_FORWARDS} served forwards of the searched net: the profiler saw {profiled} "
                             f"fused_dw_kernel launches on the card, the graph's {per_forward} a forward account for "
                             f"{per_forward * SERVED_FORWARDS}")
    with torch.inference_mode():
        want = net.apply(ts.ema_params, ts.ema_state, torch.from_numpy(x).to(device)).cpu().numpy()
    err = float(np.abs(got - want).max())
    res = {"per_forward": per_forward, "k1": k1, "wrapper_launches": launches, "profiled_per_forward":
           profiled // SERVED_FORWARDS, "profile": prof, "max_abs_err": err,
           "max_logit": float(np.abs(want).max()), "k1_share_of_device_time": prof["k1_us"] / prof["busy_us"],
           "qps": result["qps"], "p50_ms": result["p50_ms"], "p99_ms": result["p99_ms"]}
    log(f"searched bundle served vs Network.apply of the EMA weights on the card (f32, bucket {TRAIN_CHECK_BATCH}): "
        f"max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| {res['max_logit']:.3e}; K1 {profiled} launches in "
        f"{SERVED_FORWARDS} forwards by the profiler in a fresh process ({per_forward} surviving branches; "
        f"{prof['kernels']} kernels in all), {100 * res['k1_share_of_device_time']:.1f}% of the forwards' device "
        f"time")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"searched bundle's logits differ by {err:.3e}")
    return res


def phase_retrain(device, tmp: str, searched_path: str, net) -> dict:
    """apps/retrain_searched.yml with model.network_spec at the search's
    searched_arch.json, RETRAIN_STEPS steps through cli/train.py."""
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    cuts = ["dist.num_devices=1", f"train.batch_size={RETRAIN_BATCH}",
            f"data.fake_train_size={RETRAIN_BATCH * RETRAIN_STEPS}", f"data.fake_eval_size={RETRAIN_BATCH}",
            f"train.eval_batch_size={RETRAIN_BATCH}", "train.epochs=1", f"train.log_every={RETRAIN_STEPS}"]
    cfg = parse_cli([f"app:{RETRAIN_APP}", f"model.network_spec={searched_path}", "data.dataset=fake",
                     f"data.image_size={IMAGE_SIZE}", f"train.log_dir={os.path.join(tmp, 'retrain')}", *cuts])
    summary, _, rnet = train_cli.train(cfg, device=str(device))
    res = {k: v for k, v in summary.items() if k != "log"}
    res["cuts"] = cuts
    log(f"retrain (cli/train.py, apps/retrain_searched.yml, model.network_spec=searched_arch.json; bf16; fake data; "
        f"cut: {' '.join(cuts)}): {summary['steps']} steps, {summary['finite_steps']} finite, loss "
        f"{summary['log'][-1]['loss']:.4f}, on {summary['device']}; the searched blocks: {rnet.blocks == net.blocks}")
    if summary["finite_steps"] != RETRAIN_STEPS or rnet.blocks != net.blocks or not summary["device"].startswith(
            "cuda"):
        raise AssertionError(f"retrain: {res}")
    return res


def write_details(details: dict) -> None:
    out_dir = os.path.join(REPO, "chiprun_out")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(details, f, indent=1, default=str)
    except OSError as e:  # the details are a convenience; the run's verdict is on stdout
        log(f"could not write chiprun_out/chip_smoke.json: {e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the card", file=sys.stderr)
        return 2
    try:
        import yet_another_mobilenet_series_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # float32 means float32: cuDNN's TF32 default would break the parity bars
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    log(card)
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True, timeout=60)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    rates = card_rates(torch.cuda.get_device_name(0))

    build = phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        checks = phase_kernel_checks(device, tmp)
        timed = time_stages(device, rates)
        served = phase_loads(device, tmp)
        graph_checks = phase_graph_checks(device, tmp, served["bundle_dir"])
        forward = phase_forward(device, served["bundle_dir"], card, served["per_forward"])
        torch.cuda.empty_cache()
        training = {"parity": phase_train_parity(device, tmp)}
        training["run"], trained_ts, trained_net = phase_train_run(device, tmp)
        training["export_serve"] = phase_export_serve(device, tmp, trained_ts, trained_net, served["per_forward"])
        del trained_ts
        training["overfit"] = phase_overfit(device, tmp)
        torch.cuda.empty_cache()
        training["timing"] = phase_train_timing(device, tmp)
        torch.cuda.empty_cache()
        search = {"parity": phase_search_parity(device, tmp)}
        search["run"], searched_ts, searched_net, supernet = phase_search_run(device, tmp)
        search["masked_vs_remat"] = phase_masked_vs_remat(device, tmp, supernet)
        search["serve"] = phase_search_serve(device, tmp, searched_ts, searched_net)
        del searched_ts
        torch.cuda.empty_cache()
        search["kernel_checks"] = check_net_stages(device, {"supernet": supernet, "searched": searched_net})
        search["kernel_times"] = time_stages(device, rates, [(n, h, c, k, s, act) for (_, n, h, _, _, c, k, s, act)
                                                             in net_branch_stages(searched_net, 32)])
        search["retrain"] = phase_retrain(device, tmp, search["run"]["searched"]["path"], searched_net)
    for tag, r in served["loads"].items():
        log(f"load {tag} on {card}: {r['qps']:.1f} QPS, p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms "
            f"(cli.serve.run: {r['completed']} single-image requests from {SERVE_CLIENTS} closed-loop clients; "
            f"buckets 1/8/32, MobileNetV3-Large 1.0 at 224, f32 compute, {r['traffic']['quant_mode']})")

    tt = training["timing"]
    log(f"training on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, batch {TRAIN_BATCH}: bf16 "
        f"{tt['bfloat16']['ms_per_step']:.2f} ms per step, {tt['bfloat16']['images_per_s']:.0f} images/s, peak "
        f"{tt['bfloat16']['peak_allocated_gb']:.2f} GB; f32 {tt['float32']['ms_per_step']:.2f} ms, "
        f"{tt['float32']['images_per_s']:.0f} images/s, peak {tt['float32']['peak_allocated_gb']:.2f} GB; device busy "
        f"{100 * tt['bfloat16']['profile']['busy_share']:.1f}% (bf16, profiler); optimizer + EMA "
        f"{100 * tt['bfloat16']['optimizer_ema_share']:.2f}% of a step")

    sr, st = search["run"], search["kernel_times"]["totals"]
    log(f"search on {card}: atomnas_supernet 1.0 at {IMAGE_SIZE}, batch {SEARCH_BATCH}, bf16: "
        f"{sr['supernet_macs'] / 1e6:.1f}M -> {sr['searched']['macs'] / 1e6:.1f}M MACs in {sr['steps']} steps "
        f"({len(sr['remats'])} rematerialization(s)); step {sr['timing']['supernet']['ms_per_step']:.2f} ms "
        f"({sr['timing']['supernet']['images_per_s']:.0f} images/s) on the supernet, "
        f"{sr['timing']['searched']['ms_per_step']:.2f} ms ({sr['timing']['searched']['images_per_s']:.0f} images/s) "
        f"on the searched net; run peak {sr['peak_allocated_gb']:.2f} GB; searched bundle served at "
        f"{search['serve']['qps']:.1f} QPS, K1 {100 * search['serve']['k1_share_of_device_time']:.1f}% of a "
        f"forward's device time")

    t = timed["totals"]
    kernels = {"kernels": [{
        "name": "fused_depthwise",
        "route": "cuda",
        "source": "yet_another_mobilenet_series_tpu_torch/csrc/fused_depthwise.cu",
        "replaces": "yet_another_mobilenet_series_tpu/ops/pallas_kernels.py:129",
        "launches": served["launches"],
        "launches_by_load": {tag: r["k1"]["launches"] for tag, r in served["loads"].items()},
        "launches_counted_as": "cli.serve.run's three loads: warm runs + replays x launches captured (counters)",
        "launches_on_device": {**{f"{tag} traffic": r["traffic"]["k1_device_count"]
                                  for tag, r in served["loads"].items()},
                               "5 batch-32 replays": forward["profile"]["fused_dw_count"]},
        "launches_per_replay": {"per_chunk": served["per_forward"], "fused_k": f"{served['per_forward']} x K",
                                "ring": f"{served['per_forward']} x R"},
        "launches_on_training_path": {
            f"cli.train run, {TRAIN_STEPS} steps + EMA eval (wrapper count)": training["run"]["k1_launches"],
            f"{PROFILED_STEPS} bf16 train steps (profiler)": tt["bfloat16"]["profile"]["k1_device_count"],
            "trained weights exported and served, per forward (profiler)": training["export_serve"]["k1_launches"]},
        "launches_on_search_path": {
            f"cli.train search run, {sr['steps']} steps + EMA evals (wrapper count)": sr["k1_launches"],
            "searched bundle through cli.serve.run (warm runs + replays x captured)":
                search["serve"]["k1"]["launches"],
            "searched bundle, per forward (profiler)": search["serve"]["profiled_per_forward"],
            "surviving branches of the searched net": search["serve"]["per_forward"]},
        "search_stages": {
            "shapes": f"the searched net's {len(search['kernel_times']['rows'])} depthwise branches at batch 32 "
                      "(contiguous inputs), times summed",
            **{key: st[key] for key in ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "library_ms",
                                        "library_device_ms", "library_cold_ms", "bf16_ms", "bf16_device_ms",
                                        "bf16_cold_ms", "bf16_bound_ms", "bf16_library_ms",
                                        "bf16_library_device_ms", "bf16_library_cold_ms")},
            "bound_by": search["kernel_times"]["bound_by"],
            "checked_branch_launches": search["kernel_checks"]["cases"],
            "max_abs_err": search["kernel_checks"]["max_f32"],
            "max_abs_err_bf16": search["kernel_checks"]["max_bf16"]},
        "max_abs_err": checks["max_f32"],
        "max_abs_err_bf16": checks["max_bf16"],
        "ms": t["ms"],
        "kernel_ms": t["ms"],
        "device_ms": t["device_ms"],
        "cold_ms": t["cold_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": timed["bound_by"],
        "share_of_bound_cold": t["share"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "library_cold_ms": t["library_cold_ms"],
        "library": "F.conv2d(groups=C, bias=shift): conv+bias without the activation",
        "bf16_ms": t["bf16_ms"],
        "bf16_device_ms": t["bf16_device_ms"],
        "bf16_cold_ms": t["bf16_cold_ms"],
        "bf16_bound_ms": t["bf16_bound_ms"],
        "bf16_library_ms": t["bf16_library_ms"],
        "bf16_library_device_ms": t["bf16_library_device_ms"],
        "bf16_library_cold_ms": t["bf16_library_cold_ms"],
        "host_us_per_launch": t["host_us_per_launch"],
        "library_host_us_per_call": t["library_host_us_per_call"],
        "shapes": "the 15 depthwise stages of MobileNetV3-Large 1.0 at 224, batch 32, float32 (bf16_* in bfloat16); times summed; ms = back to back (cuda_time_ms), device_ms = the stream idled while the host enqueues, cold = L2 flushed before each launch",
    }]}
    write_details({"card": card, "build": build, "kernel_rows": timed["rows"], "checks": checks,
                   "kernels": kernels,
                   "loads": served, "graph_checks": graph_checks, "forward": forward, "training": training,
                   "search": search, "search_kernel_rows": search["kernel_times"]["rows"],
                   "seconds": time.perf_counter() - t_start})
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _nvcc() -> str:
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    return cuda_build.find_nvcc()


if __name__ == "__main__":
    sys.exit(main())

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
4. serves MobileNetV3-Large 1.0 at 224 in float32 with seeded weights
   through the port's ``cli.serve.run`` (buckets 1/8/32, 256 requests from 8
   clients), with every kernel's launch count set to 0 just before and read
   just after; checks every request completed, that each depthwise stage
   was a kernel launch, and that the card's logits match the port's CPU
   forward on the same bundle within SLICE_ATOL/SLICE_RTOL;
5. times a forward per bucket on the card and breaks a batch-32 forward
   down by kernel with ``torch.profiler`` (after the counts were read);
6. prints the ``kernels`` JSON line, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Details too long for the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
SERVE_REQUESTS = 256
SERVE_CLIENTS = 8
TIMING_ITERS = 50
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


def time_stages(device, rates) -> dict:
    """Times at the main path's shapes (batch 32), float32 and bfloat16: the
    kernel warm back to back (``ms``), warm on the device alone
    (``device_ms``) and cold, F.conv2d(groups=C, bias) the same three ways,
    the plain version, the bound and the cold share of it; then the host
    cost of the wrapper and of F.conv2d. Uses only the wrapper's positional
    API, which every version of the port has (scripts/ab_fused_depthwise.py
    runs it on two checkouts)."""
    import torch
    import torch.nn.functional as F

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import (
        fused_depthwise, fused_depthwise_reference)

    gen = torch.Generator(device=device).manual_seed(1)
    _, shapes = mbv3_depthwise_shapes(32)
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
        # host cost of the wrapper and of F.conv2d: calls over the 15
        # stages in turn, no synchronize
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
        log(f"15 stages at batch 32, {name}: kernel {totals[t + 'ms']:.4f} ms back to back / "
            f"{totals[t + 'device_ms']:.4f} ms device / {totals[t + 'cold_ms']:.4f} ms cold, F.conv2d(groups=C, "
            f"bias) without the activation {totals[t + 'library_ms']:.4f} / {totals[t + 'library_device_ms']:.4f} / "
            f"{totals[t + 'library_cold_ms']:.4f} ms, plain {totals[t + 'plain_ms']:.4f} ms, bound "
            f"{totals[t + 'bound_ms']:.4f} ms ({sum(r[t + 'bytes'] for r in rows) / 1e6:.1f} MB at "
            f"{rates[0] / 1e12:.2f} TB/s, H100 {rates[2]}); cold share of the bound {100 * totals[t + 'share']:.1f}%; "
            f"cold with a clean L2 (no write-back of the flush) {totals[t + 'cold_clean_ms']:.4f} ms")
    log(f"host cost: wrapper {host_us:.2f} us per launch, F.conv2d {library_host_us:.2f} us per call (15 stages "
        f"in turn, no synchronize)")
    return {"rows": rows, "totals": totals, "bytes": sum(r["bytes"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"}


def phase_slice(device, tmp: str) -> dict:
    """Serve MBV3-L 1.0 at 224, f32, through the port's own CLI run()."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state

    net, shapes = mbv3_depthwise_shapes(32)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    bundle_dir = os.path.join(tmp, "bundle")
    export_bundle(net, params, state, bundle_dir, model_name="mobilenet_v3_large")
    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", f"serve.requests={SERVE_REQUESTS}",
                     f"serve.clients={SERVE_CLIENTS}", "serve.compute_dtype=float32",
                     "serve.fuse_chunks.enable=false", "serve.overlap.enable=false",
                     f"train.log_dir={os.path.join(tmp, 'serve_log')}"])

    fused_depthwise.launches = 0  # the counts start at 0 for the main path
    result = serve_cli.run(cfg, device=str(device))
    launches = fused_depthwise.launches  # read just after
    forwards = result["dispatches"] + result["warmup_forwards"]
    per_forward = len(shapes)
    order = result.pop("latency_ms_by_completion")
    slowest = sorted(range(len(order)), key=lambda i: -order[i])[:3]
    log("slice: slowest requests by completion index: "
        + ", ".join(f"#{i} {order[i]:.2f} ms" for i in slowest))
    log(f"slice: {result['completed']}/{result['requests']} requests, {result['shed']} shed, "
        f"{result['rejected_full']} rejected, {result['dispatches']} dispatches + "
        f"{result['warmup_forwards']} warmup forwards, fused_depthwise launches {launches} "
        f"(= {per_forward} x {forwards} expected)")
    if result["device"].split(":")[0] != "cuda":
        raise AssertionError(f"the slice ran on {result['device']}, not the card")
    if result["completed"] != SERVE_REQUESTS or result["shed"] or result["rejected_full"] or result["client_crashes"]:
        raise AssertionError(f"not every request completed: {result}")
    if launches != per_forward * forwards or launches == 0:
        raise AssertionError(f"fused_depthwise launched {launches} times, expected {per_forward} x {forwards}")

    # the card's logits against the port's CPU forward of the same bundle
    bundle = load_bundle(bundle_dir)
    x = np.random.RandomState(1).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
    on_card = InferenceEngine(bundle, device=str(device)).predict(x)
    on_cpu = InferenceEngine(bundle, device="cpu").predict(x)
    if on_card.shape != (8, 1000) or not np.isfinite(on_card).all():
        raise AssertionError(f"bad logits from the card: shape {on_card.shape}")
    err = float(np.abs(on_card - on_cpu).max())
    ok = bool(np.all(np.abs(on_card - on_cpu) <= SLICE_ATOL + SLICE_RTOL * np.abs(on_cpu)))
    log(f"slice logits, card vs CPU forward (f32): max |err| {err:.3e}, max |logit| "
        f"{float(np.abs(on_cpu).max()):.3e} (atol {SLICE_ATOL}, rtol {SLICE_RTOL})")
    if not ok:
        raise AssertionError(f"card logits differ from the CPU forward by {err:.3e}")
    return {**result, "launches": launches, "forwards": forwards, "logits_max_abs_err": err}


def phase_forward(device, bundle_dir: str) -> dict:
    """Where a forward's time goes on the card: device time per bucket (CUDA
    events), the host's enqueue time per forward, and a torch.profiler
    breakdown of five batch-32 forwards by kernel (device busy share of the
    profiled window, the fused depthwise kernel's share of device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device))
    gen = torch.Generator(device=device).manual_seed(2)
    out: dict = {"buckets": {}}
    for b in engine.buckets:
        x = torch.randn((b, 224, 224, 3), generator=gen, device=device)
        device_ms = cuda_time_ms(lambda: engine._forward(x), iters=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            engine._forward(x)
        enqueue_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        out["buckets"][b] = {"device_ms": device_ms, "enqueue_ms": enqueue_ms}
        log(f"forward bucket {b:2d}: {device_ms:.3f} ms per forward back to back (CUDA events), "
            f"host enqueue {enqueue_ms:.3f} ms per forward")
    # the first forward of a thread: PyTorch keeps cuDNN/cuBLAS handles per
    # thread and hands an exited thread's handles to the next new one, so a
    # dispatch thread that starts after warmup may pay their creation
    x1 = torch.randn((1, 224, 224, 3), generator=gen, device=device)

    def synced_ms() -> float:
        t0 = time.perf_counter()
        engine._forward(x1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def in_new_thread() -> list[float]:
        box: dict = {}

        def run():
            try:
                box["ms"] = [synced_ms(), synced_ms()]
            except BaseException as e:  # re-raised below, in the main thread
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in box:
            raise box["error"]
        return box["ms"]

    main_ms = synced_ms()
    first_thread = in_new_thread()
    second_thread = in_new_thread()
    out["thread_first_forward_ms"] = {"main_thread": main_ms, "new_thread": first_thread,
                                      "next_new_thread": second_thread}
    log(f"batch-1 forward, synchronized: main thread {main_ms:.2f} ms; a new thread's first and second "
        f"{first_thread[0]:.2f} / {first_thread[1]:.2f} ms; the next new thread's "
        f"{second_thread[0]:.2f} / {second_thread[1]:.2f} ms")

    x = torch.randn((32, 224, 224, 3), generator=gen, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            engine._forward(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    # device-side events only: a CPU op's self device time repeats the
    # kernels it launched, so summing every row would count them twice
    kernels = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                     key=lambda r: -r[1])
    busy_us = sum(us for _, us, _ in kernels)
    if not kernels:
        log("profiler: no device time recorded; device breakdown not measured")
        return out
    dw_us = sum(us for name, us, _ in kernels if "fused_dw_kernel" in name)
    out["profile"] = {"wall_us": wall_us, "device_us": busy_us, "fused_dw_us": dw_us,
                      "top": [{"kernel": n[:120], "device_us": us, "count": c} for n, us, c in kernels[:15]]}
    log(f"profile, 5 forwards at batch 32: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({100 * busy_us / wall_us:.1f}%); fused_dw_kernel {dw_us / 1e3:.3f} ms "
        f"({100 * dw_us / busy_us:.1f}% of device time)")
    for name, us, c in kernels[:8]:
        log(f"  {us / 5e3:8.4f} ms/forward  x{c // 5:<4d} {name[:100]}")
    return out


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
        served = phase_slice(device, tmp)
        forward = phase_forward(device, os.path.join(tmp, "bundle"))
    log(f"slice on {card}: {served['qps']:.1f} QPS, p50 {served['p50_ms']:.2f} ms, "
        f"p99 {served['p99_ms']:.2f} ms ({served['completed']} requests, {SERVE_CLIENTS} closed-loop clients, "
        f"buckets 1/8/32, MobileNetV3-Large 1.0 at 224, f32)")

    t = timed["totals"]
    kernels = {"kernels": [{
        "name": "fused_depthwise",
        "route": "cuda",
        "source": "yet_another_mobilenet_series_tpu_torch/csrc/fused_depthwise.cu",
        "replaces": "yet_another_mobilenet_series_tpu/ops/pallas_kernels.py:129",
        "launches": served["launches"],
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
                   "slice": served, "forward": forward, "seconds": time.perf_counter() - t_start})
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

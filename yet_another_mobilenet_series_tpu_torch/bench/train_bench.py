"""Training throughput on one card: the torch twin of the worker of the
repository's ``bench.py`` (``_worker_body``).

It builds the headline recipe (``utils/benchkit.py``
:func:`build_train_fixture`: MobileNetV3-Large 1.0, RMSProp + weight
decay, exp-decay LR, EMA, label-smoothed cross-entropy, a batch made on the
device) and times the whole train step (forward, backward, RMSProp, EMA)
at ``--batch`` and ``--image-size`` in ``--dtype`` (TF32 set from it as
``cli/train.py`` sets it: off in float32):

- ``ms_per_step``: median and p90 over ``--steps`` (>= 20) steps after
  ``--warmup``, each between two CUDA events, and their count;
- ``images_per_sec`` (per card): the batch x steps over the host clock
  around the timed steps, which end in a synchronize;
- ``peak_allocated_gb`` (``torch.cuda.max_memory_allocated``);
- the device-busy share of ``--profile-steps`` steps under
  ``torch.profiler`` (``bench/trace_ops.py`` over its Chrome trace, kept
  with ``--trace-out``), kernels per step and device time by kind;
- ``model_fwd_macs`` (the MAC profiler's, per image), ``step_macs`` (3 x
  forward x batch) and ``mfu`` = 6 x forward MACs x images/s / the card's
  peak for the compute dtype (``bench.py:442``'s formula), with
  ``mfu_formula`` and ``peak_flops`` beside it. Peaks are the data sheet's
  for an H100 SXM (989 TFLOP/s bf16; 67 TFLOP/s float32 without the tensor
  cores, as TF32 is off); another card gives ``mfu: null`` and the reason.

It prints one JSON line (``--out`` copies it to a file) stamped with the
card (``card_provenance``). A failure prints a line with ``value: null``
and ``error`` and exits 1; so does a request for the card (the default)
on a machine without one. ``--device cpu`` rehearses the path for the
tests: the line says ``"platform": "cpu"``, ``cpu_rehearsal: true``, and
every device metric is null.

Not ported from ``bench.py``: the supervisor, the tunnel probe, the retry
and out-of-memory ladders, the tuning-flag environment and the CPU
fallback.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.train_bench
           [--dtype bfloat16|float32] [--batch 512] [--image-size 224]
           [--steps 20] [--warmup 3] [--profile-steps 5] [--trace-out f.json]
           [--width-mult 1.0] [--num-classes 1000]
           [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import torch

from ..utils.benchkit import build_train_fixture, card_provenance, percentile, sync
from ..utils.device import resolve_device
from ..utils.profiling import profile_network
from . import trace_ops

# dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet)
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MFU_FORMULA = "6*fwd_macs*images_per_sec/peak_flops (forward + backward, 2 FLOPs a MAC)"


def peak_flops(device_name: str, compute_dtype: str) -> tuple[float | None, str | None]:
    """(peak FLOP/s, None) for a card whose peak the data sheet gives, else
    (None, the reason). Only the H100 SXM part (``NVIDIA H100 80GB HBM3``)
    is known; a PCIe or NVL part, or another card, gets no guess."""
    if "H100" in device_name and not any(k in device_name for k in ("PCIe", "NVL")):
        return H100_PEAK_FLOPS[compute_dtype], None
    return None, f"no data-sheet peak for {device_name!r} in {compute_dtype}"


def measure(args, dev: torch.device) -> dict:
    cuda = dev.type == "cuda"
    steps = max(1, args.steps)
    step_fn, ts, batch, net, gen = build_train_fixture(
        args.batch, args.image_size, width_mult=args.width_mult, num_classes=args.num_classes,
        compute_dtype=args.dtype, device=dev)
    macs = profile_network(net, args.image_size).total_macs
    out = {
        "batch": args.batch, "image_size": args.image_size, "compute_dtype": args.dtype,
        "arch": "mobilenet_v3_large", "width_mult": args.width_mult,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "model_fwd_macs": macs, "step_macs": 3 * macs * args.batch,
    }
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(max(1, args.warmup)):
        ts, m = step_fn(ts, batch, gen)
    sync(dev)
    out["warmup_s"] = time.perf_counter() - t0 if cuda else None
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(steps)] \
        if cuda else []
    t0 = time.perf_counter()
    for i in range(steps):
        if cuda:
            events[i][0].record()
        ts, m = step_fn(ts, batch, gen)
        if cuda:
            events[i][1].record()
    sync(dev)
    wall = time.perf_counter() - t0
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} after {steps} timed steps")
    out["loss"] = loss
    out["timed_steps"] = steps
    if cuda:
        ms = sorted(a.elapsed_time(b) for a, b in events)
        ips = args.batch * steps / wall
        out.update(
            ms_per_step={"median": percentile(ms, 0.5), "p90": percentile(ms, 0.9), "count": len(ms),
                         "min": ms[0], "max": ms[-1]},
            images_per_sec=ips, value=ips,
            peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    # the profiled window, read back through trace_ops (a CPU trace has no
    # device event: the share stays null)
    if args.profile_steps > 0:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync(dev)
        with profile(activities=acts) as prof:
            for _ in range(args.profile_steps):
                ts, m = step_fn(ts, batch, gen)
            sync(dev)
        with tempfile.TemporaryDirectory(prefix="train_bench_") as tmp:
            trace = args.trace_out or os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            rep = trace_ops.report(trace_ops.aggregate(trace_ops.load_trace(trace)[0]), 12, args.profile_steps)
        out["profile"] = {"steps": args.profile_steps, "trace": trace if args.trace_out else None,
                          "device_busy_share": rep["busy_share"] if cuda else None,
                          "kernels_per_step": rep["events_per_step"] if cuda else None,
                          "by_kind": rep["by_kind"] if cuda else None,
                          "top": rep["top"] if cuda else None}
        out["device_busy_share"] = out["profile"]["device_busy_share"]
    if cuda:
        name = torch.cuda.get_device_name(dev)
        peak, why = peak_flops(name, args.dtype)
        out.update(peak_flops=peak, mfu_formula=MFU_FORMULA,
                   mfu=6 * macs * out["images_per_sec"] / peak if peak else None,
                   mfu_fwd_only=2 * macs * out["images_per_sec"] / peak if peak else None)
        if why:
            out["mfu_null_reason"] = why
    return out


# the device metrics of the line: null in a CPU rehearsal
DEVICE_METRICS = ("value", "images_per_sec", "ms_per_step", "peak_allocated_gb", "device_busy_share", "mfu",
                  "mfu_fwd_only", "peak_flops", "warmup_s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile-steps", type=int, default=5)
    ap.add_argument("--trace-out", default="", help="keep the profiled window's Chrome trace here")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)
    out: dict = {"metric": "mobilenet_v3_large_train_images_per_sec_per_card", "value": None, "unit": "images/sec/card"}
    rc = 0
    try:
        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu", n_cards=1 if dev.type == "cuda" else 0)
        out.update(measure(args, dev))
        if dev.type == "cpu":
            out.update({k: None for k in DEVICE_METRICS})
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

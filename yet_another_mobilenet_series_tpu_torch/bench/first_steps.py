"""Where the first train steps on new shapes spend their time: the search's
supernet steps at the start of a run and the steps after a
rematerialization rebuilt the Trainer, each window under
``torch.profiler`` beside a later window on the same shapes.

It builds the Trainer of a search config (``--app``, default
``apps/atomnas_a_search.yml``, cut to one device and ``--batch``), takes
``--steps`` steps on the fresh supernet (``first``), ``--steps`` more
(``steady``), one prune event with the gamma threshold raised to 1.0 (so
atoms die at once) and a rematerialization (``cli/train.py``'s own), then
``--steps`` on the rebuilt network (``after_rebuild``) and ``--steps``
more (``after_steady``). Each step ends in a synchronize and is timed by
the host clock. Per window the line reports the step times, the host ops
by self CPU time (``key_averages``), the CUDA runtime and driver calls by
time (the Chrome trace's ``cuda_runtime``/``cuda_driver`` events, where a
module load or an allocation shows), and the device's busy share
(``bench/trace_ops.py``).

One JSON line, stamped with the card; a failure prints ``error`` and exits
1, as does a request for the card (the default) without one. ``--device
cpu`` rehearses the path: every time in the line is null.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.first_steps
           [--app APP.yml] [--batch 256] [--image-size 224] [--steps 4]
           [--trace-dir DIR] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses as dc
import json
import os
import sys
import tempfile
import time

import torch

from ..utils.benchkit import card_provenance, sync
from ..utils.device import resolve_device, set_tf32
from . import trace_ops

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _window(tag, trainer, ts, batches, gen, n, dev, trace_dir):
    """``n`` synchronized steps under the profiler: (ts, summary)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    step_s = []
    sync(dev)
    with profile(activities=acts) as prof:
        for _ in range(n):
            t0 = time.perf_counter()
            ts, m = trainer.train_step(ts, next(batches), gen)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
    path = os.path.join(trace_dir, f"first_steps_{tag}.json")
    prof.export_chrome_trace(path)
    doc, _ = trace_ops.load_trace(path)
    runtime: collections.Counter = collections.Counter()
    runtime_n: collections.Counter = collections.Counter()
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            runtime[e["name"]] += float(e.get("dur", 0.0))
            runtime_n[e["name"]] += 1
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    agg = trace_ops.aggregate(doc)
    return ts, {
        "steps": n, "step_s": step_s, "total_s": sum(step_s), "loss": float(m["loss"]),
        "top_self_cpu": [{"name": e.key[:120], "self_cpu_s": e.self_cpu_time_total / 1e6, "count": e.count}
                         for e in ops],
        "runtime_calls": [{"name": k[:80], "s": v / 1e6, "count": runtime_n[k]} for k, v in runtime.most_common(10)],
        "device_busy_share": agg["busy_share"], "device_kernels": agg["events"] if agg["device"] else None,
    }


def measure(args, dev: torch.device, trace_dir: str) -> dict:
    from ..cli import train as train_cli
    from ..config import parse_cli
    from ..data import pipeline
    from ..models import get_model
    from ..obs import trace as obs_trace
    from ..utils.logging import Logger

    n = max(1, args.steps)
    os.makedirs(trace_dir, exist_ok=True)
    cfg = parse_cli([f"app:{args.app}", "dist.num_devices=1", "data.dataset=fake",
                     f"data.image_size={args.image_size}", f"train.batch_size={args.batch}",
                     f"data.fake_train_size={args.batch * 4 * n}", "prune.gamma_threshold=1.0",
                     f"prune.mask_interval={2 * n}",
                     f"train.log_dir={trace_dir}", *args.override])
    cfg = dc.replace(cfg, data=dc.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    set_tf32(cfg.train.compute_dtype)
    t0 = time.perf_counter()
    trainer = train_cli.Trainer(cfg, get_model(cfg.model, args.image_size), dev)
    ts = trainer.init_state(0)
    fake = pipeline.FakeImages(cfg.data, dev)
    batches = fake.train_batches(args.batch, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sync(dev)
    out = {"app": os.path.basename(args.app), "batch": args.batch, "image_size": args.image_size,
           "compute_dtype": cfg.train.compute_dtype, "build_s": time.perf_counter() - t0, "windows": {}}
    for tag in ("first", "steady"):
        ts, out["windows"][tag] = _window(tag, trainer, ts, batches, gen, n, dev, trace_dir)
    tracer = obs_trace.get_tracer()
    t0 = time.perf_counter()
    ts = train_cli._prune_event(trainer, ts, 2 * n, tracer)
    # stdout carries the JSON line alone: the CLI's log line stays quiet
    trainer, ts, report = train_cli._maybe_rematerialize(trainer, ts, 2 * n, Logger(None, enabled=False))
    sync(dev)
    out["rebuild_s"] = time.perf_counter() - t0
    out["rebuild"] = report
    if report is None:
        raise RuntimeError("the prune event killed no atom: nothing to rebuild")
    for tag in ("after_rebuild", "after_steady"):
        ts, out["windows"][tag] = _window(tag, trainer, ts, batches, gen, n, dev, trace_dir)
    out["trace_dir"] = trace_dir if args.trace_dir else None
    return out


def _null_times(out: dict) -> dict:
    out = dict(out, build_s=None, rebuild_s=None)
    out["windows"] = {tag: dict(w, step_s=None, total_s=None, top_self_cpu=None, runtime_calls=None)
                      for tag, w in out["windows"].items()}
    return out


def main(argv=None) -> int:
    default_app = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "apps",
                               "atomnas_a_search.yml")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--app", default=default_app)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--trace-dir", default="", help="keep the windows' Chrome traces here")
    ap.add_argument("--override", action="append", default=[], help="a key=value of the config (repeatable)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)
    out: dict = {"metric": "first_steps_seconds", "value": None, "unit": "s"}
    rc = 0
    try:
        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu")
        with tempfile.TemporaryDirectory(prefix="first_steps_") as tmp:
            res = measure(args, dev, args.trace_dir or tmp)
        out.update(res if dev.type == "cuda" else _null_times(res))
        if dev.type == "cuda":
            out["value"] = res["windows"]["first"]["total_s"]
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out["value"] = None
        out["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    out["provenance"] = card_provenance(args.device)
    line = json.dumps(out, default=str)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Aggregate device kernel time from a ``torch.profiler`` Chrome trace: the
torch twin of ``scripts/trace_ops.py``, which read a ``jax.profiler`` XSpace
proto.

It reads the trace that ``prof.export_chrome_trace(path)`` writes (a file,
``.json`` or ``.json.gz``, or the newest such file under a directory; the
training bench writes one with ``--trace-out``) and reports the device's
kernels (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) summed by
name and by kind (:func:`kernel_kind`), the top N, and the busy share: the
union of the device intervals over the window the trace spans. A trace
with no device event (a CPU run) is reported from its ``cpu_op`` events
instead, summed by name, nested ops inside their parents too: a host
ranking, never a device number.

``--check-table LATENCY_TABLE.json`` sets a latency table's predicted
per-image total at full width beside the trace (``scripts/trace_ops.py``
:124): a table measured on other hardware shows as a gross mismatch.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.trace_ops
           TRACE [--top 20] [--check-table TABLE] [--images N] [--steps N]
           [--device cpu] [--out f.json]

It prints the report on stderr and one JSON line on stdout, stamped with
the card it runs on; it runs on the card unless ``--device cpu``, and fails
(an ``error`` line, exit 1) without one.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_kind(name: str) -> str:
    """A device kernel's kind, for the breakdowns of a training or serving
    window."""
    if "fused_dw_kernel" in name:
        return "K1 fused depthwise"
    if "multi_tensor_apply" in name:
        return "optimizer+EMA (multi_tensor_apply)"
    if any(k in name for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")):
        return "convolutions and matmuls"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in name.lower() or "memcpy" in name.lower() or "memset" in name.lower():
        return "copies and casts"
    return "elementwise"


def load_trace(path: str) -> tuple[dict, str]:
    """The parsed Chrome trace at ``path`` (a file, or the newest ``*.json``
    / ``*.json.gz`` under a directory) and the file read."""
    if os.path.isdir(path):
        files = [f for pat in ("*.json", "*.json.gz") for f in glob.glob(os.path.join(path, "**", pat),
                                                                           recursive=True)]
        if not files:
            raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {path}")
        path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    return doc, path


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def aggregate(doc: dict) -> dict:
    """Per-name and per-kind sums (us) and counts of the device events, the
    window (us, first event to last), the device's busy time (the union of
    its intervals) and share; with no device event, ``device`` is False and
    the sums are of the host's ``cpu_op`` events."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if not events:
        raise ValueError("the trace holds no complete ('X') events")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    device = bool(dev)
    chosen = dev if device else [e for e in events if e.get("cat") == "cpu_op"]
    per_name: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    per_kind: collections.Counter = collections.Counter()
    for e in chosen:
        dur = float(e["dur"])
        per_name[e["name"]] += dur
        counts[e["name"]] += 1
        per_kind[kernel_kind(e["name"]) if device else "host ops"] += dur
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev) if device else None
    window = t1 - t0
    return {
        "device": device,
        "window_us": window,
        "events": len(chosen),
        "summed_us": sum(per_name.values()),
        "busy_us": busy,
        "busy_share": (busy / window if window > 0 else None) if device else None,
        "per_name": per_name,
        "counts": counts,
        "per_kind": per_kind,
        "device_names": [p.get("name") for p in doc.get("deviceProperties", []) or []],
    }


def table_prediction(table_path: str) -> dict:
    """A latency table's predicted per-image time at full width, summed over
    its entries (the ladder's widest measurement of each), with its
    provenance."""
    with open(table_path) as f:
        doc = json.load(f)
    entries = doc.get("entries", [])
    total_s = 0.0
    for e in entries:
        ch, lat = e["alive_channels"], e["latency_s"]
        total_s += lat[max(range(len(ch)), key=lambda i: ch[i])]
    return {"entries": len(entries), "blocks_total_ms": total_s * 1e3, "provenance": doc.get("provenance", {})}


def report(agg: dict, top: int, steps: int | None) -> dict:
    """The JSON-ready summary of :func:`aggregate`: totals, the kinds, and
    the top ``top`` names (per step too, with ``steps``)."""
    total = agg["summed_us"] or 1.0
    per_step = steps or 1
    return {
        "device_events": agg["device"],
        "window_ms": agg["window_us"] / 1e3,
        "events": agg["events"],
        "summed_ms": agg["summed_us"] / 1e3,
        "busy_ms": None if agg["busy_us"] is None else agg["busy_us"] / 1e3,
        "busy_share": agg["busy_share"],
        "steps": steps,
        "events_per_step": agg["events"] / per_step if steps else None,
        "by_kind": {k: {"ms": v / 1e3, "share": v / total} for k, v in agg["per_kind"].most_common()},
        "top": [{"name": name[:160], "ms": us / 1e3, "share": us / total, "count": agg["counts"][name],
                 "ms_per_step": us / 1e3 / per_step if steps else None}
                for name, us in agg["per_name"].most_common(top)],
        "trace_device_names": agg["device_names"],
    }


def _print_report(rep: dict, file=sys.stderr) -> None:
    what = "device kernels" if rep["device_events"] else "host cpu_op events (no device event in the trace)"
    print(f"== {what}: {rep['events']} events, {rep['summed_ms']:.3f} ms summed over a {rep['window_ms']:.3f} ms "
          f"window" + (f", busy {100 * rep['busy_share']:.1f}%" if rep["busy_share"] is not None else ""),
          file=file)
    print("-- by kind --", file=file)
    for k, v in rep["by_kind"].items():
        print(f"  {k:<40} {100 * v['share']:6.2f}%  {v['ms']:10.3f} ms", file=file)
    print(f"-- top {len(rep['top'])} --", file=file)
    for row in rep["top"]:
        print(f"  {100 * row['share']:6.2f}%  {row['ms']:10.3f} ms  x{row['count']:<6d} {row['name'][:100]}",
              file=file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a Chrome trace written by torch.profiler, or a directory holding one")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--check-table", default="", help="a LATENCY_TABLE json to set beside the trace")
    ap.add_argument("--images", type=int, default=0, help="images in the traced window (per-image time)")
    ap.add_argument("--steps", type=int, default=0, help="steps in the traced window (per-step counts)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)

    from ..utils.benchkit import card_provenance
    from ..utils.device import resolve_device

    out: dict = {"metric": "trace_device_busy_share", "value": None, "unit": "share of the window"}
    rc = 0
    try:
        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu")
        doc, path = load_trace(args.trace)
        rep = report(aggregate(doc), args.top, args.steps or None)
        out.update(trace=os.path.basename(path), **rep)
        out["value"] = rep["busy_share"]
        if args.images and rep["device_events"]:
            out["device_ms_per_image"] = rep["summed_ms"] / args.images
        _print_report(rep)
        if args.check_table:
            pred = table_prediction(args.check_table)
            out["latency_table"] = {"path": os.path.basename(args.check_table), **pred}
            prov = pred["provenance"]
            print(f"-- latency table {os.path.basename(args.check_table)}: {pred['entries']} entries, "
                  f"{pred['blocks_total_ms']:.4f} ms per image over all blocks at full width (measured on "
                  f"{prov.get('device_name', '?')}, cpu_rehearsal={prov.get('cpu_rehearsal', '?')})",
                  file=sys.stderr)
            if "device_ms_per_image" in out:
                out["latency_table"]["trace_over_table"] = out["device_ms_per_image"] / pred["blocks_total_ms"]
                print(f"   trace: {out['device_ms_per_image']:.4f} ms of device time per image (the whole "
                      f"forward, stem, head and any backward included): a gross mismatch means the table's "
                      f"card is not the traced one", file=sys.stderr)
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


if __name__ == "__main__":
    sys.exit(main())

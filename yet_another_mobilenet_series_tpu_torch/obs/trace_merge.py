# Copy of scripts/trace_merge.py: the port keeps its own copy so that it merges the port's fleet traces without
# the JAX package's scripts/. Keep the two in step by hand.
#!/usr/bin/env python
"""Merge one fleet run's per-process Chrome traces into ONE Perfetto file.

A fleet run (cli/fleet.py) writes a router trace at ``<log_dir>/
obs_trace.json`` and one replica trace per slot at ``<log_dir>/r<i>/
obs_trace.json``. Each file's timestamps are µs relative to that PROCESS's
own monotonic origin, so loading them separately tells you nothing about
order across processes. This script joins them on a shared timeline:

- **clock alignment**: every trace carries ``origin_unix`` — the wall clock
  sampled ADJACENT to the monotonic origin its timestamps are relative to
  (obs/trace.py). The earliest origin becomes t=0 and every other process's
  events shift by ``(origin_unix - min_origin_unix) * 1e6`` µs. Alignment
  error is bounded by inter-host wall-clock skew (~NTP, single-digit ms)
  plus the sub-µs adjacent-read gap; on one host it is effectively the
  sub-µs gap. Wall clocks are never differenced WITHIN a process — offsets
  only place whole traces relative to each other (the YAMT017 hazard is
  same-process wall intervals, which stay monotonic).
- **id scoping**: Chrome async ("b"/"e") and flow ("s"/"t"/"f") events
  match on (category, name, id) GLOBALLY — router request #5 and replica
  request #5 would fuse into one bogus row. Every per-process id is
  remapped to ``pid * ID_STRIDE + id``, EXCEPT the cross-process
  ``fleet/leg`` flow events, whose shared id (``trace_id * 16 + seq``,
  serve/context.py) is exactly how the router's per-leg arrow finds the
  replica's ``link_parent`` arrival.
- **pid collisions**: two processes on different hosts can share a pid;
  colliding pids are remapped (the trace's ``process_name`` metadata keeps
  the human label).

The merged doc adds a ``processes`` table (pid, process_name, source file,
applied offset µs) so a reader can audit the alignment. Result: one
hedged request reads as a single waterfall — the router's ``serve/request``
envelope and ``fleet/route`` span on the router lane, a ``fleet/leg`` slice
per leg with flow arrows into BOTH replicas' ``serve/submit`` ->
``serve/request`` envelopes, every replica event carrying the router's
request id in ``args.trace``.

Usage: python -m yet_another_mobilenet_series_tpu_torch.obs.trace_merge <log_dir> [-o merged_trace.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# async/flow ids are remapped to pid * ID_STRIDE + id to make them
# process-scoped; tests recover the original via id % ID_STRIDE (request
# ids are process-monotonic counters, far below this)
ID_STRIDE = 1 << 24

# flow names that are cross-process BY DESIGN: their ids must survive the
# merge untouched so the router arrow lands on the replica slice
GLOBAL_FLOW_NAMES = frozenset({"fleet/leg"})


def discover(log_dir: str) -> list[str]:
    """The fleet layout's trace files: the router's at the top, one per
    replica slot under r<i>/ (sorted for deterministic merge order)."""
    paths = []
    top = os.path.join(log_dir, "obs_trace.json")
    if os.path.exists(top):
        paths.append(top)
    paths.extend(sorted(glob.glob(os.path.join(log_dir, "r*", "obs_trace.json"))))
    return paths


def merge(docs: list[dict], sources: list[str] | None = None) -> dict:
    """Merge parsed trace documents (``to_chrome_trace`` output) into one.
    Importable — tests and the bench merge in-memory docs directly."""
    sources = sources or [f"<doc {i}>" for i in range(len(docs))]
    origins = [d.get("origin_unix") for d in docs]
    known = [o for o in origins if isinstance(o, (int, float))]
    base = min(known) if known else 0.0
    merged_events: list[dict] = []
    processes: list[dict] = []
    seen_pids: set[int] = set()
    warnings: list[str] = []
    for doc, origin, src in zip(docs, origins, sources):
        raw_pid = int(doc.get("pid") or 0)
        pid = raw_pid
        while pid in seen_pids:
            pid += ID_STRIDE  # cross-host pid collision: keep lanes separate
        seen_pids.add(pid)
        if isinstance(origin, (int, float)):
            offset_us = (origin - base) * 1e6
        else:
            offset_us = 0.0
            warnings.append(f"{src}: no origin_unix (pre-federation trace?); "
                            f"events left at their own t=0")
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") != "M":
                ev["ts"] = float(ev.get("ts", 0.0)) + offset_us
            if "id" in ev and ev.get("name") not in GLOBAL_FLOW_NAMES:
                # scope per-process ids: async/flow events match on
                # (cat, name, id) across pids, and every process counts
                # its request ids from 1
                ev["id"] = pid * ID_STRIDE + int(ev["id"])
            merged_events.append(ev)
        processes.append({
            "pid": pid,
            "source_pid": raw_pid,
            "process_name": str(doc.get("process_name") or f"pid {raw_pid}"),
            "file": src,
            "offset_us": round(offset_us, 3),
        })
    out = {
        "traceEvents": merged_events,
        "displayTimeUnit": "ms",
        "processes": processes,
    }
    if warnings:
        out["warnings"] = warnings
    return out


def merge_files(paths: list[str]) -> dict:
    docs = []
    for p in paths:
        with open(p) as f:
            docs.append(json.load(f))
    return merge(docs, sources=paths)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir", help="a fleet run's train.log_dir")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default <log_dir>/merged_trace.json)")
    args = ap.parse_args(argv)
    paths = discover(args.log_dir)
    if not paths:
        print(f"trace_merge: no obs_trace.json under {args.log_dir} "
              "(run with obs.trace=true)", file=sys.stderr)
        return 2
    merged = merge_files(paths)
    out_path = args.out or os.path.join(args.log_dir, "merged_trace.json")
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, out_path)
    for p in merged["processes"]:
        print(f"  {p['process_name']:<24} pid {p['pid']:<10} "
              f"offset {p['offset_us'] / 1e3:+.3f} ms  {p['file']}")
    for w in merged.get("warnings", []):
        print(f"  warning: {w}", file=sys.stderr)
    print(f"{len(merged['traceEvents'])} events from {len(paths)} process(es) "
          f"-> {out_path} (open in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

# Copy of scripts/obs_report.py: the port keeps its own copy so that it renders the port's runs without the
# JAX package's scripts/. Keep the two in step by hand.
#!/usr/bin/env python
"""Render a run's telemetry (metrics.jsonl + obs_registry.json +
hang_report.json if present) into a text summary — the post-run half of
docs/OBSERVABILITY.md. Pure stdlib file reading, no jax/tf import, so it
runs anywhere (CI after the tier-1 gate, a laptop against rsynced logs).

``--requests`` additionally renders the REQUEST view from obs_trace.json:
per-request waterfalls (queued / in-flight phase durations reconstructed
from the async ``b``/``e`` events serve/context.py emits, one row per
request id) and a per-phase quantile table (p50/p95/p99 straight from the
bucketed registry histograms — the same numbers ``GET /metrics`` exposes).

``--fleet`` renders the FLEET view from a cli/fleet.py run's log_dir: the
replica-slot layout, the merged cross-process trace if trace_merge.py built
one (with each lane's clock-alignment offset), and every
``incident_<reason>.json`` the flight recorder dumped (obs/fleet.py) —
trigger reason, brownout level, the event-ring census, the federated
window p99 / SLO burn rates at dump time, and the last ring events.

Usage: python -m yet_another_mobilenet_series_tpu_torch.obs.report [--requests] [--fleet]
           [--max-requests N] <log_dir>
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _load_jsonl(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


# histogram-suffix columns for the quantile tables (obs/registry.py snapshot
# expansion); values are seconds, rendered in ms
_Q_COLS = ("p50", "p95", "p99", "min", "max")


def _quantile_table(snap: dict, names: list[tuple[str, str]]) -> list[str]:
    """Aligned per-phase quantile rows for every histogram in ``names``
    ((registry name, label)) that has data."""
    rows = []
    header = f"  {'phase':<28} {'count':>7} " + " ".join(f"{c + '_ms':>9}" for c in _Q_COLS)
    for name, label in names:
        count = snap.get(f"{name}.count")
        if not count:
            continue
        cells = " ".join(f"{snap.get(f'{name}.{c}', 0.0) * 1e3:>9.3f}" for c in _Q_COLS)
        rows.append(f"  {label:<28} {count:>7.0f} {cells}")
    return [header] + rows if rows else []


def _request_waterfalls(trace_path: str, max_requests: int) -> list[str]:
    """Per-request phase waterfalls from the trace's async b/e events."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    # (id, name) -> [begin_ts, end_ts] in µs; ids are request ids
    spans: dict[tuple[int, str], list[float | None]] = {}
    args_by_id: dict[int, dict] = {}
    tids_by_id: dict[int, set] = {}
    for e in events:
        if e.get("ph") not in ("b", "e") or "id" not in e:
            continue
        key = (e["id"], e["name"])
        slot = spans.setdefault(key, [None, None])
        slot[0 if e["ph"] == "b" else 1] = e["ts"]
        if e.get("args"):  # "b" carries cls/deadline, "e" carries outcome
            args_by_id.setdefault(e["id"], {}).update(e["args"])
        tids_by_id.setdefault(e["id"], set()).add(e["tid"])
    rids = sorted({rid for rid, _ in spans})
    if not rids:
        return ["  no request events in the trace (obs.trace off, or no served load)"]
    lines = [f"  {len(rids)} request(s) in the trace ring; "
             f"showing {min(len(rids), max_requests)} "
             f"(admit -> queued -> in-flight -> done, host µs timestamps)"]
    for rid in rids[:max_requests]:
        def _dur(name):
            b, e = spans.get((rid, name), (None, None))
            return (e - b) / 1e3 if b is not None and e is not None else None
        total = _dur("serve/request")
        queued = _dur("serve/queued")
        inflight = _dur("serve/inflight")
        a = args_by_id.get(rid, {})
        outcome = a.get("outcome", "?")
        parts = [f"  #{rid:<6} class={a.get('cls', '?'):<12}"]
        for label, v in (("total", total), ("queued", queued), ("inflight", inflight)):
            parts.append(f"{label}={v:.2f}ms" if v is not None else f"{label}=?")
        parts.append(f"threads={len(tids_by_id.get(rid, ()))}")
        lines.append(" ".join(parts) + (f" [{outcome}]" if outcome != "?" else ""))
    return lines


def _fleet_section(log_dir: str) -> list[str]:
    """The fleet view: replica layout, merged trace, incident artifacts."""
    lines = ["\n## fleet"]
    replica_dirs = sorted(
        d for d in glob.glob(os.path.join(log_dir, "r*")) if os.path.isdir(d))
    traced = [d for d in replica_dirs
              if os.path.exists(os.path.join(d, "obs_trace.json"))]
    lines.append(f"  replica slots: {len(replica_dirs)} "
                 f"({len(traced)} with traces)")
    merged = os.path.join(log_dir, "merged_trace.json")
    if os.path.exists(merged):
        with open(merged) as f:
            doc = json.load(f)
        procs = doc.get("processes", [])
        lines.append(f"  merged trace: {merged} "
                     f"({len(doc.get('traceEvents', []))} events, "
                     f"{len(procs)} process lanes) — open in ui.perfetto.dev")
        for p in procs:
            lines.append(f"    {p.get('process_name', '?'):<24} "
                         f"offset {p.get('offset_us', 0.0) / 1e3:+.3f} ms  "
                         f"{p.get('file', '')}")
    elif traced or os.path.exists(os.path.join(log_dir, "obs_trace.json")):
        lines.append("  merged trace: not built — "
                     f"python -m yet_another_mobilenet_series_tpu_torch.obs.trace_merge {log_dir}")
    incidents = sorted(glob.glob(os.path.join(log_dir, "incident_*.json")))
    if not incidents:
        lines.append("  incidents: none recorded "
                     "(no ejection / brownout / fast-burn trigger fired)")
    for path in incidents:
        with open(path) as f:
            doc = json.load(f)
        events = doc.get("events", [])
        lines.append(f"  !! incident: {os.path.basename(path)} — "
                     f"reason = {doc.get('reason')}, "
                     f"brownout L{doc.get('brownout_level', 0)}, "
                     f"{len(events)} ring events")
        kinds: dict[str, int] = {}
        for e in events:
            kinds[str(e.get("kind", "?"))] = kinds.get(str(e.get("kind", "?")), 0) + 1
        if kinds:
            lines.append("    events: " + ", ".join(
                f"{k} x{v}" for k, v in sorted(kinds.items())))
        fleet = doc.get("fleet") or {}
        for cls, v in sorted((fleet.get("window_p99_s") or {}).items()):
            if v:
                lines.append(f"    window p99 [{cls}] = {v * 1e3:.2f} ms")
        slo = fleet.get("slo") or {}
        if slo:
            lines.append(
                f"    slo: burn short {slo.get('burn_short', 0):.2f} / "
                f"long {slo.get('burn_long', 0):.2f}"
                f"{' — FAST BURN' if slo.get('fast_burn') else ''} "
                f"(target p99 {slo.get('target_p99_ms', 0):.0f} ms, "
                f"budget {slo.get('error_budget', 0):.3g})")
        reps = fleet.get("replicas") or {}
        if reps:
            lines.append(f"    federated replicas at dump: {len(reps)} "
                         f"({', '.join(sorted(reps))})")
        for e in events[-5:]:
            extras = " ".join(f"{k}={v}" for k, v in e.items()
                              if k not in ("t_unix", "kind"))
            lines.append(f"    last: {e.get('kind')}"
                         + (f" {extras}" if extras else ""))
    return lines


def summarize(log_dir: str, requests: bool = False, max_requests: int = 20,
              fleet: bool = False) -> str:
    lines = [f"# obs report: {log_dir}"]

    metrics_path = os.path.join(log_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        rows = _load_jsonl(metrics_path)
        if rows:
            lines.append(f"\n## metrics.jsonl ({len(rows)} rows, "
                         f"steps {rows[0].get('step', '?')}..{rows[-1].get('step', '?')})")
            train_rows = [r for r in rows if any(k.startswith("train/") for k in r)]
            eval_rows = [r for r in rows if any(k.startswith("eval/") for k in r)]
            if train_rows:
                last = train_rows[-1]
                for key in ("train/loss", "train/images_per_sec", "train/images_per_sec_per_chip"):
                    if key in last:
                        lines.append(f"  last {key} = {last[key]:.6g} (step {last['step']})")
            if eval_rows:
                best = max(eval_rows, key=lambda r: r.get("eval/top1", float("-inf")))
                if "eval/top1" in best:
                    lines.append(f"  best eval/top1 = {best['eval/top1']:.6g} (step {best['step']})")
                last = eval_rows[-1]
                for key in ("eval/top1", "eval/loss"):
                    if key in last:
                        lines.append(f"  last {key} = {last[key]:.6g} (step {last['step']})")
        else:
            lines.append("\n## metrics.jsonl: empty")
    else:
        lines.append("\n## metrics.jsonl: missing")

    reg_path = os.path.join(log_dir, "obs_registry.json")
    if os.path.exists(reg_path):
        with open(reg_path) as f:
            snap = json.load(f)
        lines.append(f"\n## registry snapshot ({len(snap)} metrics)")
        for name in sorted(snap):
            lines.append(f"  {name} = {snap[name]:.6g}")
        if any(k.startswith("serve.") for k in snap):
            # serving run (docs/SERVING.md): derive the headline numbers from
            # the histograms the engine/batcher populate
            lines.append("\n## serving")
            lines.append(
                "  requests = {:.0f}, completed = {:.0f}, shed = {:.0f}, "
                "rejected = {:.0f}".format(
                    snap.get("serve.requests", 0), snap.get("serve.completed", 0),
                    snap.get("serve.shed_deadline", 0), snap.get("serve.rejected_full", 0))
            )
            for h, label in (("serve.queue_wait_seconds", "queue wait"),
                             ("serve.run_seconds", "run latency"),
                             ("serve.dispatch_seconds", "dispatch"),
                             ("serve.h2d_seconds", "h2d transfer"),
                             ("serve.slot_wait_seconds", "slot fence wait"),
                             ("serve.dispatch_to_complete_seconds", "dispatch->complete")):
                if snap.get(f"{h}.count"):
                    lines.append(
                        f"  {label}: p50 {snap.get(f'{h}.p50', 0) * 1e3:.2f} / "
                        f"p95 {snap.get(f'{h}.p95', 0) * 1e3:.2f} / "
                        f"p99 {snap.get(f'{h}.p99', 0) * 1e3:.2f} ms, "
                        f"min {snap.get(f'{h}.min', 0) * 1e3:.2f} ms, "
                        f"mean {snap.get(f'{h}.mean', 0) * 1e3:.2f} ms, "
                        f"max {snap.get(f'{h}.max', 0) * 1e3:.2f} ms over {snap[f'{h}.count']:.0f}"
                    )
            if snap.get("serve.batch_size.count"):
                lines.append(
                    f"  batch size: mean {snap['serve.batch_size.mean']:.2f}, "
                    f"max {snap['serve.batch_size.max']:.0f}"
                )
            if snap.get("serve.graph_replays"):
                # the port's engine (serve/engine.py): a dispatch on the card
                # replays the bucket's CUDA graph
                lines.append(
                    f"  cuda graph replays: {snap['serve.graph_replays']:.0f} over "
                    f"{snap.get('serve.dispatch_seconds.count', 0):.0f} dispatches"
                )
            if snap.get("serve.shed_at_completion"):
                lines.append(
                    f"  shed at completion: {snap['serve.shed_at_completion']:.0f} "
                    "(deadline passed while the batch executed)"
                )
            if snap.get("serve.fused_dispatches"):
                lines.append(
                    f"  fused dispatches: {snap['serve.fused_dispatches']:.0f} "
                    f"covering {snap.get('serve.fused_chunks', 0):.0f} chunks "
                    "(whole-request lax.scan pieces)"
                )
            if snap.get("serve.evicted_executables"):
                lines.append(
                    f"  off-ladder executables evicted: "
                    f"{snap['serve.evicted_executables']:.0f} (LRU bound)"
                )
            if snap.get("serve.ring_dispatches"):
                # device-resident ring (docs/SERVING.md "Device-resident
                # ring"): slots/window is the dispatch-amortization factor
                lines.append(
                    "  ring windows: {:.0f} dispatches, {:.2f} slots/window "
                    "(max {:.0f}), last fill {:.0%}".format(
                        snap["serve.ring_dispatches"],
                        snap.get("serve.ring_slots_per_dispatch.mean", 0),
                        snap.get("serve.ring_slots_per_dispatch.max", 0),
                        snap.get("serve.ring_fill", 0))
                )
            if snap.get("serve.dispatches_per_wakeup.count"):
                lines.append(
                    "  dispatches/wakeup: mean {:.2f}, max {:.0f} over {:.0f} "
                    "wake-ups (> 1 = back-to-back runs engaged)".format(
                        snap["serve.dispatches_per_wakeup.mean"],
                        snap["serve.dispatches_per_wakeup.max"],
                        snap["serve.dispatches_per_wakeup.count"])
                )
            if snap.get("serve.dispatched_bytes"):
                lines.append(
                    "  dispatched cost: {:.2f} GFLOP, {:.2f} GB accessed "
                    "(achieved {:.3g} FLOP/s)".format(
                        snap.get("serve.dispatched_flops", 0) / 1e9,
                        snap["serve.dispatched_bytes"] / 1e9,
                        snap.get("serve.achieved_flops_per_s", 0))
                )
            if snap.get("serve.h2d_bytes"):
                # the quantized-serving wire instrument: exact staged bytes
                # (docs/SERVING.md "Quantized serving"); per-dispatch mean
                # quarters when serve.quant.wire=uint8
                n_disp = snap.get("serve.dispatch_seconds.count", 0)
                per = snap["serve.h2d_bytes"] / n_disp if n_disp else 0.0
                lines.append(
                    "  wire bytes (h2d): {:.3f} GB staged{}".format(
                        snap["serve.h2d_bytes"] / 1e9,
                        f", {per / 1e6:.3f} MB/dispatch" if per else "")
                )
            if snap.get("serve.int8_exports"):
                lines.append(
                    f"  int8 exports: {snap['serve.int8_exports']:.0f} "
                    "(gated post-training weight quantization)"
                )
            # the QoS/resilience edge (serve/admission.py) — per-class
            # accounting + breaker/retry/drain health, when it was in play
            classes = sorted(
                k.rsplit(".", 1)[-1] for k in snap
                if k.startswith("serve.requests.") and not k.endswith((".count", ".sum", ".mean", ".max"))
            )
            for cls in classes:
                lat = f"serve.latency_seconds.{cls}"
                row = (
                    f"  [{cls}] admitted = {snap.get(f'serve.requests.{cls}', 0):.0f}, "
                    f"completed = {snap.get(f'serve.completed.{cls}', 0):.0f}, "
                    f"rejected = {snap.get(f'serve.rejected.{cls}', 0):.0f}"
                )
                if snap.get(f"{lat}.count"):
                    row += (f", latency p50 {snap.get(f'{lat}.p50', 0) * 1e3:.2f} / "
                            f"p99 {snap.get(f'{lat}.p99', 0) * 1e3:.2f} ms "
                            f"(min {snap.get(f'{lat}.min', 0) * 1e3:.2f}, "
                            f"max {snap[f'{lat}.max'] * 1e3:.2f})")
                lines.append(row)
            if classes or snap.get("serve.breaker_opens") or snap.get("serve.retries"):
                breaker = {0: "closed", 1: "OPEN", 2: "half-open"}.get(
                    int(snap.get("serve.breaker_state", 0)), "?")
                lines.append(
                    f"  resilience: breaker {breaker} "
                    f"(opened {snap.get('serve.breaker_opens', 0):.0f}x), "
                    f"retries = {snap.get('serve.retries', 0):.0f}, "
                    f"engine failures = {snap.get('serve.engine_failures', 0):.0f}, "
                    f"drain timeouts = {snap.get('serve.drain_timeouts', 0):.0f}, "
                    f"thread crashes = {snap.get('serve.thread_crashes', 0):.0f}"
                )
            hits = {k.rsplit(".", 1)[-1]: v for k, v in snap.items() if k.startswith("serve.bucket_hits.")}
            if hits:
                lines.append("  bucket hits: " + ", ".join(f"{b}: {v:.0f}" for b, v in sorted(hits.items(), key=lambda kv: int(kv[0]))))
            if snap.get("serve.brownout_transitions") or snap.get("serve.brownout_level"):
                # the degradation ladder (serve/brownout.py): where it sits
                # now and how much it moved — recovery to L0 with up == down
                # transition counts is the healthy end state of a storm
                lines.append(
                    f"  brownout: level = L{snap.get('serve.brownout_level', 0):.0f}, "
                    f"transitions = {snap.get('serve.brownout_transitions', 0):.0f} "
                    f"(up {snap.get('serve.brownout_transitions.up', 0):.0f}, "
                    f"down {snap.get('serve.brownout_transitions.down', 0):.0f}), "
                    f"shed at door = {snap.get('serve.rejected_brownout', 0):.0f}, "
                    f"hedges suppressed = {snap.get('serve.hedges_suppressed', 0):.0f}"
                )
            if snap.get("fleet.routed") or snap.get("fleet.spawns"):
                # the replica-fleet tier (serve/router.py + cli/fleet.py):
                # routing, hedging, supervision, and scaling accounting
                lines.append(
                    f"  fleet: routed = {snap.get('fleet.routed', 0):.0f} "
                    f"(retries {snap.get('fleet.route_retries', 0):.0f}, "
                    f"errors {snap.get('fleet.route_errors', 0):.0f}, "
                    f"backpressure {snap.get('fleet.backpressure', 0):.0f}), "
                    f"replicas routable = {snap.get('fleet.replicas_routable', 0):.0f}"
                    f"/{snap.get('fleet.replicas', 0):.0f}, "
                    f"ejections = {snap.get('fleet.ejections', 0):.0f} "
                    f"(slow {snap.get('fleet.slow_ejections', 0):.0f}), "
                    f"readmissions = {snap.get('fleet.readmissions', 0):.0f}, "
                    f"restarts detected = {snap.get('fleet.replica_restarts', 0):.0f}"
                )
                lines.append(
                    f"  fleet lifecycle: spawns = {snap.get('fleet.spawns', 0):.0f} "
                    f"(failed {snap.get('fleet.spawn_failures', 0):.0f}), "
                    f"restarts = {snap.get('fleet.restarts', 0):.0f}, "
                    f"rolling restarts = {snap.get('fleet.rolling_restarts', 0):.0f}, "
                    f"chaos kills = {snap.get('fleet.chaos_kills', 0):.0f} "
                    f"(degrades {snap.get('fleet.chaos_degrades', 0):.0f}), "
                    f"scale ups/downs = {snap.get('fleet.scale_ups', 0):.0f}"
                    f"/{snap.get('fleet.scale_downs', 0):.0f}"
                )
            if (snap.get("fleet.partition_ejections") or snap.get("serve.client.connect_timeouts")
                    or snap.get("serve.netchaos.connections")):
                # partition containment (serve/netchaos.py + the connect/
                # read split): transport-shaped ejections vs crash-shaped,
                # handshake timeouts, and injected socket chaos accounting
                lines.append(
                    f"  partitions: partition ejections = "
                    f"{snap.get('fleet.partition_ejections', 0):.0f}, "
                    f"client connect timeouts = "
                    f"{snap.get('serve.client.connect_timeouts', 0):.0f}, "
                    f"netchaos conns = {snap.get('serve.netchaos.connections', 0):.0f} "
                    f"(blackholed {snap.get('serve.netchaos.blackholed', 0):.0f}, "
                    f"resets {snap.get('serve.netchaos.resets', 0):.0f}, "
                    f"half-open {snap.get('serve.netchaos.half_open', 0):.0f}, "
                    f"chaos partitions {snap.get('fleet.chaos_partitions', 0):.0f})"
                )
            if snap.get("fleet.registrations") or snap.get("fleet.lease_expirations"):
                # TTL-leased membership (the multi-host registration path):
                # joins, heartbeat renewals, and leases that lapsed — a
                # nonzero expiration count is a replica that VANISHED
                lines.append(
                    f"  fleet membership: registrations = "
                    f"{snap.get('fleet.registrations', 0):.0f} "
                    f"(renewals {snap.get('fleet.lease_renewals', 0):.0f}, "
                    f"deregistrations {snap.get('fleet.deregistrations', 0):.0f}), "
                    f"lease expirations = {snap.get('fleet.lease_expirations', 0):.0f}, "
                    f"replica heartbeats = {snap.get('serve.register_heartbeats', 0):.0f} "
                    f"(failed {snap.get('serve.register_failures', 0):.0f})"
                )
            if snap.get("serve.hedges"):
                wins = snap.get("serve.hedge_wins", 0)
                lines.append(
                    f"  hedging: fired = {snap['serve.hedges']:.0f}, "
                    f"wins = {wins:.0f} "
                    f"({100.0 * wins / snap['serve.hedges']:.0f}%), "
                    f"losers dropped = {snap.get('serve.hedge_wasted', 0):.0f}"
                )
        if any(k in snap for k in ("train.forced_host_syncs", "ckpt.saves", "ckpt.restores",
                                   "data.epoch_order_seconds", "data.record_decode_failures")):
            # the port's training books (cli/train.py, ckpt/manager.py,
            # data/pipeline.py): host syncs forced outside a step, the
            # checkpoints and their waits, the TFRecord stream's order
            lines.append("\n## training (host syncs / checkpoints / input)")
            lines.append(
                f"  steps = {snap.get('train.step', 0):.0f}, "
                f"forced host syncs = {snap.get('train.forced_host_syncs', 0):.0f}"
            )
            lines.append(
                f"  checkpoints: saves = {snap.get('ckpt.saves', 0):.0f}, "
                f"restores = {snap.get('ckpt.restores', 0):.0f} "
                f"(fallbacks {snap.get('ckpt.restore_fallbacks', 0):.0f}, "
                f"integrity failures {snap.get('ckpt.integrity_failures', 0):.0f}), "
                f"wait p50 {snap.get('ckpt.wait_seconds.p50', 0) * 1e3:.2f} / "
                f"max {snap.get('ckpt.wait_seconds.max', 0) * 1e3:.2f} ms "
                f"over {snap.get('ckpt.wait_seconds.count', 0):.0f}"
            )
            if "data.epoch_order_seconds" in snap or "data.record_decode_failures" in snap:
                lines.append(
                    f"  input: epoch order {snap.get('data.epoch_order_seconds', 0):.3f} s (last epoch), "
                    f"record decode failures = {snap.get('data.record_decode_failures', 0):.0f}, "
                    f"corrupt batches skipped = {snap.get('data.corrupt_records', 0):.0f}"
                )
        if snap.get("obs.compiles") or any(k.startswith("obs.cost_flops.") for k in snap):
            # the port's eager train step compiles nothing but records its
            # cost: the section shows whenever either is in the registry
            # device telemetry (obs/device.py, docs/OBSERVABILITY.md "Device
            # telemetry"): compile events, per-executable cost accounting,
            # dispatch efficiency, memory gauges
            lines.append("\n## device (compile / cost / memory)")
            lines.append(
                f"  compiles = {snap.get('obs.compiles', 0):.0f}, compile time "
                f"p50 {snap.get('obs.compile_seconds.p50', 0):.2f}s / "
                f"max {snap.get('obs.compile_seconds.max', 0):.2f}s "
                f"(sum {snap.get('obs.compile_seconds.sum', 0):.1f}s)"
            )
            for k in sorted(snap):
                if k.startswith("obs.cost_flops."):
                    key = k[len("obs.cost_flops."):]
                    lines.append(
                        f"  [{key}] {snap[k] / 1e9:.3f} GFLOP, "
                        f"{snap.get(f'obs.cost_bytes.{key}', 0) / 1e6:.1f} MB accessed"
                    )
            if snap.get("serve.achieved_flops_per_s"):
                lines.append(
                    f"  dispatch efficiency: {snap['serve.achieved_flops_per_s'] / 1e9:.2f} "
                    f"achieved GFLOP/s (cost FLOPs / measured serve.run_seconds)"
                )
            mem = []
            if snap.get("host.rss_bytes"):
                mem.append(f"host rss {snap['host.rss_bytes'] / 1e6:.0f} MB")
            if "device.live_buffer_bytes" in snap:
                mem.append(f"live device buffers {snap['device.live_buffer_bytes'] / 1e6:.1f} MB")
            for k in sorted(snap):
                if k.startswith("device.bytes_in_use."):
                    d = k.rsplit(".", 1)[-1]
                    peak = snap.get(f"device.peak_bytes_in_use.{d}", 0)
                    mem.append(f"{d} in-use {snap[k] / 1e6:.0f} MB (peak {peak / 1e6:.0f})")
            if mem:
                lines.append("  memory: " + ", ".join(mem))
    else:
        lines.append("\n## registry snapshot: missing (run predates obs/ or crashed before flush)")

    hang_path = os.path.join(log_dir, "hang_report.json")
    if os.path.exists(hang_path):
        with open(hang_path) as f:
            hang = json.load(f)
        lines.append(
            f"\n## !! HANG REPORT !! (stalled {hang.get('seconds_since_last_beat', 0):.1f}s, "
            f"deadline {hang.get('deadline_s', 0):.1f}s)"
        )
        lines.append(f"  last step {hang.get('last_step')} in phase '{hang.get('last_phase')}'")
        for span in hang.get("open_spans", []):
            lines.append(f"  open span: {span.get('name')} [{span.get('cat')}] "
                         f"open {span.get('open_for_s', 0):.1f}s")
        lines.append(f"  thread stacks: {len(hang.get('threads', {}))} (see {hang_path})")

    trace_path = os.path.join(log_dir, "obs_trace.json")
    if os.path.exists(trace_path):
        with open(trace_path) as f:
            n_events = len(json.load(f).get("traceEvents", []))
        lines.append(f"\n## span trace: {trace_path} ({n_events} events) — "
                     "open in ui.perfetto.dev or chrome://tracing")

    if requests:
        lines.append("\n## per-phase quantiles (registry histograms)")
        snap = {}
        if os.path.exists(reg_path):
            with open(reg_path) as f:
                snap = json.load(f)
        phase_names = [
            ("serve.queue_wait_seconds", "queue wait"),
            ("serve.dispatch_seconds", "stage+dispatch"),
            ("serve.dispatch_to_complete_seconds", "dispatch->complete"),
            ("serve.run_seconds", "run (predict->logits)"),
        ] + [
            (k[: -len(".count")], f"latency [{k.split('.')[-2]}]")
            for k in sorted(snap)
            if k.startswith("serve.latency_seconds.") and k.endswith(".count")
        ]
        table = _quantile_table(snap, phase_names)
        lines.extend(table if table else ["  no serving histograms in the registry snapshot"])
        lines.append("\n## request waterfalls (trace async events)")
        if os.path.exists(trace_path):
            lines.extend(_request_waterfalls(trace_path, max_requests))
        else:
            lines.append("  obs_trace.json missing (run with obs.trace=true)")

    if fleet:
        lines.extend(_fleet_section(log_dir))

    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_dir", help="a run's train.log_dir")
    ap.add_argument("--requests", action="store_true",
                    help="render per-request waterfalls + per-phase quantile tables")
    ap.add_argument("--fleet", action="store_true",
                    help="render the fleet view (merged trace, incident artifacts)")
    ap.add_argument("--max-requests", type=int, default=20,
                    help="waterfall rows to print (oldest ids first)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.log_dir):
        print(f"obs_report: not a directory: {args.log_dir}", file=sys.stderr)
        return 2
    print(summarize(args.log_dir, requests=args.requests,
                    max_requests=args.max_requests, fleet=args.fleet))
    return 0


if __name__ == "__main__":
    sys.exit(main())

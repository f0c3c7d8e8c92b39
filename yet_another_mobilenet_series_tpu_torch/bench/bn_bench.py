"""The BatchNorm-mode A/B on the port's train step on one card: the torch
twin of ``scripts/bench_bn.py``'s variant A/B.

It builds the headline recipe (``utils/benchkit.py``
:func:`build_train_fixture`: MobileNetV3-Large 1.0, bf16, RMSProp, EMA, a
batch made on the device) once per variant and times its train step:

- a variant is ``bn_mode:remat[:dot]``: a mode of ``ops/layers.py``
  ``BN_MODES``; ``remat`` 0 (off), 1 or ``full`` (every block recomputed in
  the backward) or ``save_conv`` (the convolutions' outputs kept, the BN and
  activation chains recomputed); a trailing ``:dot`` runs the 1x1 convs as
  matmuls (``train.conv1x1_dot``). Every token is checked before anything
  touches the card;
- each row: ``ms_per_step``, the median over ``--iters`` steps after three
  warm-up steps, each step between two CUDA events (steps are chained, so a
  step the host enqueues slower than the card runs it is timed at the
  host's pace); ``img_s_per_chip`` (the batch over that median); ``loss``
  after the timed steps; ``compile_s``, the first step (cuDNN's choices and
  the allocator's first blocks); and ``vs_exact``, ``exact:0``'s median over
  this one's;
- ``--dispatch-probe`` (after the variants): ``exact:0`` eager against K=4
  steps replayed as one CUDA graph (``parallel/dp.py`` ``GroupedStep``), the
  port's counterpart of the source's ``lax.scan`` probe. Its row's
  ``dispatch_tax_ms`` is the eager median minus the graph's per step
  (``ms_per_step_chained`` minus ``ms_per_step``); its ``bn_mode`` names no
  mode, so ``bench/tuning_decide.py`` never adopts it.

The artifact (``--out``) is rewritten after every variant with ``partial:
true``, then once more complete; the last line of stdout is the same JSON,
stamped with the card (``card_provenance``). A failure prints a line with
``value: null`` and ``error`` and exits 1, as does a request for the card
(the default) on a machine without one. ``--device cpu`` rehearses at a
smoke scale (batch <= 8, image <= 32, iters <= 3): ``cpu_rehearsal: true``
and every time null.

Not ported: ``--xla-flags-sweep`` (XLA flags have no torch counterpart,
ROADMAP queue 1, item 12) is refused.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.bn_bench
           [--variants exact:0,folded:0,...] [--batch 256] [--iters 20]
           [--image-size 224] [--dispatch-probe] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from ..ops.layers import BN_MODES
from ..utils.benchkit import build_train_fixture, card_provenance, percentile, sync
from ..utils.device import resolve_device

DEFAULT_VARIANTS = ("exact:0,folded:0,compute:0,fused_vjp:0,sdot:0,compute_sdot:0,exact:full,exact:save_conv,"
                    "compute:save_conv,exact:0:dot,sdot:0:dot")
WARMUP = 3
DISPATCH_K = 4
BENCH = "bn_mode_train_step_ab"
# --xla-flags-sweep is refused: XLA flags have no torch counterpart
SWEEP_REFUSED = "--xla-flags-sweep is not ported (ROADMAP queue 1, item 12: XLA flags have no torch counterpart)"


def parse_variants(spec: str) -> list[tuple[str, bool, str, bool]]:
    """``(bn_mode, remat, remat_policy, conv1x1_dot)`` of each token of
    ``spec``; raises ValueError naming the first bad token (the source's
    messages)."""
    variants = []
    for spec_str in spec.split(","):
        parts = spec_str.strip().split(":")
        if len(parts) < 2:
            raise ValueError(f"malformed variant {spec_str.strip()!r} (expected bn_mode:remat[:dot])")
        mode, remat_s, extra = parts[0], parts[1], parts[2:]
        if mode not in BN_MODES:
            raise ValueError(f"unknown bn_mode token {mode!r} in --variants (valid: {BN_MODES})")
        if remat_s not in ("0", "1", "full", "save_conv"):
            raise ValueError(f"unknown remat token {remat_s!r} in --variants (use 0, 1, full, or save_conv)")
        if extra not in ([], ["dot"]):
            raise ValueError(f"unknown trailing token(s) {extra!r} in --variants (only ':dot' is valid)")
        variants.append((mode, remat_s != "0", "save_conv" if remat_s == "save_conv" else "full", bool(extra)))
    return variants


def _timed_steps(step_fn, ts, batch, gen, iters: int, cuda: bool):
    """(ts, metrics, per-step ms by CUDA events or None on the CPU)."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)] \
        if cuda else []
    for i in range(iters):
        if cuda:
            events[i][0].record()
        ts, m = step_fn(ts, batch, gen)
        if cuda:
            events[i][1].record()
    sync(batch["image"].device)
    return ts, m, sorted(a.elapsed_time(b) for a, b in events) if cuda else None


def _loss(m) -> float:
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    return loss


def measure_variant(args, dev: torch.device, mode: str, remat: bool, policy: str, dot: bool) -> dict:
    cuda = dev.type == "cuda"
    step_fn, ts, batch, _, gen = build_train_fixture(args.batch, args.image_size, bn_mode=mode, remat=remat,
                                                     remat_policy=policy, conv1x1_dot=dot, device=dev)
    t0 = time.perf_counter()
    ts, m = step_fn(ts, batch, gen)
    sync(dev)
    compile_s = time.perf_counter() - t0
    for _ in range(WARMUP):
        ts, m = step_fn(ts, batch, gen)
    sync(dev)
    ts, m, ms = _timed_steps(step_fn, ts, batch, gen, args.iters, cuda)
    med = percentile(ms, 0.5) if cuda else None
    return {"bn_mode": mode, "remat": policy if remat else "off", "conv1x1_dot": dot,
            "ms_per_step": med, "ms_per_step_p90": percentile(ms, 0.9) if cuda else None,
            "img_s_per_chip": args.batch / med * 1e3 if cuda else None,
            "compile_s": compile_s if cuda else None, "loss": _loss(m), "timed_steps": args.iters}


def dispatch_probe(args, dev: torch.device) -> dict:
    """``exact:0`` eager (the variants' way) against DISPATCH_K steps
    replayed as one CUDA graph, from one fixture: the eager steps first,
    then the graph's (captured at its first call, which is not timed)."""
    from ..parallel.dp import GroupedStep

    cuda = dev.type == "cuda"
    step_fn, ts, batch, _, gen = build_train_fixture(args.batch, args.image_size, device=dev)
    for _ in range(WARMUP + 1):
        ts, m = step_fn(ts, batch, gen)
    sync(dev)
    ts, m, eager = _timed_steps(step_fn, ts, batch, gen, args.iters, cuda)
    grouped = GroupedStep(step_fn, DISPATCH_K, graph=cuda, why_eager="cpu")
    batches = [batch] * DISPATCH_K
    ts, ms = grouped(ts, batches, gen)
    sync(dev)
    replays = max(1, args.iters // DISPATCH_K)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(replays)] \
        if cuda else []
    for i in range(replays):
        if cuda:
            events[i][0].record()
        ts, ms = grouped(ts, batches, gen)
        if cuda:
            events[i][1].record()
    sync(dev)
    loss = _loss(ms[-1])
    row = {"bn_mode": f"exact[graph{DISPATCH_K}]", "remat": "off", "conv1x1_dot": False, "mode": grouped.mode,
           "loss": loss, "timed_steps": replays * DISPATCH_K,
           "note": f"{DISPATCH_K} steps replayed as one CUDA graph against eager steps; not an adoptable variant"}
    if not cuda:
        return dict(row, ms_per_step=None, ms_per_step_chained=None, dispatch_tax_ms=None, img_s_per_chip=None)
    graph_ms = percentile(sorted(a.elapsed_time(b) / DISPATCH_K for a, b in events), 0.5)
    eager_ms = percentile(eager, 0.5)
    return dict(row, ms_per_step=graph_ms, ms_per_step_chained=eager_ms, dispatch_tax_ms=eager_ms - graph_ms,
                img_s_per_chip=args.batch / graph_ms * 1e3)


def _artifact(args, dev, rows: list, planned: int, partial: bool) -> dict:
    base = next((r for r in rows if r["bn_mode"] == "exact" and r["remat"] == "off" and not r["conv1x1_dot"]), None)
    for r in rows:
        if base is not None and base["ms_per_step"] and r.get("ms_per_step"):
            r["vs_exact"] = base["ms_per_step"] / r["ms_per_step"]
    return {"bench": BENCH, "platform": dev.type, "cpu_rehearsal": dev.type == "cpu",
            "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "batch": args.batch, "image_size": args.image_size, "iters": args.iters, "dtype": "bfloat16",
            "arch": "mobilenet_v3_large", "variants_completed": len(rows), "variants_planned": planned,
            "partial": partial,
            "method": f"median of per-step CUDA-event times over chained steps after {WARMUP} warm-up steps",
            "rows": rows}


def _write(path: str, out: dict) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


def run(args) -> dict:
    """The A/B; the artifact goes to ``args.out`` after every variant."""
    if args.xla_flags_sweep:
        raise ValueError(SWEEP_REFUSED)
    variants = parse_variants(args.variants)
    if args.out:
        open(args.out, "a").close()  # writable before the first variant, never truncating a partial one
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        args.batch, args.image_size, args.iters = min(args.batch, 8), min(args.image_size, 32), min(args.iters, 3)
    planned = len(variants) + (1 if args.dispatch_probe else 0)
    rows: list = []
    for mode, remat, policy, dot in variants:
        rows.append(measure_variant(args, dev, mode, remat, policy, dot))
        print(f"bn_bench: {mode}:{rows[-1]['remat']}:dot={int(dot)} {rows[-1]['ms_per_step']} ms/step, loss "
              f"{rows[-1]['loss']:.4f}", file=sys.stderr, flush=True)
        _write(args.out, _artifact(args, dev, rows, planned, partial=True))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.dispatch_probe:
        rows.append(dispatch_probe(args, dev))
        print(f"bn_bench: dispatch probe {rows[-1]['ms_per_step_chained']} eager vs {rows[-1]['ms_per_step']} "
              f"graph ms/step ({rows[-1]['mode']})", file=sys.stderr, flush=True)
    return _artifact(args, dev, rows, planned, partial=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma list of bn_mode:remat[:dot]; remat 0 (off), 1/full or save_conv; ':dot' runs "
                         "the 1x1 convs as matmuls")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--dispatch-probe", action="store_true",
                    help=f"after the variants, exact:0 eager against {DISPATCH_K} steps as one CUDA graph")
    ap.add_argument("--xla-flags-sweep", action="store_true", help=SWEEP_REFUSED)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="the artifact, rewritten after every variant")
    args = ap.parse_args(argv)
    rc = 0
    try:
        out = run(args)
        out["value"] = next((r["ms_per_step"] for r in out["rows"] if r["bn_mode"] == "exact"
                             and r["remat"] == "off" and not r["conv1x1_dot"]), None)
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out = {"bench": BENCH, "value": None, "error": f"{type(e).__name__}: {e}"}
        rc = 1
    out.update(metric="mobilenet_v3_large_bn_mode_ab_exact_ms_per_step", unit="ms per step (exact:0)",
               provenance=card_provenance(args.device))
    if rc == 0:
        _write(args.out, out)
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

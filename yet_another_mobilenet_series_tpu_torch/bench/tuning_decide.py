"""The adoption rule: from a ``bench/bn_bench.py`` artifact measured on the
card to the port's tuning file, the torch twin of ``scripts/tpu_watch.py``
``decide`` (:196) and ``_decide_dispatch`` (:292).

The rules are the source's, with its constants:

- a variant is adopted when it beats ``exact:0`` (no remat, no ``:dot``) by
  more than ``WIN_THRESHOLD`` (3%); only ``PARITY_SAFE_MODES`` are eligible,
  and ``COMPUTE_MODES`` too with ``--allow-compute``, whose win is then
  marked ``provisional`` in the decision and the tuning file;
- a variant whose loss is more than ``LOSS_SANITY_ABS`` from the
  baseline's is skipped;
- an artifact marked ``contention_invalidated`` adopts nothing;
- keys the rule does not own (``flags``, ``steps_per_dispatch``) are kept;
  when nothing wins (or there is no baseline), a stale adoption's A/B keys
  are dropped;
- the dispatch probe's row: a tax above ``DISPATCH_TAX_THRESHOLD`` (3%) of
  the eager step sets ``steps_per_dispatch`` = ``DISPATCH_K`` (4); below it
  the key is dropped; no probe row leaves it as it was.

It writes the tuning file (default ``BENCH_TUNING_TORCH.json`` at the
repository root, which ``train/tuning.py`` validates and ``cli/train.py``
applies with ``train.tuning_file``) and a decision record, and never writes
the JAX package's ``BENCH_TUNING.json``. It refuses an artifact that is
partial or was not measured on a card (a CPU rehearsal's times are null).

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.tuning_decide
           AB.json [--tuning BENCH_TUNING_TORCH.json] [--decision BENCH_TUNING_TORCH_decision.json]
           [--allow-compute]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TUNING_PATH = os.path.join(REPO, "BENCH_TUNING_TORCH.json")
JAX_TUNING_NAME = "BENCH_TUNING.json"

WIN_THRESHOLD = 1.03
PARITY_SAFE_MODES = ("exact", "folded", "fused_vjp", "sdot")
COMPUTE_MODES = ("compute", "compute_sdot")
LOSS_SANITY_ABS = 0.02
DISPATCH_TAX_THRESHOLD = 0.03
DISPATCH_K = 4
# the keys each rule owns; every other key of the tuning file is kept
AB_KEYS = ("bn_mode", "remat", "remat_policy", "conv1x1_dot", "source", "provisional")
DISPATCH_KEYS = ("steps_per_dispatch", "steps_per_dispatch_source")
PROVISIONAL = ("compute-family win: its bf16 normalize is not parity-safe; re-validate top-1 on real data before a "
               "production run")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_tuning(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def write_tuning(path: str, tuning: dict) -> None:
    """Writes ``tuning``; an empty one removes the file (a file with no
    keys would still read as tuned)."""
    if os.path.basename(path) == JAX_TUNING_NAME:
        raise ValueError(f"{path} is the JAX package's tuning file; the port's is BENCH_TUNING_TORCH.json")
    if tuning:
        with open(path, "w") as f:
            json.dump(tuning, f, indent=1)
            f.write("\n")
    else:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


def _drop_stale_ab(path: str, why: str) -> None:
    tuning = read_tuning(path)
    kept = {k: v for k, v in tuning.items() if k not in AB_KEYS}
    if kept != tuning or not kept:
        write_tuning(path, kept)
    log(f"decision: {why}; A/B tuning keys cleared" + (f" (kept {sorted(kept)})" if kept else ""))


def _write_decision(path: str, decision: dict) -> None:
    with open(path, "w") as f:
        json.dump(decision, f, indent=1)
        f.write("\n")


def decide(ab_path: str, decision_path: str, tuning_path: str = TUNING_PATH, allow_compute: bool = False) -> dict:
    """Applies the rules to the A/B at ``ab_path``: updates the tuning file
    at ``tuning_path`` and writes the decision record, which it returns."""
    with open(ab_path) as f:
        ab = json.load(f)
    if ab.get("partial") is not False or ab.get("platform") != "cuda":
        raise ValueError(f"{ab_path} is not a complete A/B measured on a card (partial {ab.get('partial')!r}, "
                         f"platform {ab.get('platform')!r})")
    if ab.get("contention_invalidated"):
        decision = {"rule": "contention_invalidated artifact: adoption refused",
                    "ab_source": os.path.basename(ab_path), "contention_note": ab.get("contention_note"),
                    "baseline": None, "winner": None, "adopted": False}
        _write_decision(decision_path, decision)
        _drop_stale_ab(tuning_path, "A/B artifact is contention-invalidated")
        return decision
    rows = ab.get("rows", [])
    base = next((r for r in rows if r["bn_mode"] == "exact" and r["remat"] == "off" and not r["conv1x1_dot"]), None)
    decision = {
        "rule": f">{(WIN_THRESHOLD - 1) * 100:.0f}% over the exact/no-remat baseline; parity-safe modes "
                f"{PARITY_SAFE_MODES}" + (" + compute" if allow_compute else ""),
        "ab_source": os.path.basename(ab_path), "baseline": base, "winner": None, "adopted": False,
    }
    if base is not None:
        eligible = PARITY_SAFE_MODES + (COMPUTE_MODES if allow_compute else ())
        best, best_speedup = None, WIN_THRESHOLD
        for r in rows:
            if r["bn_mode"] not in eligible:
                continue
            if abs(r["loss"] - base["loss"]) > LOSS_SANITY_ABS:
                log(f"decision: skipping {r['bn_mode']}/{r['remat']}/dot={r['conv1x1_dot']}: loss {r['loss']} vs "
                    f"baseline {base['loss']} fails sanity")
                continue
            speedup = base["ms_per_step"] / r["ms_per_step"]
            if speedup > best_speedup:
                best, best_speedup = r, speedup
        if best is not None:
            decision["winner"] = dict(best, speedup_vs_exact=round(best_speedup, 4))
            decision["adopted"] = True
            tuning = read_tuning(tuning_path)
            for key in ("provisional", "contention_invalidated", "contention_note"):
                tuning.pop(key, None)
            tuning.update({
                "bn_mode": best["bn_mode"],
                "remat": best["remat"] != "off",
                "remat_policy": best["remat"] if best["remat"] == "save_conv" else "full",
                "conv1x1_dot": bool(best["conv1x1_dot"]),
                "source": f"{os.path.basename(ab_path)} ({best_speedup:.3f}x vs exact, {ab.get('device_kind')})",
            })
            if best["bn_mode"] in COMPUTE_MODES:
                decision["provisional"] = tuning["provisional"] = PROVISIONAL
            write_tuning(tuning_path, tuning)
            log(f"decision: ADOPTED {tuning}")
        else:
            _drop_stale_ab(tuning_path, "no variant beat the threshold (negative result recorded)")
    else:
        _drop_stale_ab(tuning_path, "A/B has no baseline row")
    decide_dispatch(rows, decision, tuning_path)
    _write_decision(decision_path, decision)
    return decision


def decide_dispatch(rows: list, decision: dict, tuning_path: str) -> None:
    """``steps_per_dispatch`` from the dispatch probe's row (any row with
    ``dispatch_tax_ms``), whichever variant won; no row, no change."""
    probe = next((r for r in rows if "dispatch_tax_ms" in r), None)
    if probe is None or not probe.get("ms_per_step_chained"):
        decision["dispatch_probe"] = None
        return
    frac = probe["dispatch_tax_ms"] / probe["ms_per_step_chained"]
    decision["dispatch_probe"] = dict(probe, tax_fraction=round(frac, 4))
    tuning = read_tuning(tuning_path)
    if probe["dispatch_tax_ms"] > 0 and frac > DISPATCH_TAX_THRESHOLD:
        tuning["steps_per_dispatch"] = DISPATCH_K
        tuning["steps_per_dispatch_source"] = (f"dispatch probe: {probe['dispatch_tax_ms']:.2f} ms tax = {frac:.1%} "
                                               "of the eager step")
        decision["dispatch_adopted"] = True
        log(f"decision: dispatch tax {frac:.1%} -> steps_per_dispatch={DISPATCH_K}")
    else:
        for key in DISPATCH_KEYS:
            tuning.pop(key, None)
        decision["dispatch_adopted"] = False
        log(f"decision: dispatch tax {frac:.1%} below threshold; single-step dispatch kept")
    write_tuning(tuning_path, tuning)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ab", help="a bn_bench artifact (--out)")
    ap.add_argument("--tuning", default=TUNING_PATH, help="the tuning file to update")
    ap.add_argument("--decision", default="", help="the decision record (default: the tuning file's name with "
                                                   "_decision before .json)")
    ap.add_argument("--allow-compute", action="store_true", help="let the compute family win (provisional)")
    args = ap.parse_args(argv)
    decision_path = args.decision or os.path.splitext(args.tuning)[0] + "_decision.json"
    decision = decide(args.ab, decision_path, args.tuning, args.allow_compute)
    print(json.dumps({"tuning": args.tuning, "decision": decision_path, "adopted": decision["adopted"],
                      "dispatch_adopted": decision.get("dispatch_adopted"), "tuning_file": read_tuning(args.tuning)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

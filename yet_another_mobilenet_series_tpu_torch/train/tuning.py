# Copy of yet_another_mobilenet_series_tpu/train/tuning.py: the port keeps its own copy so that it never imports the
# JAX package. It differs in one place: a non-empty 'flags' (XLA/libtpu flags, meaningless to torch) is refused.
"""Measured-tuning consumption: the measurement→production loop (VERDICT r4
missing #4 / next #2).

`scripts/tpu_watch.py` adopts A/B + sweep winners into `BENCH_TUNING.json`;
until round 5 the ONLY consumer was `bench.py`, so the driver's artifact
measured the winner while real training launches stayed on the YAML
defaults until a human edited them. `train.tuning_file` closes the loop: a
production run pointed at the tuning file picks up the adopted step config
(bn_mode / remat / remat_policy / conv1x1_dot / steps_per_dispatch) and XLA
flags with provenance logged at startup.

Validation is single-sourced here — `bench.py.load_tuning` delegates to
`validate_tuning` — so the bench and the production CLI can never disagree
about what a well-formed tuning file is. Eval accuracy is immune by
construction: `train/steps.py.make_eval_step` pins bn_mode='exact' and the
stock conv lowering regardless of these knobs (ADVICE r3 #3).
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
from typing import Any

# step-config keys a tuning file may carry — the single source (bench.py
# delegates here); 'flags' is env-level and handled separately
TUNING_KEYS = ("bn_mode", "remat", "remat_policy", "conv1x1_dot", "steps_per_dispatch")
# metadata keys the watcher's adoption step writes alongside the config
# (scripts/tpu_watch.py _AB_KEYS/_DISPATCH_KEYS/_FLAG_KEYS); 'provisional'
# marks a compute-family win whose parity evidence is synthetic-fixture only;
# 'contention_invalidated'/'contention_note' mark an adoption whose measured
# justification was skewed by host contention (ADVICE r5) — kept so the run
# that consumes the tuning sees the warning, not just the decision artifact
METADATA_KEYS = ("source", "steps_per_dispatch_source", "flags", "flags_source",
                 "provisional", "contention_invalidated", "contention_note")


def validate_tuning(raw: dict) -> dict[str, Any]:
    """Validated step-config subset of a BENCH_TUNING.json dict, or {} when
    no tuning keys are present (a flags-only file is the step-config
    baseline, not a winner). Raises ValueError on any malformed value —
    callers decide whether that is fatal (production CLI: yes, the user
    asked for this file) or a logged fallback (bench: never take the
    headline down over an aux artifact)."""
    from ..ops.layers import BN_MODES

    tuning = {k: raw[k] for k in TUNING_KEYS if k in raw}
    if not tuning:
        return {}
    if tuning.get("bn_mode", "exact") not in BN_MODES:
        raise ValueError(f"bn_mode must be one of {BN_MODES}")
    if tuning.get("remat_policy", "full") not in ("full", "save_conv"):
        raise ValueError("remat_policy must be 'full' or 'save_conv'")
    if not isinstance(tuning.get("remat", False), bool):
        raise ValueError("remat must be a bool")
    if not isinstance(tuning.get("conv1x1_dot", False), bool):
        raise ValueError("conv1x1_dot must be a bool")
    k = tuning.get("steps_per_dispatch", 1)
    if isinstance(k, bool) or not isinstance(k, int) or not 1 <= k <= 16:
        # bool is an int subclass: {"steps_per_dispatch": true} would
        # otherwise silently mean single-step dispatch
        raise ValueError("steps_per_dispatch must be an int in [1, 16]")
    return tuning


def apply_tuning_file(cfg):
    """Returns (cfg', provenance_lines) with cfg.train's step-config knobs
    overridden by cfg.train.tuning_file's validated contents.

    Must run BEFORE the first backend touch: a 'flags' entry is applied to
    this process's XLA_FLAGS / LIBTPU_INIT_ARGS (appended, never
    overwritten), which the backend reads exactly once at init. The tuning
    file wins over YAML/CLI values for the keys it carries — it is an
    explicit opt-in whose whole point is that measured winners reach runs
    without hand-editing YAML; the provenance lines make the effective
    config auditable from the log."""
    path = cfg.train.tuning_file
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"tuning file {path} must hold a JSON object")
    # strict here (unlike bench, where tuning is an aux artifact with a
    # fallback): a typoed key ('steps_per_dispach') would silently drop a
    # measured winner from the very run the user pointed at this file
    unknown = sorted(set(raw) - set(TUNING_KEYS) - set(METADATA_KEYS))
    if unknown:
        raise ValueError(f"tuning file {path} has unknown keys {unknown}; "
                         f"valid: {TUNING_KEYS + METADATA_KEYS}")
    tuning = validate_tuning(raw)
    lines = []
    if tuning:
        src = raw.get("source", "unrecorded")
        lines.append(f"tuning: {path} -> {tuning} (source: {src})")
        if raw.get("provisional"):
            # a compute-family adoption whose parity evidence is synthetic:
            # the warning must reach the operator of the run that consumes
            # the tuning, not just the decision artifact nobody re-reads
            lines.append(f"tuning: WARNING — PROVISIONAL adoption: {raw['provisional']}")
        if raw.get("contention_invalidated"):
            lines.append(
                "tuning: WARNING — CONTENTION-INVALIDATED adoption: "
                f"{raw.get('contention_note', 'measured justification was contention-skewed')}"
            )
        cfg = dc.replace(cfg, train=dc.replace(cfg.train, **tuning))
    flags = raw.get("flags", "")
    if not isinstance(flags, str):
        raise ValueError(f"flags must be a string, got {flags!r}")
    if flags:
        # XLA/libtpu flags set nothing in torch: refused, never dropped in silence
        raise ValueError(f"tuning file {path}: 'flags' {flags!r} are XLA/libtpu flags, which have no torch "
                         "counterpart (ROADMAP queue 1, item 12: the XLA flag sweep is not ported)")
    if not lines:
        lines.append(f"tuning: {path} carries no tuning keys; running the baseline config")
    return cfg, lines


def partition_flags(flags_str: str) -> tuple[str, str]:
    """Split a flag string into (XLA_FLAGS, LIBTPU_INIT_ARGS) halves.

    '--xla_tpu_*' flags are libtpu options: in host XLA_FLAGS they are a
    fatal 'Unknown flag' abort at backend init (measured 2026-07-30,
    PROFILE.md round 4); on PJRT TPUs libtpu consumes them from
    LIBTPU_INIT_ARGS. The full '--xla_' prefix is required so near-miss
    typos ('--xlatpu_...') fail validation instead of reaching the backend
    (ADVICE r4 #2). bench.py keeps a jax-free DUPLICATE for its supervisor
    side (importing this module pulls jax via train/__init__); the two are
    pinned identical by tests/test_tuning.py::test_partition_flags_copies_agree."""
    xla, libtpu = [], []
    for tok in flags_str.split():
        if not tok.startswith("--xla_"):
            raise ValueError(f"flag token {tok!r} does not start with --xla_")
        (libtpu if tok.startswith("--xla_tpu_") else xla).append(tok)
    return " ".join(xla), " ".join(libtpu)

"""The numbers that decide ``correct``, each a gap between what the program produced and what the
plain reference works out from the same inputs.

Training (three steps from the same drawn state, batches and step seed):

- ``loss``: the largest of the three steps' |loss - reference| / |reference|;
- ``grad``: the first step's gradient as the optimizer gets it (weight decay added), by the
  worst leaf: |norm - reference norm| / max(reference norm of the leaf, median leaf's);
- ``change``: the weights' change over the three steps, by the worst leaf, the same way; leaves
  whose reference gradient is under a thousandth of the median leaf's are left out (they move by
  round-off alone);
- ``grad_median``, ``change_median``: the median over the leaves of the same per-leaf gaps. In
  bfloat16 the worst leaf is an early BN gamma or beta, or an SE reduce weight, and reads a tenth
  or more on every seed: the reference itself computed in bfloat16 reads the same on the same
  kinds of leaf. The median leaf is steady from seed to seed and is what a lower precision moves;
- ``change_p95``: the 95th percentile (nearest rank) of the change's per-leaf gaps. It is steady
  from seed to seed too, and a fault on a twentieth of the leaves or more, a layer type left
  unmoved or moved twice, puts it at or near 1 (a leaf at least the median's reads exactly 1);
- ``bn_stats``: the BN running statistics' change over the three steps, by the worst leaf;
- ``ema``: the weights' EMA shadow, its change over the three steps, by the worst leaf. The
  shadow starts apart from the weights (``inputs.ema_weights``), so each step moves it by
  ``(1 - a) (w - shadow)``, far above its float32 rounding;
- ``ema_stats``: the EMA shadow of the running statistics, its change over the three steps, by
  the worst leaf.

Serving: ``logits``, the worst served row's largest |logit - reference| over the reference row's
root mean square.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's is left out of the
# change: it moves by round-off alone
STILL_SHARE = 1e-3
P95 = 0.95


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def change_norms(after: dict, before: dict) -> dict[str, float]:
    return {k: norm(after[k].to(before[k].device).double() - before[k].double()) for k in before}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep=None) -> dict[str, float]:
    """Per leaf: |norm - reference norm| / max(reference norm, the median leaf's)."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in names}


def worst_leaf(prog: dict[str, float], ref: dict[str, float], keep=None) -> tuple[float, str]:
    gaps = leaf_gaps(prog, ref, keep)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moving_leaves(ref_grad_norms: dict[str, float]) -> set[str]:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= STILL_SHARE * med}


def train_numbers(prog: dict, ref: dict) -> dict[str, dict]:
    """``prog`` and ``ref`` each hold ``losses`` (per step), ``grad`` (leaf -> first gradient's
    norm), ``change``, ``bn_stats``, ``ema`` and ``ema_stats`` (leaf -> norm of the change over
    the steps). Returns name -> {"value", "leaf"}."""
    moving = moving_leaves(ref["grad"])
    out = {"loss": {"value": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
                    "leaf": "steps 1-%d" % len(ref["losses"])}}
    for name, keep in (("grad", None), ("change", moving), ("bn_stats", None), ("ema", None), ("ema_stats", None)):
        value, leaf = worst_leaf(prog[name], ref[name], keep)
        out[name] = {"value": value, "leaf": leaf}
    for name, keep in (("grad", None), ("change", moving)):
        gaps = leaf_gaps(prog[name], ref[name], keep)
        out[f"{name}_median"] = {"value": statistics.median(gaps.values()), "leaf": f"median of {len(gaps)} leaves"}
    gaps = sorted(leaf_gaps(prog["change"], ref["change"], moving).values())
    rank = math.ceil(P95 * len(gaps))
    out["change_p95"] = {"value": gaps[rank - 1], "leaf": f"leaf {rank} of {len(gaps)} by gap"}
    return out


def logit_gap(prog: np.ndarray, ref: np.ndarray) -> tuple[float, int]:
    """(worst row's max |prog - ref| / rms(ref row), that row)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    rows = np.abs(prog - ref).max(axis=1) / np.sqrt(np.mean(ref * ref, axis=1)).clip(1e-300)
    i = int(np.argmax(rows))
    return float(rows[i]), i

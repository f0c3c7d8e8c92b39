#!/usr/bin/env python3
"""How XLA:CPU computes ``lax.rsqrt`` in float32, and whether plain float32
torch ops can reproduce it bit for bit (the BN fold of the two packages,
``ops/layers.py`` ``bn_scale_shift``; ROADMAP queue 3, F6).

    JAX_PLATFORMS=cpu python3 scripts/rsqrt_fold_probe.py [--n 1000000]

Inputs are ``--n`` float32 values, log-uniform over [1e-5, 1e3] (BN's
var + eps), from a seed. It counts the inputs at which XLA's result differs
from, and the largest difference in ulps to:

- the correctly rounded 1/sqrt(x), ``torch.rsqrt`` and ``1 / torch.sqrt``;
- two Newton steps ``y + (-0.5 y) (x y y - 1)``, each with its two fused
  multiply-adds (what XLA:CPU's LLVM code for rsqrt runs, seen in its
  ``--xla_dump_to`` IR), from several estimates that need no particular
  hardware: the correctly rounded value, ``1 / sqrt`` in float32, the
  correctly rounded value cut to 12 bits, and the 0x5f3759df bit trick
  with 3 and 4 steps;
- the same two steps from this CPU's own ``rsqrtps`` estimate, when a C
  compiler is there to build the one-line helper (into a temporary dir).

One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np

_EST_C = r"""
#include <immintrin.h>
void rsqrt_est(const float* x, float* y, long n) {
  long i = 0;
  for (; i + 8 <= n; i += 8) _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
  for (; i < n; i++) y[i] = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x[i])));
}
"""


def ulp_diff(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    return {"differ": int((d > 0).sum()), "max_ulp": int(d.max())}


def fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (the product of two float32 is
    exact in float64, and so is the sum to 53 bits)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def newton(y: np.ndarray, x: np.ndarray, steps: int) -> np.ndarray:
    y = y.astype(np.float32)
    minus_one = np.full_like(y, -1.0)
    for _ in range(steps):
        y = fma(y * np.float32(-0.5), fma(x * y, y, minus_one), y)
    return y


def hardware_estimate(x: np.ndarray) -> np.ndarray | None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "est.c"), os.path.join(tmp, "libest.so")
        with open(src, "w") as f:
            f.write(_EST_C)
        if subprocess.run([cc, "-O2", "-mavx", "-shared", "-fPIC", src, "-o", lib]).returncode != 0:
            return None
        fn = ctypes.CDLL(lib).rsqrt_est
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        fn.restype = None
        x = np.ascontiguousarray(x, dtype=np.float32)
        y = np.empty_like(x)
        fn(x.ctypes.data, y.ctypes.data, x.size)
    return y


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import jax
    import torch
    from jax import lax

    jax.config.update("jax_platforms", "cpu")
    x = np.exp(np.random.RandomState(args.seed).uniform(np.log(1e-5), np.log(1e3), args.n)).astype(np.float32)
    xla = np.asarray(jax.jit(lax.rsqrt)(x))
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    t = torch.from_numpy(x)
    magic = (np.int32(0x5F3759DF) - (x.view(np.int32) >> 1)).view(np.float32)
    cut12 = (exact.view(np.int32) & ~np.int32((1 << 11) - 1)).view(np.float32)
    inv_sqrt = (np.float32(1.0) / np.sqrt(x)).astype(np.float32)
    out = {
        "n": args.n, "jax": jax.__version__, "torch": torch.__version__,
        "xla_vs": {
            "correctly_rounded": ulp_diff(xla, exact),
            "torch.rsqrt": ulp_diff(xla, torch.rsqrt(t).numpy()),
            "1/torch.sqrt": ulp_diff(xla, (1.0 / torch.sqrt(t)).numpy()),
            "2 fma-newton steps from the correctly rounded value": ulp_diff(xla, newton(exact, x, 2)),
            "2 fma-newton steps from 1/sqrt in float32": ulp_diff(xla, newton(inv_sqrt, x, 2)),
            "2 fma-newton steps from the correctly rounded value cut to 12 bits": ulp_diff(xla, newton(cut12, x, 2)),
            "3 fma-newton steps from 0x5f3759df": ulp_diff(xla, newton(magic, x, 3)),
            "4 fma-newton steps from 0x5f3759df": ulp_diff(xla, newton(magic, x, 4)),
        },
    }
    est = hardware_estimate(x)
    if est is not None:
        out["xla_vs"]["2 fma-newton steps from this CPU's rsqrtps"] = ulp_diff(xla, newton(est, x, 2))
        out["rsqrtps_vs_correctly_rounded"] = ulp_diff(est, exact)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Split the time of the port's fused depthwise kernel into its parts on
the card.

    python3 scripts/split_fused_depthwise.py

It builds variants of ``csrc/fused_depthwise.cu`` from the source by exact
text substitutions (each must match once), with ``ops/cuda_build.py``'s
nvcc flags, into ``build/torch_kernels/split/``, one nvcc each, all at once:

- ``full``: the source as it is (checked against the plain version);
- ``no_l2_hint``: the 16-byte copies without the ``.L2::128B`` prefetch hint
  (checked too: the hint changes no result);
- ``no_compute``: no accumulation (each output is act(shift) * mask);
- ``no_staging``: no copy of the input tile (the compute reads whatever
  shared memory holds);
- ``stores_only``: neither the copy nor the accumulation: the launch, the
  taps, scale, shift and mask, and the stores.

It times each through the wrapper, swapping the library it launches, at
the 15 depthwise stages of MobileNetV3-Large 1.0 at 224 and batch 32, in
float32 and bfloat16, cold (L2 flushed) and warm on the device, with
chip_smoke.py's timers, in two passes (the variants in order, then
reversed). It prints the card line and the stage sums per variant and pass,
and writes every row to ``chiprun_out/split_fused_depthwise.json``. It
needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# variant -> substitutions (old, new) of the kernel source
VARIANTS = {
    "full": [],
    "no_l2_hint": [("cp.async.cg.shared.global.L2::128B", "cp.async.cg.shared.global")],
    "no_compute": [("accumulate<VEC, K, S, R>(acc,", "if (false) accumulate<VEC, K, S, R>(acc,")],
    "no_staging": [("while (row < p.ih) {", "while (row < 0 * p.ih) {")],
    "stores_only": [("accumulate<VEC, K, S, R>(acc,", "if (false) accumulate<VEC, K, S, R>(acc,"),
                    ("while (row < p.ih) {", "while (row < 0 * p.ih) {")],
}
CHECKED = ("full", "no_l2_hint")


def build_variant(name: str, source: str) -> str:
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs {source.count(old)} times in the kernel source")
        source = source.replace(old, new)
    out_dir = os.path.join(cuda_build.BUILD_ROOT, "split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(source)
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src], capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building variant {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    import torch

    import chip_smoke
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build
    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "fused_depthwise.cu")) as f:
        source = f.read()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(lambda name: build_variant(name, source), VARIANTS)))
    libs = {name: fdw.bind(ctypes.CDLL(path)) for name, path in paths.items()}

    gen = torch.Generator(device=device).manual_seed(6)
    _, shapes = chip_smoke.mbv3_depthwise_shapes(32)
    operands = {dtype: [(chip_smoke.kernel_operands(n, h, c, k, dtype, gen, device), s, act)
                        for (n, h, c, k, s, act) in shapes] for dtype in (torch.float32, torch.bfloat16)}
    flush = torch.empty(chip_smoke.FLUSH_BYTES // 4, device=device)
    rows, bad = [], []
    order = list(VARIANTS)
    with torch.inference_mode():
        for name in CHECKED:
            fdw._lib = lambda lib=libs[name]: lib
            for dtype, cases in operands.items():
                tol = (chip_smoke.F32_TOL,) * 2 if dtype == torch.float32 else (chip_smoke.BF16_ATOL,
                                                                                 chip_smoke.BF16_RTOL)
                for ops, s, act in cases:
                    err, ok = chip_smoke.compare(fdw.fused_depthwise(*ops, s, act),
                                                 fdw.fused_depthwise_reference(*ops, s, act), *tol)
                    if not ok:
                        bad.append((name, str(dtype), tuple(ops[0].shape), s, act, err))
        for pass_no, names in enumerate((order, order[::-1])):
            for name in names:
                fdw._lib = lambda lib=libs[name]: lib
                for dtype, cases in operands.items():
                    cold = device_ms = 0.0
                    for ops, s, act in cases:
                        def run(ops=ops, s=s, act=act):
                            fdw.fused_depthwise(*ops, s, act)

                        row = {"variant": name, "pass": pass_no, "dtype": str(dtype), "shape": tuple(ops[0].shape),
                               "stride": s, "cold_ms": chip_smoke.cold_time_ms(run, flush),
                               "device_ms": chip_smoke.device_time_ms(run, iters=20)}
                        rows.append(row)
                        cold += row["cold_ms"]
                        device_ms += row["device_ms"]
                    print(f"pass {pass_no} {name:12s} {str(dtype)[6:]:8s}: 15 stages {cold:.4f} ms cold / "
                          f"{device_ms:.4f} ms device", flush=True)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "split_fused_depthwise.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "disagreements": bad}, f, indent=1)
    if bad:
        print(f"{len(bad)} launches disagree with the plain version: {bad[:5]}", flush=True)
        return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

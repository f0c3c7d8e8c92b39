#!/usr/bin/env python3
"""Time tilings of the port's fused depthwise kernel on the card, at the 15
depthwise stages of MobileNetV3-Large 1.0 at 224.

    python3 scripts/tune_fused_depthwise.py [--batch 32] [--count 12]

For each stage and type (float32, bfloat16) it takes the tiling that
``ops/fused_depthwise.py`` ``plan()`` picks, the ``count`` tilings of least
modelled cost and ``count`` more spread over the rest of ``tilings()``
(blocks within ``SMEM_DEFAULT``). It checks each launch against the plain
version (chip_smoke.py's bars) and times each cold (L2 flushed) and warm on the device
with chip_smoke.py's timers. It prints per stage the plan's cold time and
the best measured tiling, and writes every row to
``chiprun_out/tune_fused_depthwise_b<batch>.json``. It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def candidates(n, h, c, k, s, itemsize, count):
    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    chosen = fdw.plan(n, h, h, c, k, s, itemsize, True)
    pool = [p for _, p in sorted(((cost, p) for cost, p in fdw.tilings(n, h, h, c, k, s, itemsize, True)
                                  if p.smem <= fdw.SMEM_DEFAULT and p != chosen), key=lambda cp: cp[0])]
    rest = pool[count:]
    spread = rest[:: max(1, len(rest) // count)][:count] if rest else []
    return [chosen] + pool[:count] + spread


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--count", type=int, default=12)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    gen = torch.Generator(device=device).manual_seed(5)
    _, shapes = chip_smoke.mbv3_depthwise_shapes(args.batch)
    flush = torch.empty(chip_smoke.FLUSH_BYTES // 4, device=device)
    rows, bad = [], []
    plan_total = {torch.float32: 0.0, torch.bfloat16: 0.0}
    best_total = {torch.float32: 0.0, torch.bfloat16: 0.0}
    seen = set()
    with torch.inference_mode():
        for (n, h, c, k, s, act) in shapes:
            if (n, h, c, k, s) in seen:
                continue
            seen.add((n, h, c, k, s))
            for dtype in (torch.float32, torch.bfloat16):
                ops = chip_smoke.kernel_operands(n, h, c, k, dtype, gen, device)
                ref = fdw.fused_depthwise_reference(*ops, s, act)
                tol = (chip_smoke.F32_TOL, chip_smoke.F32_TOL) if dtype == torch.float32 else \
                    (chip_smoke.BF16_ATOL, chip_smoke.BF16_RTOL)
                timed = []
                for i, tile in enumerate(candidates(n, h, c, k, s, ops[0].element_size(), args.count)):
                    y = fdw._launch(*ops, s, act, tile=tile)
                    torch.cuda.synchronize()
                    err, ok = chip_smoke.compare(y, ref, *tol)
                    if not ok:
                        bad.append((n, h, c, k, s, str(dtype), str(tile), err))

                    def run(tile=tile):
                        fdw._launch(*ops, s, act, tile=tile)

                    row = {"n": n, "h": h, "c": c, "k": k, "stride": s, "dtype": str(dtype), "planned": i == 0,
                           "tile": dataclasses.asdict(tile), "max_abs_err": err, "cold_ms": chip_smoke.cold_time_ms(run, flush),
                           "device_ms": chip_smoke.device_time_ms(run, iters=20)}
                    rows.append(row)
                    timed.append(row)
                best = min(timed, key=lambda r: r["cold_ms"])
                plan_total[dtype] += timed[0]["cold_ms"]
                best_total[dtype] += best["cold_ms"]
                t0, tb = timed[0]["tile"], best["tile"]
                print(f"n={n} h={h:3d} c={c:3d} k={k} s={s} {str(dtype)[6:]:8s}: plan "
                      f"{t0['th']}x{t0['tw']}x{t0['cb']} {timed[0]['cold_ms']:.4f} cold / {timed[0]['device_ms']:.4f} device ms;"
                      f" best of {len(timed)} {tb['th']}x{tb['tw']}x{tb['cb']} t{tb['threads']} "
                      f"{best['cold_ms']:.4f} / {best['device_ms']:.4f} ms", flush=True)
    for dtype in plan_total:
        print(f"{dtype}: unique stages summed, plan {plan_total[dtype]:.4f} ms cold, best measured "
              f"{best_total[dtype]:.4f} ms cold", flush=True)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"tune_fused_depthwise_b{args.batch}.json"), "w") as f:
        json.dump({"card": card, "rows": rows, "disagreements": bad}, f, indent=1)
    if bad:
        print(f"{len(bad)} tilings disagree with the plain version: {bad[:5]}", flush=True)
        return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

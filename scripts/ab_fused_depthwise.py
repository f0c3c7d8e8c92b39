#!/usr/bin/env python3
"""Time the fused depthwise kernel of two checkouts of the PyTorch port in
turns on one card.

    python3 scripts/ab_fused_depthwise.py BASE_ROOT NEW_ROOT

Each root is a directory that holds ``yet_another_mobilenet_series_tpu_torch/``:
for example the parent commit unpacked with ``git archive`` into a
gitignored ``build/`` directory, and ``.``. The script runs chip_smoke.py's
phase-3 timing (``time_stages``: the 15 depthwise stages of
MobileNetV3-Large 1.0 at 224 and batch 32, warm back to back, warm on the
device alone and cold, float32 and bfloat16, beside ``F.conv2d(groups=C,
bias)`` and the plain version, then the host microseconds per call of the
wrapper and of ``F.conv2d``) four times, each in a fresh
process that builds its root's kernel from source: base, new, new, base.
It prints the card line, one summary line per run, and writes every row to
``chiprun_out/ab_fused_depthwise.json``. It needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root: str) -> dict:
    """chip_smoke.py's time_stages against the port under ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import yet_another_mobilenet_series_tpu_torch as port
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported the port from {port.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build("fused_depthwise")
    timed = smoke.time_stages(torch.device("cuda", 0), smoke.card_rates(torch.cuda.get_device_name(0)))
    return {"root": root, "totals": timed["totals"], "rows": timed["rows"]}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    base, new = sys.argv[1:]
    runs = []
    for label, root in (("base", base), ("new", new), ("new", new), ("base", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", root], capture_output=True,
                              text=True, timeout=900, check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {label} run ({root}) failed with {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["label"] = label
        runs.append(result)
        t = result["totals"]
        print(f"{label:4s} {root}: f32 kernel {t['ms']:.4f} back to back / {t['device_ms']:.4f} device / "
              f"{t['cold_ms']:.4f} cold ms, conv2d {t['library_ms']:.4f} / {t['library_device_ms']:.4f} / "
              f"{t['library_cold_ms']:.4f}, bound {t['bound_ms']:.4f} ({100 * t['share']:.1f}% cold); bf16 kernel "
              f"{t['bf16_ms']:.4f} / {t['bf16_device_ms']:.4f} / {t['bf16_cold_ms']:.4f}, conv2d "
              f"{t['bf16_library_ms']:.4f} / {t['bf16_library_device_ms']:.4f} / {t['bf16_library_cold_ms']:.4f}, "
              f"bound {t['bf16_bound_ms']:.4f} ({100 * t['bf16_share']:.1f}% cold); host {t['host_us_per_launch']:.2f} "
              f"us per launch, F.conv2d {t['library_host_us_per_call']:.2f} us per call", flush=True)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_fused_depthwise.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

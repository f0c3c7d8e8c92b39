"""The readings that the limits of ``correct`` are set from, for one cell, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--seconds 3] [--witness] [--out calibrate.jsonl]

For each seed it runs the cell as a run does (set-up, a window of ``--seconds``, the program's
state freed) and prints the numbers the check compares: the program's sound readings, whose
largest over a dozen seeds or more is a limit's lower reading. On each control seed it also
prints the control's numbers (the reference put in the program's place, in the precision below
the configuration's: ``reference/lowp.py``), whose smallest is the upper reading, and those of
the faults a cell can have, planted in that reference (``Runner.faults``). With ``--witness`` a
training cell also reads the reference in bfloat16 against itself in float32 (``Runner.witness``). It runs on the card
alone, as a run does; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .frozen.trace import Spans
from .run import Tracer, load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds that also read the control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--compute-dtype", default="", help="run the program's step in this dtype instead of the "
                    "configuration's (a witness: float32 shows which gaps bfloat16's rounding makes)")
    ap.add_argument("--witness", action="store_true", help="also read the reference in bfloat16 against itself "
                    "in float32 (training cells), and print every leaf's norms on each side")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import importlib

    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = load_cell(args.workload)
    if args.compute_dtype:
        cell.config["train"]["compute_dtype"] = args.compute_dtype
    kind = importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            runner = kind.Runner(cell, seed, device, Spans(False))
            runner.setup()
            window = runner.window(args.seconds, Tracer(False, device, None))
            runner.release()
            line = {"workload": cell.name, "seed": seed, "compute_dtype": cell.config.get("train", {}).get("compute_dtype"),
                    "program": runner.check(),
                    "window": {k: v for k, v in window.items() if not isinstance(v, dict)}}
            if seed in controls:
                line["control"] = runner.control()
                line["faults"] = runner.faults()
            if args.witness and hasattr(runner, "witness"):
                line["witness_bf16"], line["leaves"] = runner.witness()
            line["seconds"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if out is not None:
                out.write(text + "\n")
                out.flush()
            del runner
            torch.cuda.empty_cache()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

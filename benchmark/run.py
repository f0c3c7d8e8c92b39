"""Run one cell of the benchmark once, on this machine's card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell needs is found by name from ``BENCHMARK.json``:
the configuration's file, the traffic mix ``benchmark/traffic/<traffic>.json`` (whose ``kind``
names the runner module ``benchmark/traffic/<kind>.py``), the cell's own file
``benchmark/workloads/<cell>.json`` (its limits of ``correct``), and each per-layer metric's
reader ``benchmark/metrics/<metric>.py``. A later cell, configuration or metric is added by
adding files and entries, not by editing these.

A run: set-up (the runner builds the program from the seed's inputs and warms every shape its
traffic uses; ``setup_s`` runs from the start of this process to the end of it), the window
(``--seconds``, or with ``--trace 1`` the mix's traced window under ``torch.profiler``), then,
with the program's state freed, the plain reference's check. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit; the same numbers are
the last lines of standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402 — the set-up clock starts before every import
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that may not be loaded in the process that prints a result, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "yet_another_mobilenet_series_tpu")


@dataclass
class Cell:
    name: str
    entry: dict  # the workload's entry in BENCHMARK.json
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    spec: dict  # benchmark/workloads/<cell>.json
    manifest: dict
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return Cell(name, entry, json.loads((root / conf["file"]).read_text()),
                json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text()),
                json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text()), manifest, root)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_names(cell: Cell) -> list[str]:
    return [m["name"] for m in cell.manifest["end_to_end"] if applies(m, cell.name)]


def per_layer(cell: Cell) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those without a list
    whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(cell))
    return [m for m in cell.manifest["per_layer"]
            if cell.name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]


def load_reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (``build/`` is ignored by
    git). The program's own CUDA build lands in ``build/torch_kernels`` already."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


class Tracer:
    """The window's boundary: ``start`` and ``stop`` around the work. Off, ``stop`` only
    synchronizes the card (the window ends in a synchronize). On, the window runs under
    ``torch.profiler`` recording the device alone (recording every host op as well would slow the
    host by a sixth and read as idle device); the window's span is taken on the host's wall
    clock, the clock of the profiler's timestamps."""

    def __init__(self, on: bool, device, spans):
        self.on, self.device, self.spans = on, device, spans

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU])

    def warm(self):
        """One short profiler session in set-up: the first in a process loads and starts the
        tracing library, and can lose records, so the window's is the second."""
        if not self.on:
            return
        import torch

        with self._profile():
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        if not self.on:
            return
        self._prof = self._profile()
        self._prof.__enter__()
        self.host = [time.time_ns(), None]

    def stop(self):
        self._sync()
        if not self.on:
            return
        self.host[1] = time.time_ns()
        self._prof.__exit__(None, None, None)

    def digest(self):
        from .frozen import trace

        return trace.digest(trace.profiler_events(self._prof), self.spans, tuple(self.host))


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the traced window's digest, the window's counts,
    the runner's counters, the card."""

    digest: object
    window: dict
    counters: dict
    card: str


def check_lines(numbers: dict[str, dict], limits: dict) -> dict[str, dict]:
    """The numbers the cell's file gives a limit, each against it. A number the runner reads and
    the cell does not compare is printed as a reading only."""
    out = {}
    for name, limit in limits.items():
        n = numbers.get(name, {"value": math.inf, "leaf": "not read"})
        ok = limit is not None and math.isfinite(n["value"]) and n["value"] <= limit
        out[name] = {"value": n["value"], "limit": limit, "ok": ok, "at": n.get("leaf")}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
        device=None) -> tuple[int, dict | None]:
    """One run. ``device`` None looks for the card and refuses without one; the benchmark's own
    tests pass a CPU device. Returns (exit code, the result or None)."""
    cell = load_cell(workload, root)
    cache_dirs(root)
    import torch

    from .frozen.trace import Spans

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {workload} needs {cell.chips} CUDA card(s); this machine has {have}", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    kind = importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")
    spans = Spans(on=trace)
    runner = kind.Runner(cell, seed, device, spans)
    runner.setup()
    tracer = Tracer(trace, device, spans)
    tracer.warm()
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    limit_w = power_limit() if device.type == "cuda" else None
    setup_s = time.perf_counter() - PROCESS_START
    window = runner.window(seconds, tracer)
    counters = runner.layer_counters()
    digest = tracer.digest() if trace else None
    peak = runner.release()
    numbers = runner.check()
    checks = check_lines(numbers, cell.spec.get("limits", {}))
    if trace and "k1_launches" in window:
        checks["k1_records"] = {"value": float(abs(digest.k1_records - window["k1_launches"])), "limit": 0.0,
                                "ok": digest.k1_records == window["k1_launches"],
                                "at": f"{digest.k1_records} fused_dw_kernel records, {window['k1_launches']} launches "
                                      "on the kernel's own counter"}
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    metrics = {}
    if trace:
        reading = Reading(digest, window, counters, card)
        for m in per_layer(cell):
            value = load_reader(root, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(window, setup_s=setup_s)
        for name in end_to_end_names(cell):
            if name in values:
                metrics[name] = {"value": values[name], "unit": units[name]}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
                         "count": cell.chips, "memory_peak_bytes": peak, "power_limit": limit_w,
                         "precision": counters.get("precision"), "seed": seed}}
    if trace:
        result["device"].update(busy_s=digest.busy_us / 1e6, window_s=digest.window_us / 1e6)
        result["breakdown"] = digest.breakdown()
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for name, n in numbers.items():
        if name not in checks:
            print(f"reading {name}: {n['value']!r} (not compared; {n.get('leaf')})", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} against limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'}; {c['at']})", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3, None
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

"""Training chaos round: corrupt records, an injected NaN step and a SIGTERM
preemption, then a resume; the torch twin of ``scripts/train_chaos.py``
over the port's ``cli.train``.

Two rounds, each a subprocess of ``python -m
yet_another_mobilenet_series_tpu_torch.cli.train`` on the source's tiny
fake-data config (one device: the card unless ``--device cpu``):

1. **chaos round**: ``train.faults`` injects a seeded corrupt-record rate
   (the skip must count them), one NaN step (the guard must roll it back
   and count it), and ``kill_at_step`` sends the process a real SIGTERM
   mid-epoch. The process must exit 0 after a synchronous checkpoint,
   leaving ``preempt_marker.json`` and its counters in ``obs_registry.json``.
2. **resume round**: the same config with the faults off resumes
   (``train.resume``, on by default) from the marker's step, not from
   zero, and trains to the end.

It prints exactly one JSON line in the source's shape: ``value`` is the
count of steps the resumed run took past the resume point; ``chaos`` and
``resume`` hold each round's counters, the killed and resumed steps and the
losses on both sides of the kill. It always exits 0: a failed round gives
``value: null`` and an ``error``, never a stack trace. The line is stamped
with the card (``card_provenance``) and copied to ``--out``.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.train_chaos
           [--device cpu] [--out f.json] [--log-dir D] [--timeout-s 240]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile

from ..utils.benchkit import card_provenance

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KILL_AT_STEP = 10
NAN_AT_STEP = 5


def _base_overrides(log_dir: str) -> list[str]:
    return [
        "data.dataset=fake", "data.image_size=16", "data.fake_train_size=256",
        "data.fake_eval_size=32", "data.fake_num_classes=4",
        "model.arch=mobilenet_v2", "model.num_classes=4", "model.dropout=0.0",
        "model.block_specs=[{t: 2, c: 8, n: 1, s: 2}]",
        "optim.optimizer=sgd", "optim.momentum=0.9", "optim.weight_decay=0.0",
        "schedule.schedule=constant", "schedule.base_lr=0.05",
        "schedule.scale_by_batch=false", "schedule.warmup_epochs=0.0",
        "ema.enable=false",
        "train.batch_size=16", "train.eval_batch_size=16", "train.epochs=2",
        "train.log_every=2", "train.compute_dtype=float32",
        "train.eval_every_epochs=0", "train.checkpoint_every_epochs=1",
        f"train.log_dir={log_dir}",
        "train.guard.enable=true", "train.guard.max_skipped_steps=4",
        "dist.num_devices=1",
    ]


def _run_child(overrides: list[str], device: str, timeout_s: float) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.train", *overrides, "--device", device]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=REPO)


def _losses(log_dir: str) -> list[tuple[int, float]]:
    out = []
    try:
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            for line in f:
                row = json.loads(line)
                if "train/loss" in row:
                    out.append((int(row["step"]), float(row["train/loss"])))
    except (OSError, ValueError):
        pass
    return out


def _registry(log_dir: str) -> dict:
    try:
        with open(os.path.join(log_dir, "obs_registry.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def run_chaos(log_dir: str, device: str, timeout_s: float) -> dict:
    # 256 / 16 = 16 steps an epoch: the kill lands mid-epoch 1 (the injector
    # counts pulls, which lead the step loop by the prefetch depth)
    proc = _run_child(_base_overrides(log_dir) + [
        "train.faults.enable=true", "train.faults.seed=7", "train.faults.corrupt_record_rate=0.08",
        f"train.faults.nan_at_steps=[{NAN_AT_STEP}]", f"train.faults.kill_at_step={KILL_AT_STEP}",
    ], device, timeout_s)
    if proc.returncode != 0:
        raise RuntimeError(f"chaos round exited {proc.returncode}: {proc.stderr[-800:]}")
    marker_path = os.path.join(log_dir, "preempt_marker.json")
    if not os.path.exists(marker_path):
        raise RuntimeError(f"chaos round left no preempt_marker.json (stdout tail: {proc.stdout[-400:]})")
    with open(marker_path) as f:
        marker = json.load(f)
    reg = _registry(log_dir)
    losses = _losses(log_dir)
    return {
        "exit_code": proc.returncode,
        "killed_step": int(marker["step"]),
        "reason": marker.get("reason"),
        "corrupt_records": reg.get("data.corrupt_records", 0),
        "injected_corrupt": reg.get("train.faults.corrupt_records", 0),
        "injected_nan_steps": reg.get("train.faults.nan_steps", 0),
        "skipped_steps": reg.get("train.skipped_steps", 0),
        "nonfinite_events": reg.get("train.nonfinite_events", 0),
        "preemptions": reg.get("train.preemptions", 0),
        "loss_before_kill": losses[-1][1] if losses else None,
        "health_abort": os.path.exists(os.path.join(log_dir, "train_health.json")),
    }


def run_resume(log_dir: str, killed_step: int, device: str, timeout_s: float) -> dict:
    proc = _run_child(_base_overrides(log_dir), device, timeout_s)
    if proc.returncode != 0:
        raise RuntimeError(f"resume round exited {proc.returncode}: {proc.stderr[-800:]}")
    m = re.search(r"resumed at step (\d+)", proc.stdout)
    if not m:
        raise RuntimeError(f"resume round never resumed (stdout tail: {proc.stdout[-400:]})")
    losses = _losses(log_dir)
    after = [loss for step, loss in losses if step > killed_step]
    return {
        "exit_code": proc.returncode,
        "resumed_step": int(m.group(1)),
        "marker_consumed": not os.path.exists(os.path.join(log_dir, "preempt_marker.json")),
        "final_step": losses[-1][0] if losses else None,
        "loss_after_resume": after[0] if after else None,
        "final_loss": after[-1] if after else None,
        "restore_fallbacks": _registry(log_dir).get("ckpt.restore_fallbacks", 0),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="")
    ap.add_argument("--log-dir", default="", help="default: a fresh temporary directory")
    ap.add_argument("--timeout-s", type=float, default=240.0, help="per child run")
    args = ap.parse_args(argv)
    if args.log_dir:
        log_dir = args.log_dir
        os.makedirs(log_dir, exist_ok=True)
    else:
        log_dir = tempfile.mkdtemp(prefix="yamt_train_chaos_")
    artifact: dict = {"metric": "train_chaos_recovered_steps", "value": None, "unit": "steps",
                      "vs_baseline": None, "platform": args.device, "cpu_rehearsal": args.device == "cpu",
                      "log_dir": log_dir}
    try:
        chaos = run_chaos(log_dir, args.device, args.timeout_s)
        resume = run_resume(log_dir, chaos["killed_step"], args.device, args.timeout_s)
        artifact["chaos"] = chaos
        artifact["resume"] = resume
        if resume["final_step"] is not None:
            artifact["value"] = float(resume["final_step"] - resume["resumed_step"])
    except (RuntimeError, subprocess.TimeoutExpired, OSError, ValueError) as e:
        artifact["error"] = f"{type(e).__name__}: {e}"
    artifact["provenance"] = card_provenance(args.device)
    line = json.dumps(artifact)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    # SIGTERM's default action: a caller's SIGTERM ends the bench at once
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    sys.exit(main())

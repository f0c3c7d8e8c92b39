"""The port's post-run tools, ``obs/report.py`` and ``obs/trace_merge.py``
(copies of the JAX package's ``scripts/obs_report.py`` and
``scripts/trace_merge.py``), on what the port's runs write: a tiny
``cli.train`` run with ``obs.trace=true``, a ``cli.serve`` load-driver run
exported from it, and a ``cli.serve`` front door answering a few requests.
The twins of ``tests/test_obs.py``'s report and merge tests; the merge and
``--fleet`` also run on synthetic per-process traces, as there.

The report of a port run holds the section headings and metric names that
the JAX report shows for the same config (the JAX package's runs made here
on the CPU), not their values. Each package's runs are made in a fresh
process, so that its registry holds that run's metrics alone.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.config import parse_cli
from yet_another_mobilenet_series_tpu_torch.obs import report, trace_merge
from yet_another_mobilenet_series_tpu_torch.serve.client import ReplicaClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")
SIZE = 24
FRONT_DOOR_REQUESTS = 4
# what the JAX runs write and the port's do not: XLA's compile of the train
# step (the port's step is eager; it counts CUDA-graph captures as compiles,
# obs/device.py) and XLA's live-buffer census
JAX_ONLY = ("obs.compiles", "obs.compile_seconds.", "device.live_buffer_bytes")


def _train_cfg(log_dir):
    return {"name": "obs-report", "model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
                                            "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}]},
            "data": {"dataset": "fake", "image_size": SIZE, "fake_train_size": 64, "fake_eval_size": 16},
            "optim": {"optimizer": "sgd", "momentum": 0.9, "weight_decay": 1e-5},
            "schedule": {"schedule": "constant", "base_lr": 0.01, "scale_by_batch": False, "warmup_epochs": 0.0},
            "train": {"batch_size": 32, "eval_batch_size": 16, "epochs": 1, "log_every": 1,
                      "compute_dtype": "float32", "log_dir": log_dir},
            "obs": {"trace": True}, "dist": {"num_devices": 1}}


def _serve_cfg(log_dir, ckpt, bundle):
    return {"data": {"image_size": SIZE}, "train": {"log_dir": log_dir}, "obs": {"trace": True},
            "serve": {"export_from": ckpt, "bundle": bundle, "buckets": [2, 8], "max_batch": 8, "max_wait_ms": 5.0,
                      "requests": 24, "clients": 6}}


# a train run, then a serve run of its checkpoint, in one fresh process (the
# registry carries on, as in the JAX package's serving test; a worker that
# ran other tests first would carry their metrics)
_RUNS_CHILD = r"""
import json, sys
which, cfgs = sys.argv[1], json.loads(sys.argv[2])
if which == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from yet_another_mobilenet_series_tpu.cli import serve, train
    from yet_another_mobilenet_series_tpu.config import config_from_dict
    kw = {}
else:
    from yet_another_mobilenet_series_tpu_torch.cli import serve, train
    from yet_another_mobilenet_series_tpu_torch.config import config_from_dict
    kw = {"device": "cpu"}
train.run(config_from_dict(cfgs["train"]), **kw)
serve.run(config_from_dict(cfgs["serve"]), **kw)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same config through each package's CLIs, the two processes at once."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out, procs = {}, {}
    for which in ("port", "jax"):
        root = str(tmp_path_factory.mktemp(which))
        out[which] = {k: os.path.join(root, k) for k in ("train", "serve", "bundle")}
        cfgs = {"train": _train_cfg(out[which]["train"]),
                "serve": _serve_cfg(out[which]["serve"], os.path.join(out[which]["train"], "ckpt"),
                                    out[which]["bundle"])}
        procs[which] = subprocess.Popen([sys.executable, "-c", _RUNS_CHILD, which, json.dumps(cfgs)], cwd=root,
                                        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    for which, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (which, err[-4000:])
    return out


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs["port"]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def front_door(port_runs, tmp_path_factory):
    """The port's front door (``serve.listen``) on the train run's bundle,
    traced, answering FRONT_DOOR_REQUESTS requests, then stopped."""
    log_dir = str(tmp_path_factory.mktemp("front_door"))
    cfg = parse_cli([f"app:{APP}", "serve.listen.enable=true", f"serve.bundle={port_runs['bundle']}",
                     f"data.image_size={SIZE}", "serve.buckets=[1]", "serve.max_batch=1", "serve.drain_timeout_s=10",
                     "obs.trace=true", f"train.log_dir={log_dir}"])
    stop, out = threading.Event(), {}
    th = threading.Thread(target=lambda: out.update(serve_cli.run(cfg, device="cpu", stop_event=stop)))
    th.start()
    try:
        path, deadline = os.path.join(log_dir, "listen_addr.json"), time.time() + 120
        while not os.path.exists(path):
            assert th.is_alive() and time.time() < deadline, "the front door never bound"
            time.sleep(0.1)
        with open(path) as f:
            addr = json.load(f)
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
        x = np.random.RandomState(0).normal(0, 1, (FRONT_DOOR_REQUESTS, SIZE, SIZE, 3)).astype(np.float32)
        for i in range(FRONT_DOOR_REQUESTS):
            assert client.predict(x[i]).shape == (4,)
        client.close()
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive()
    return log_dir


def _render(module, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(list(argv))
    return rc, buf.getvalue()


def _jax_report(*argv):
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "obs_report.py"), *argv],
                         capture_output=True, text=True, timeout=120, check=True)
    return out.stdout


def _skeleton(text):
    """The report's section headings and the names of its rows, without
    values: a heading up to its first ``(`` or ``:``, a row's name before its
    ``=`` or ``:``, a cost row's ``[key]``, a quantile row's phase. A
    family's numeric label (``serve.bucket_hits.<bucket>``: which buckets a
    load hits depends on its timing) is one name."""
    names = set()
    for line in text.splitlines()[1:]:
        if line.startswith("## "):
            names.add(re.split(r"[:(]", line)[0].strip())
        elif line.startswith("  ") and not line.startswith("    "):
            row = line.strip()
            if row.startswith("["):
                names.add(row.split("]")[0] + "]")
            elif re.search(r" {2,}\d", row):
                names.add(re.split(r" {2,}", row)[0])
            else:
                name = row.split(" = ")[0] if " = " in row.split(":")[0] else row.split(":")[0]
                names.add(re.sub(r"\.\d+$", ".<label>", name))
    return names


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def test_report_renders_the_port_train_run(port_runs, tmp_path):
    rc, out = _render(report, port_runs["train"])
    assert rc == 0
    assert "last train/loss = " in out and "best eval/top1 = " in out and "last eval/loss = " in out
    snap = json.load(open(os.path.join(port_runs["train"], "obs_registry.json")))
    assert f"ckpt.saves = {snap['ckpt.saves']:.6g}" in out
    assert "## span trace: " in out and "obs_trace.json" in out
    # the port's training books and its eager step's cost
    assert "## training (host syncs / checkpoints / input)" in out
    assert f"checkpoints: saves = {snap['ckpt.saves']:.0f}, restores = 0" in out
    assert "## device (compile / cost / memory)" in out and "compiles = 0" in out and "[train_step]" in out
    # a hang report beside the run's artifacts (tests/test_obs.py's)
    run = tmp_path / "run"
    shutil.copytree(port_runs["train"], run)
    (run / "hang_report.json").write_text(json.dumps({
        "seconds_since_last_beat": 12.5, "deadline_s": 5.0, "last_step": 42, "last_phase": "step",
        "open_spans": [{"name": "dispatch/train_step", "cat": "dispatch", "open_for_s": 12.0}],
        "registry": {}, "threads": {"MainThread-1": ["..."]}}))
    rc, out = _render(report, str(run))
    assert rc == 0 and "HANG REPORT" in out and "open span: dispatch/train_step" in out


def test_report_device_section_of_the_port_serve_run(port_runs):
    rc, out = _render(report, port_runs["serve"])
    snap = json.load(open(os.path.join(port_runs["serve"], "obs_registry.json")))
    assert rc == 0 and "## serving" in out and "## device (compile / cost / memory)" in out
    assert f"compiles = {snap['obs.compiles']:.0f}" in out and snap["obs.compiles"] >= 2
    assert f"[serve_b8_s{SIZE}_k1]" in out and "dispatch efficiency: " in out and "host rss " in out
    assert "requests = 24, completed = 24" in out
    # the CPU replays no CUDA graph: no replay row
    assert "cuda graph replays" not in out


def test_report_renders_the_ports_registry_names(tmp_path):
    """The rows the port adds, on the names its modules write: CUDA-graph
    replays (serve/engine.py), the forced host syncs and checkpoint books
    (cli/train.py, ckpt/manager.py), the TFRecord stream's order seconds
    (data/pipeline.py), the card's memory gauges (obs/device.py)."""
    (tmp_path / "obs_registry.json").write_text(json.dumps({
        "serve.requests": 8.0, "serve.completed": 8.0, "serve.graph_replays": 6.0, "serve.dispatch_seconds.count": 6.0,
        "train.step": 12.0, "train.forced_host_syncs": 2.0, "ckpt.saves": 3.0, "ckpt.restores": 1.0,
        "ckpt.restore_fallbacks": 1.0, "ckpt.wait_seconds.count": 3.0, "ckpt.wait_seconds.p50": 0.004,
        "ckpt.wait_seconds.max": 0.02, "data.epoch_order_seconds": 0.25, "data.record_decode_failures": 1.0,
        "data.corrupt_records": 1.0, "obs.cost_flops.train_step": 2e9, "obs.cost_bytes.train_step": 5e8,
        "device.bytes_in_use.d0": 2e9, "device.peak_bytes_in_use.d0": 3e9}))
    rc, out = _render(report, str(tmp_path))
    assert rc == 0
    assert "cuda graph replays: 6 over 6 dispatches" in out
    assert "steps = 12, forced host syncs = 2" in out
    assert ("checkpoints: saves = 3, restores = 1 (fallbacks 1, integrity failures 0), wait p50 4.00 / max 20.00 ms "
            "over 3") in out
    assert "input: epoch order 0.250 s (last epoch), record decode failures = 1, corrupt batches skipped = 1" in out
    assert "compiles = 0" in out and "[train_step] 2.000 GFLOP, 500.0 MB accessed" in out
    assert "d0 in-use 2000 MB (peak 3000)" in out


@pytest.mark.parametrize("kind,argv", [("train", []), ("serve", ["--requests"])])
def test_report_shows_the_jax_reports_sections_and_names(port_runs, jax_runs, kind, argv):
    _, mine = _render(report, *argv, port_runs[kind])
    theirs = _jax_report(*argv, jax_runs[kind])
    missing = {n for n in _skeleton(theirs) - _skeleton(mine) if not n.startswith(JAX_ONLY)}
    assert not missing, (missing, mine)
    headings = [re.split(r"[:(]", line)[0].strip() for line in theirs.splitlines() if line.startswith("## ")]
    assert len(headings) >= 4 and all(h in mine for h in headings), headings


def test_report_of_a_missing_dir_and_as_a_module(port_runs):
    assert report.main(["/definitely/not/a/dir"]) == 2
    mod = "yet_another_mobilenet_series_tpu_torch.obs.report"
    proc = subprocess.run([sys.executable, "-m", mod, "/definitely/not/a/dir"], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 2 and "not a directory" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", mod, port_runs["train"]], capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("# obs report: ") and "## training" in proc.stdout


def test_report_requests_waterfalls_of_the_port_front_door(front_door):
    """--requests on a traced front door: one waterfall row per request id,
    its class, phase durations and outcome; the quantile table."""
    rc, out = _render(report, "--requests", front_door)
    assert rc == 0
    assert f"{FRONT_DOOR_REQUESTS} request(s) in the trace ring" in out
    rows = [line for line in out.splitlines() if re.match(r"  #\d+ +class=", line)]
    assert len(rows) == FRONT_DOOR_REQUESTS, out
    for row in rows:
        assert re.search(r"total=[\d.]+ms queued=[\d.]+ms inflight=[\d.]+ms threads=\d+ \[completed\]$", row), row
    assert "queue wait" in out and "latency [" in out and "p50_ms" in out and "p99_ms" in out


# ---------------------------------------------------------------------------
# the fleet trace merge, and the report's fleet view
# ---------------------------------------------------------------------------


def test_trace_merge_aligns_clocks_and_scopes_ids():
    """tests/test_obs.py's merge invariants: wall-origin offsets, colliding
    pids on their own lanes, per-process ids scoped, fleet/leg ids kept."""
    router = {
        "pid": 100, "process_name": "router", "origin_unix": 1000.0,
        "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 100, "tid": 0, "ts": 0},
            {"ph": "b", "cat": "serve", "name": "serve/request", "id": 5, "pid": 100, "tid": 1, "ts": 10.0},
            {"ph": "s", "cat": "serve", "name": "fleet/leg", "id": 80, "pid": 100, "tid": 1, "ts": 12.0,
             "args": {"trace": 5, "leg": "primary"}},
        ],
    }
    replica = {
        "pid": 100, "process_name": "r0", "origin_unix": 1000.5,
        "traceEvents": [
            {"ph": "b", "cat": "serve", "name": "serve/request", "id": 5, "pid": 100, "tid": 1, "ts": 3.0,
             "args": {"trace": 5}},
            {"ph": "f", "bp": "e", "cat": "serve", "name": "fleet/leg", "id": 80, "pid": 100, "tid": 1, "ts": 4.0},
        ],
    }
    merged = trace_merge.merge([router, replica], sources=["router.json", "r0.json"])
    assert "warnings" not in merged
    procs = {p["process_name"]: p for p in merged["processes"]}
    assert procs["router"]["pid"] == 100 and procs["r0"]["pid"] != 100
    assert procs["router"]["offset_us"] == 0.0 and procs["r0"]["offset_us"] == 500000.0
    ev = {(e["pid"], e["ph"], e["name"]): e for e in merged["traceEvents"]}
    rpid = procs["r0"]["pid"]
    assert ev[(rpid, "b", "serve/request")]["ts"] == 3.0 + 500000.0
    assert ev[(100, "M", "process_name")]["ts"] == 0
    a, b = ev[(100, "b", "serve/request")]["id"], ev[(rpid, "b", "serve/request")]["id"]
    assert a != b and a % trace_merge.ID_STRIDE == 5 and b % trace_merge.ID_STRIDE == 5
    assert ev[(100, "s", "fleet/leg")]["id"] == 80 and ev[(rpid, "f", "fleet/leg")]["id"] == 80


def test_trace_merge_cli_discovers_writes_and_warns(tmp_path, capsys):
    doc = {"pid": 1, "process_name": "router", "origin_unix": 5.0,
           "traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 1.0, "dur": 2.0}]}
    (tmp_path / "obs_trace.json").write_text(json.dumps(doc))
    for i, origin in enumerate((5.25, None)):
        d = dict(doc, pid=2 + i, process_name=f"r{i}")
        if origin is None:
            d.pop("origin_unix")
        else:
            d["origin_unix"] = origin
        (tmp_path / f"r{i}").mkdir()
        (tmp_path / f"r{i}" / "obs_trace.json").write_text(json.dumps(d))
    assert trace_merge.main([str(tmp_path)]) == 0
    printed = capsys.readouterr()
    out = json.load(open(tmp_path / "merged_trace.json"))
    assert [p["process_name"] for p in out["processes"]] == ["router", "r0", "r1"]
    assert [p["offset_us"] for p in out["processes"]] == [0.0, 250000.0, 0.0]
    assert len(out["warnings"]) == 1 and "r1" in out["warnings"][0]
    assert "merged_trace.json" in printed.out
    (tmp_path / "empty").mkdir()
    assert trace_merge.main([str(tmp_path / "empty")]) == 2


def test_trace_merge_joins_the_ports_traces(port_runs, front_door, tmp_path):
    """The port's own traces as a fleet's: the serve run as the router's,
    the front door as replica r0. Each lane keeps its events, shifted by the
    gap of the two origins; ``python -m`` writes the merged file."""
    docs = [json.load(open(os.path.join(d, "obs_trace.json"))) for d in (port_runs["serve"], front_door)]
    assert all(isinstance(d["origin_unix"], float) and d["process_name"] and d["pid"] for d in docs)
    (tmp_path / "r0").mkdir()
    shutil.copy(os.path.join(port_runs["serve"], "obs_trace.json"), tmp_path / "obs_trace.json")
    shutil.copy(os.path.join(front_door, "obs_trace.json"), tmp_path / "r0" / "obs_trace.json")
    proc = subprocess.run([sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.obs.trace_merge",
                           str(tmp_path)], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    merged = json.load(open(tmp_path / "merged_trace.json"))
    assert len(merged["traceEvents"]) == sum(len(d["traceEvents"]) for d in docs) > 0
    lanes = [p["pid"] for p in merged["processes"]]
    assert len(set(lanes)) == 2
    base = min(d["origin_unix"] for d in docs)
    assert [p["offset_us"] for p in merged["processes"]] == [round((d["origin_unix"] - base) * 1e6, 3) for d in docs]
    rc, out = _render(report, "--fleet", str(tmp_path))
    assert rc == 0 and "merged trace: " in out and "2 process lanes" in out


def test_report_fleet_section(tmp_path):
    """--fleet on a layout with one traced replica slot and an incident: the
    JAX report's lines, with the port's merge named in the hint."""
    (tmp_path / "r0").mkdir()
    (tmp_path / "r0" / "obs_trace.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / "incident_ejection.json").write_text(json.dumps({
        "reason": "ejection", "t_unix": 1000.0, "brownout_level": 0,
        "events": [{"t_unix": 999.0, "kind": "ejection", "replica": "127.0.0.1:9001"}],
        "registry": {},
        "fleet": {"replicas": {"127.0.0.1:9000": {}}, "window_p99_s": {"interactive": 0.012},
                  "scrapes": 5, "scrape_errors": 0,
                  "slo": {"burn_short": 1.5, "burn_long": 0.2, "fast_burn": False,
                          "target_p99_ms": 250.0, "error_budget": 0.01}},
    }))
    rc, out = _render(report, str(tmp_path), "--fleet")
    assert rc == 0
    assert "## fleet" in out and "replica slots: 1 (1 with traces)" in out
    assert f"python -m yet_another_mobilenet_series_tpu_torch.obs.trace_merge {tmp_path}" in out
    assert "incident_ejection.json" in out and "reason = ejection" in out and "ejection x1" in out
    assert "window p99 [interactive] = 12.00 ms" in out and "burn short 1.50" in out
    theirs = _jax_report(str(tmp_path), "--fleet")
    assert out.replace("python -m yet_another_mobilenet_series_tpu_torch.obs.trace_merge",
                       "python scripts/trace_merge.py") == theirs

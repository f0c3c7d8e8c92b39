"""The life of a port training run (cli/train.py) on the CPU: the fallback
restore over corrupt checkpoints, SIGTERM kill-and-resume, the resumable
fake stream, and the fault injector under the corrupt-record skip and the
step guard.

Mirrors of tests/test_preempt.py (the corrupt spec sidecar, the truncated
tree item, the digest mismatch, every candidate corrupt, the SIGTERM e2e in
a subprocess, the faults wired through the CLI) and of
tests/test_resume_data.py (the fake stream resumed at k equals the
uninterrupted stream from k; the CLI passes the restored step), plus what
the port owes beyond the JAX package: a run killed at step k and resumed
equals the uninterrupted run bit for bit, step generator included (the
JAX package folds its keys from the step; the port's generator is
stateful and rides in the checkpoint).
"""

import glob
import itertools
import json
import os
import signal
import subprocess
import sys
import time

import pytest

import torch

from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager
from yet_another_mobilenet_series_tpu_torch.ckpt import manager as mgr_mod
from yet_another_mobilenet_series_tpu_torch.cli import train as cli_train
from yet_another_mobilenet_series_tpu_torch.config import DataConfig, config_from_dict
from yet_another_mobilenet_series_tpu_torch.data import pipeline
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.obs import registry as obs_registry
from yet_another_mobilenet_series_tpu_torch.parallel import make_mesh
from yet_another_mobilenet_series_tpu_torch.train import faults as faults_lib
from yet_another_mobilenet_series_tpu_torch.train import guard as guard_lib
from yet_another_mobilenet_series_tpu_torch.train import steps
from yet_another_mobilenet_series_tpu_torch.utils.logging import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _cli_cfg(tmp_path, **over):
    d = {
        "name": "preempt",
        "model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
                  "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}]},
        "data": {"dataset": "fake", "image_size": 16, "fake_train_size": 256, "fake_eval_size": 32,
                 "fake_num_classes": 4},
        "optim": {"optimizer": "sgd", "momentum": 0.9, "weight_decay": 0.0},
        "schedule": {"schedule": "constant", "base_lr": 0.05, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": False},
        "train": {"batch_size": 16, "eval_batch_size": 16, "epochs": 1, "log_every": 2, "compute_dtype": "float32",
                  "log_dir": str(tmp_path), "eval_every_epochs": 0.0},
    }
    for k, v in over.items():
        cur = d
        ks = k.split(".")
        for kk in ks[:-1]:
            cur = cur.setdefault(kk, {})
        cur[ks[-1]] = v
    return config_from_dict(d)


def _counter(name):
    return obs_registry.get_registry().snapshot().get(name, 0.0)


def _assert_same_state(a, b):
    fa, fb = (convert.flatten_tree(steps.train_state_to_dict(t)) for t in (a, b))
    assert set(fa) == set(fb)
    for k in fa:
        assert (fa[k] is None and fb[k] is None) or torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# crash-consistent restore: fallback through corrupt checkpoints
# ---------------------------------------------------------------------------


def _two_checkpoints(tmp_path):
    """Two real checkpoints (steps 1 and 2) through the CLI's Trainer, tagged
    via extra so the test can see which one a restore picked."""
    cfg = _cli_cfg(tmp_path)
    log = Logger(enabled=False)
    net = get_model(cfg.model, cfg.data.image_size)
    trainer = cli_train.Trainer(cfg, net, CPU)
    ts = trainer.init_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    for step in (1, 2):
        ts = ts.replace(step=torch.tensor(step, dtype=torch.int32))
        mgr.save(step, net, ts, extra={"tag": f"step{step}", "epoch": float(step)})
    return cfg, log, mgr


def _restore(cfg, log, mgr):
    trainer, ts, extra, _ = cli_train._restore(mgr, cfg, make_mesh(CPU), log)
    return int(ts.step), extra


def test_restore_falls_back_on_corrupt_spec_sidecar(tmp_path):
    cfg, log, mgr = _two_checkpoints(tmp_path)
    (tmp_path / "ck" / "2" / mgr_mod.META_NAME).write_text("{ this is not json")
    before = _counter("ckpt.restore_fallbacks")
    step, extra = _restore(cfg, log, mgr)
    assert extra["tag"] == "step1" and step == 1
    assert _counter("ckpt.restore_fallbacks") == before + 1


def test_restore_falls_back_on_truncated_tree_item(tmp_path):
    cfg, log, mgr = _two_checkpoints(tmp_path)
    items = glob.glob(str(tmp_path / "ck" / "2" / mgr_mod.TREE_DIR / "*.pt"))
    assert len(items) >= 3
    for f in items:
        with open(f, "rb") as fh:
            b = fh.read()
        with open(f, "wb") as fh:
            fh.write(b[: max(1, len(b) // 2)])
    before = _counter("ckpt.restore_fallbacks")
    step, extra = _restore(cfg, log, mgr)
    assert extra["tag"] == "step1" and step == 1
    assert _counter("ckpt.restore_fallbacks") == before + 1


@pytest.mark.parametrize("how", ["recorded digest", "flipped bytes"])
def test_restore_falls_back_on_digest_mismatch(tmp_path, how):
    """Corruption the file format cannot see (the bytes load, the values are
    wrong) is caught by the digests: a rewritten recorded digest, or bytes
    flipped inside a tensor's data in the item file."""
    cfg, log, mgr = _two_checkpoints(tmp_path)
    digest_path = tmp_path / "ck" / mgr_mod.DIGEST_NAME
    index = json.loads(digest_path.read_text())
    assert set(index) == {"1", "2"}
    if how == "recorded digest":
        index["2"]["params"] = "0" * 64
        digest_path.write_text(json.dumps(index))
    else:
        path = tmp_path / "ck" / "2" / mgr_mod.TREE_DIR / "params.pt"
        blob = bytearray(path.read_bytes())
        w = convert.flatten_tree(torch.load(path, weights_only=True))["stem/conv/w"]
        at = bytes(blob).find(w.numpy().tobytes()[:64])
        assert at > 0
        blob[at + 8] ^= 0x40
        path.write_bytes(bytes(blob))
        assert not torch.equal(convert.flatten_tree(torch.load(path, weights_only=True))["stem/conv/w"], w)
    before, failures = _counter("ckpt.restore_fallbacks"), _counter("ckpt.integrity_failures")
    step, extra = _restore(cfg, log, mgr)
    assert extra["tag"] == "step1" and step == 1
    assert _counter("ckpt.restore_fallbacks") == before + 1
    assert _counter("ckpt.integrity_failures") == failures + 1


def test_restore_raises_when_every_candidate_is_corrupt(tmp_path):
    cfg, log, mgr = _two_checkpoints(tmp_path)
    for step in (1, 2):
        (tmp_path / "ck" / str(step) / mgr_mod.META_NAME).write_text("garbage")
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        cli_train._restore(mgr, cfg, make_mesh(CPU), log)


def test_legacy_checkpoint_without_rho_mult_restores_and_a_corrupt_one_does_not(tmp_path):
    """The narrow legacy retry: a search checkpoint saved before rho_mult
    existed restores with the neutral multiplier; one whose item list names
    rho_mult but whose rho_mult item is unreadable is corruption."""
    cfg = _cli_cfg(tmp_path, **{"prune.enable": True})
    log = Logger(enabled=False)
    net = get_model(cfg.model, cfg.data.image_size)
    trainer = cli_train.Trainer(cfg, net, CPU)
    ts = trainer.init_state(0).replace(rho_mult=torch.tensor(0.5))
    mgr = CheckpointManager(str(tmp_path / "ckl"), async_save=False)
    mgr.save(1, net, ts.replace(rho_mult=None))
    tree_dir = tmp_path / "ckl" / "1" / mgr_mod.TREE_DIR
    items = json.loads((tree_dir / mgr_mod.ITEMS_NAME).read_text())
    del items["rho_mult"]  # the pre-rho_mult layout
    (tree_dir / mgr_mod.ITEMS_NAME).write_text(json.dumps(items))
    target = steps.train_state_to_dict(trainer.init_state(0))
    tree = cli_train._restore_tree(mgr, 1, target, log)
    assert float(tree["rho_mult"]) == 1.0
    mgr.save(2, net, ts)
    (tmp_path / "ckl" / "2" / mgr_mod.TREE_DIR / "rho_mult.pt").write_bytes(b"torn")
    with pytest.raises(Exception) as e:
        cli_train._restore_tree(mgr, 2, target, log)
    assert not isinstance(e.value, KeyError)


# ---------------------------------------------------------------------------
# the resumable fake stream
# ---------------------------------------------------------------------------


def _take(it, n):
    return list(itertools.islice(it, n))


def test_fake_stream_resumed_at_k_equals_the_uninterrupted_stream():
    cfg = DataConfig(dataset="fake", image_size=8, fake_train_size=32, fake_num_classes=4)
    full = _take(pipeline.make_train_source(cfg, 4, seed=7, device="cpu"), 12)
    for start in (5, 9):  # inside epoch 0; across the epoch boundary (8 batches an epoch)
        resumed = _take(pipeline.make_train_source(cfg, 4, seed=7, device="cpu", start_step=start), 12 - start)
        for i, (a, b) in enumerate(zip(resumed, full[start:])):
            assert torch.equal(a["label"], b["label"]) and torch.equal(a["image"], b["image"]), (start, i)
    # a batch that straddles two epochs (32 rows, batch 12) resumes too
    full = _take(pipeline.make_train_source(cfg, 12, seed=3, device="cpu"), 6)
    resumed = _take(pipeline.make_train_source(cfg, 12, seed=3, device="cpu", start_step=2), 4)
    assert all(torch.equal(a["image"], b["image"]) for a, b in zip(resumed, full[2:]))
    # another seed is another stream
    other = _take(pipeline.make_train_source(cfg, 12, seed=4, device="cpu"), 1)[0]
    assert not torch.equal(other["image"], full[0]["image"])


def test_cli_passes_the_restored_step_as_start_step(tmp_path, monkeypatch):
    recorded = []
    real = pipeline.make_train_source

    def recording(*args, start_step=0, **kw):
        recorded.append(start_step)
        return real(*args, start_step=start_step, **kw)

    monkeypatch.setattr(pipeline, "make_train_source", recording)
    cfg = _cli_cfg(tmp_path, **{"data.fake_train_size": 64})
    cli_train.run(cfg, device="cpu")  # fresh: 64 / 16 = 4 steps
    out = cli_train.run(_cli_cfg(tmp_path, **{"data.fake_train_size": 64, "train.epochs": 2}), device="cpu")
    assert recorded == [0, 4] and out["resumed_from"] == 4 and out["step"] == 8


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------


def _life_cfg(log_dir, **over):
    """Dropout and mixup on, so every step draws from the step generator;
    3 steps an epoch, a checkpoint at every epoch's end."""
    return _cli_cfg(log_dir, **{"data.fake_train_size": 24, "train.batch_size": 8, "train.eval_batch_size": 8,
                                "data.fake_eval_size": 8, "train.epochs": 4, "train.log_every": 3,
                                "model.dropout": 0.3, "optim.mixup_alpha": 0.4, "ema.enable": True,
                                "ema.decay": 0.9, **over})


def _final_generator(log_dir, step):
    mgr = CheckpointManager(os.path.join(log_dir, "ckpt"))
    return mgr.restore_tree(step)["generator"]


def test_kill_at_step_then_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    a_dir, c_dir = tmp_path / "a", tmp_path / "c"
    a, ts_a, _ = cli_train.train(_life_cfg(a_dir), device="cpu")
    assert a["checkpoints"] == [3, 6, 9, 12] and a["preempted"] is False
    before = _counter("train.preemptions")
    c, _, _ = cli_train.train(_life_cfg(c_dir, **{"train.faults.enable": True, "train.faults.kill_at_step": 7}),
                              device="cpu")
    # the injector's SIGTERM lands after the batch of step index 7: the step
    # that takes it finishes, and the loop stops at step 8
    assert c["preempted"] is True and c["step"] == 8 and c["checkpoints"] == [3, 6, 8]
    assert _counter("train.preemptions") == before + 1
    marker = json.loads((c_dir / cli_train.PREEMPT_MARKER_NAME).read_text())
    assert marker["step"] == 8 and marker["reason"] == "SIGTERM" and marker["epoch"] == pytest.approx(8 / 3)
    d, ts_d, _ = cli_train.train(_life_cfg(c_dir), device="cpu")
    assert d["resumed_from"] == 8 and d["step"] == 12 and d["steps"] == 4 and d["preempted"] is False
    assert not (c_dir / cli_train.PREEMPT_MARKER_NAME).exists()
    _assert_same_state(ts_a, ts_d)
    assert torch.equal(_final_generator(a_dir, 12), _final_generator(c_dir, 12))


def test_resume_walks_back_over_a_corrupt_newest_step_and_still_matches(tmp_path):
    """The preempted run's newest step (8) corrupted: resume falls back to 6,
    counted, and the run from 6 ends where the uninterrupted one does."""
    a, ts_a, _ = cli_train.train(_life_cfg(tmp_path / "a"), device="cpu")
    c_dir = tmp_path / "c"
    cli_train.train(_life_cfg(c_dir, **{"train.faults.enable": True, "train.faults.kill_at_step": 7}), device="cpu")
    item = c_dir / "ckpt" / "8" / mgr_mod.TREE_DIR / "opt_state.pt"
    item.write_bytes(item.read_bytes()[:100])
    before = _counter("ckpt.restore_fallbacks")
    d, ts_d, _ = cli_train.train(_life_cfg(c_dir), device="cpu")
    assert d["resumed_from"] == 6 and d["step"] == 12
    assert _counter("ckpt.restore_fallbacks") == before + 1
    _assert_same_state(ts_a, ts_d)


def test_warm_start_from_a_port_checkpoint_takes_its_weights_with_a_fresh_optimizer(tmp_path):
    src, ts_src, _ = cli_train.train(_life_cfg(tmp_path / "src", **{"train.epochs": 1}), device="cpu")
    cfg = _life_cfg(tmp_path / "warm", **{"train.pretrained": str(tmp_path / "src" / "ckpt"), "train.epochs": 1})
    net = get_model(cfg.model, cfg.data.image_size)
    trainer, ts = cli_train._init_or_warm_start(cfg, net, make_mesh(CPU), Logger(enabled=False))
    assert int(ts.step) == 0 and int(ts.opt_state["count"]) == 0
    for tree, src_tree in ((ts.params, ts_src.params), (ts.ema_params, ts_src.params), (ts.state, ts_src.state)):
        a, b = convert.flatten_tree(tree), convert.flatten_tree(src_tree)
        assert all(torch.equal(a[k], b[k]) for k in b)
    out = cli_train.run(cfg, device="cpu")
    assert out["step"] == 3 and out["resumed_from"] is None
    with pytest.raises(FileNotFoundError, match="holds no checkpoint"):
        cli_train.run(_life_cfg(tmp_path / "w2", **{"train.pretrained": str(tmp_path / "nowhere")}), device="cpu")


def test_eval_only_of_the_runs_own_checkpoint_and_the_smoke_mode(tmp_path):
    a, ts_a, _ = cli_train.train(_life_cfg(tmp_path / "a", **{"train.epochs": 1}), device="cpu")
    ev = cli_train.run(_life_cfg(tmp_path / "a", **{"train.test_only": True}), device="cpu")
    assert ev["test_only"] is True and ev["step"] == 3 and ev["eval_loss"] == pytest.approx(a["eval_loss"])
    smoke = cli_train.run(_life_cfg(tmp_path / "empty", **{"train.test_only": True}), device="cpu")
    assert smoke["step"] == 0 and smoke["eval_n"] == 8


def test_sigterm_kill_and_resume_e2e(tmp_path):
    """An externally SIGTERM'd training subprocess exits cleanly (rc 0) with
    a synchronous final checkpoint and a resume marker; a resumed run
    continues from that step, same log dir, and finishes."""
    log_dir = tmp_path / "run"
    overrides = [
        "data.dataset=fake", "data.image_size=16", "data.fake_train_size=4096", "data.fake_eval_size=32",
        "data.fake_num_classes=4", "model.arch=mobilenet_v2", "model.num_classes=4", "model.dropout=0.0",
        "model.block_specs=[{t: 2, c: 8, n: 1, s: 2}]", "optim.optimizer=sgd", "optim.momentum=0.9",
        "optim.weight_decay=0.0", "schedule.schedule=constant", "schedule.base_lr=0.05",
        "schedule.scale_by_batch=false", "schedule.warmup_epochs=0.0", "ema.enable=false", "train.batch_size=16",
        "train.eval_batch_size=16", "train.epochs=50", "train.log_every=1", "train.compute_dtype=float32",
        "train.eval_every_epochs=0", "train.checkpoint_every_epochs=0", f"train.log_dir={log_dir}",
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.train", *overrides,
                             "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)
    try:
        metrics_path = log_dir / "metrics.jsonl"
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if len(metrics_path.read_text().splitlines()) >= 2:
                    break
            except OSError:
                pass
            if proc.poll() is not None:
                out, err = proc.communicate()
                pytest.fail(f"training died before the kill: {err[-800:]}")
            time.sleep(0.2)
        else:
            pytest.fail("training never produced metric rows")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-500:], err[-500:])
    assert "preemption checkpoint" in out
    marker = json.loads((log_dir / cli_train.PREEMPT_MARKER_NAME).read_text())
    killed = int(marker["step"])
    assert killed > 0 and marker["reason"] == "SIGTERM"
    assert CheckpointManager(str(log_dir / "ckpt")).latest_step() == killed
    # resume in-process, one epoch of 256 steps past nothing: a short target
    cfg = _cli_cfg(log_dir, **{"data.fake_train_size": 4096, "train.epochs": (killed + 3) / 256.0,
                               "train.log_every": 1})
    result = cli_train.run(cfg, device="cpu")
    assert result["preempted"] is False and result["resumed_from"] == killed and result["step"] == killed + 3
    assert not (log_dir / cli_train.PREEMPT_MARKER_NAME).exists()


# ---------------------------------------------------------------------------
# the fault injector under the resilience layers
# ---------------------------------------------------------------------------


def test_guard_and_faults_wired_through_cli(tmp_path):
    """train.faults poisons one step with NaN, train.guard skips it, and the
    run completes with the skip counted; corrupt records are skipped and
    counted on the way."""
    before = {k: _counter(k) for k in ("train.skipped_steps", "train.faults.nan_steps", "data.corrupt_records")}
    cfg = _cli_cfg(tmp_path, **{"train.guard.enable": True, "train.guard.max_skipped_steps": 3,
                                "train.faults.enable": True, "train.faults.nan_at_steps": [3],
                                "train.faults.corrupt_record_rate": 0.5})
    result = cli_train.run(cfg, device="cpu")
    assert result["epoch"] == pytest.approx(1.0) and result["steps"] == 16 and result["skipped_steps"] == 1
    assert _counter("train.skipped_steps") == before["train.skipped_steps"] + 1
    assert _counter("train.faults.nan_steps") == before["train.faults.nan_steps"] + 1
    assert _counter("data.corrupt_records") > before["data.corrupt_records"]
    assert not os.path.exists(tmp_path / guard_lib.HEALTH_REPORT_NAME)


def test_guard_budget_aborts_run_with_health_report(tmp_path):
    cfg = _cli_cfg(tmp_path, **{"train.guard.enable": True, "train.guard.max_skipped_steps": 2,
                                "train.faults.enable": True, "train.faults.nan_at_steps": list(range(1, 17))})
    with pytest.raises(guard_lib.TrainHealthError):
        cli_train.run(cfg, device="cpu")
    assert json.loads((tmp_path / guard_lib.HEALTH_REPORT_NAME).read_text())["skipped_total"] > 2


def test_consecutive_corrupt_records_abort_the_stream():
    src = faults_lib.FaultyTrainSource(iter(range(100)), corrupt_record_rate=1.0)
    with pytest.raises(pipeline.DataPipelineError, match="consecutive"):
        next(pipeline.resilient_batches(src, max_consecutive=4))


def test_nan_poisoning_clones_the_device_batch():
    batch = {"image": torch.zeros(2, 4, 4, 3), "label": torch.zeros(2, dtype=torch.int32)}
    src = faults_lib.FaultyTrainSource(iter([batch]), nan_at_steps=[0])
    out = next(src)
    assert torch.isnan(out["image"][0]).all() and not torch.isnan(out["image"][1]).any()
    assert not torch.isnan(batch["image"]).any()  # the stream's own tensor is untouched


def test_the_stall_watchdog_armed_by_the_cli_writes_a_hang_report(tmp_path):
    """The loader stalls at step 2 for longer than the deadline, which is
    longer than the run's start (the watchdog is armed from the start)."""
    cfg = _cli_cfg(tmp_path, **{"obs.watchdog_deadline_s": 4.0, "obs.watchdog_poll_s": 0.1,
                                "train.faults.enable": True, "train.faults.stall_at_step": 2,
                                "train.faults.stall_ms": 6000.0, "data.fake_train_size": 64})
    cli_train.run(cfg, device="cpu")
    report = json.loads((tmp_path / "hang_report.json").read_text())
    assert report["last_step"] == 2 and report["last_phase"] == "step" and report["deadline_s"] == 4.0


def test_a_latency_table_search_resumes_after_a_rematerialization_with_its_sliced_costs(tmp_path, capsys):
    """A search with prune.cost=latency_table checkpoints the rebuilt
    Trainer's sliced atom costs (the table has no entry for a shrunk block,
    ROADMAP F2), so a resume past a rematerialization rebuilds the Trainer
    at the pruned shape with them, and ends where the uninterrupted search
    does, searched_arch.json included."""
    from test_torch_port_bench import TINY_TABLE, _run
    from yet_another_mobilenet_series_tpu_torch.bench import latency_table
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    path = tmp_path / "LATENCY_TABLE.json"
    assert _run(latency_table.main, ["--device", "cpu", *TINY_TABLE, "--out", str(path)], capsys)[0] == 0
    app = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "atomnas_a_search.yml")

    def cfg(tag, *extra):
        return parse_cli([f"app:{app}", "dist.num_devices=1", "data.dataset=fake", "model.width_mult=0.35",
                          "data.image_size=32", "model.num_classes=10", "train.batch_size=8",
                          "data.fake_train_size=16", "data.fake_eval_size=8", "train.eval_batch_size=8",
                          "train.epochs=3", "train.log_every=2", "prune.mask_interval=1",
                          "prune.remat_epochs=1", "prune.gamma_threshold=1.0", "prune.target_flops=1.2e6",
                          "prune.cost=latency_table", f"prune.latency_table={path}", "train.compute_dtype=float32",
                          f"train.log_dir={tmp_path / tag}", *extra])

    a, ts_a, net_a = cli_train.train(cfg("a"), device="cpu")
    assert a["remats"][0]["step"] == 2 and a["remats"][0]["atoms_after"] < a["remats"][0]["atoms_before"]
    b, _, _ = cli_train.train(cfg("b", "train.faults.enable=true", "train.faults.kill_at_step=2"), device="cpu")
    assert b["preempted"] and b["step"] == 3
    # the preemption checkpoint holds the network the rematerialization at step 2 shrank, and its costs
    _, saved_net, extra = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore_spec(3)
    assert saved_net.blocks != get_model(cfg("x").model, 32).blocks
    assert {k: len(v) for k, v in extra["atom_costs"].items()} == {
        str(i): blk.expanded_channels for i, blk in enumerate(saved_net.blocks) if str(i) in extra["atom_costs"]}
    c, ts_c, net_c = cli_train.train(cfg("b"), device="cpu")
    assert c["resumed_from"] == 3 and c["step"] == a["step"] == 6
    assert net_c == net_a and c["searched"]["macs"] == a["searched"]["macs"]
    _assert_same_state(ts_a, ts_c)

"""The harness on the CPU, on the miniature cells: the result line's keys, discovery by name,
traffic from the seed, the modules a run loads, the refusal without a card, and ``correct``
coming out false under each fault a cell can have, planted underneath the timed path."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs, run
from benchmark.traffic import bulk

from .conftest import REPO, make_tiny_root

CPU = torch.device("cpu")
TRAIN, SERVE = "mobilenet_v3_large.train_b512", "efficientnet_b0.serve_bulk"
# limits for the miniature cells at float32 on the CPU, where sound runs read under 1e-3
TINY_LIMITS = {TRAIN: {"grad_median": 1e-3, "change_median": 1e-3, "bn_stats": 1e-3, "ema": 1e-2, "ema_stats": 1e-2},
               SERVE: {"logits": 1e-3, "missing_requests": 0.0}}


@pytest.fixture
def limited_root(tmp_path):
    return make_tiny_root(tmp_path, limits=TINY_LIMITS)


def _keys_in_order(result: dict, trace: bool) -> None:
    expected = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == expected
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in result["device"]
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_a_sound_run_is_correct_and_its_line_has_the_result_keys(cell, limited_root, capsys):
    code, result = run.run(cell, 2**31 + 77, 3.0, False, root=limited_root, device=CPU)
    assert code == 0
    _keys_in_order(result, False)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    e2e = {"train_images_per_s", "train_peak_gb"} if "train" in cell else {"serve_images_per_s"}
    assert set(result["metrics"]) <= e2e | {"setup_s"} and "setup_s" in result["metrics"]
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-len(result["checks"]):])


def test_a_traced_run_has_a_breakdown(limited_root):
    code, result = run.run(TRAIN, 5, 1.0, True, root=limited_root, device=CPU)
    assert code == 0
    _keys_in_order(result, True)
    assert result["metrics"] == {}  # no device event on the CPU: every reader finds nothing


def test_without_a_card_a_run_prints_nothing_and_fails(limited_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.run(TRAIN, 1, 1.0, False, root=limited_root) == (2, None)


def test_cells_configurations_and_metrics_are_found_by_name(tmp_path):
    root = make_tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copy(root / "benchmark/configs/mobilenet_v3_large.json", root / "benchmark/configs/other_net.json")
    manifest["configs"].append(dict(manifest["configs"][0], name="other_net", file="benchmark/configs/other_net.json"))
    (root / "benchmark/traffic/train_b4.json").write_text(json.dumps({"kind": "train", "batch": 4, "pool_batches": 4,
                                                                       "trace_steps": 2}))
    manifest["workloads"].append({"name": "other_net.train_b4", "config": "other_net", "traffic": "train_b4",
                                  "chips": 1, "why": "a cell added by files alone"})
    (root / "benchmark/workloads/other_net.train_b4.json").write_text(json.dumps({"why": "x", "limits": {}}))
    (root / "benchmark/metrics/steps_traced.train.py").write_text("def read(r):\n    return float(r.window['steps'])\n")
    manifest["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "training step", "moves": "train_images_per_s",
                                  "workloads": ["other_net.train_b4"]})
    manifest["end_to_end"][0]["workloads"].append("other_net.train_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = run.load_cell("other_net.train_b4", root)
    assert cell.traffic["batch"] == 4 and cell.config["model"]["arch"] == "mobilenet_v3_large"
    assert [m["name"] for m in run.per_layer(cell)] == ["steps_traced.train"]
    code, result = run.run("other_net.train_b4", 3, 1.0, True, root=root, device=CPU)
    assert code == 0 and result["metrics"]["steps_traced.train"]["value"] == 2.0


def test_traffic_is_the_same_for_a_seed_and_differs_across_seeds():
    mix = json.loads((REPO / "benchmark/traffic/serve_bulk.json").read_text())
    a, b, c = bulk.plan(mix, 2**31 + 5), bulk.plan(mix, 2**31 + 5), bulk.plan(mix, 2**31 + 6)
    assert a == b and a != c
    # every seed sends the same set of sizes, in another order
    assert sorted(s for seq in a[0] for s, _ in seq) == sorted(s for seq in c[0] for s, _ in seq)
    x1 = inputs.images(9, "train-images-0", 2, 8, "cpu")
    assert torch.equal(x1, inputs.images(9, "train-images-0", 2, 8, "cpu"))
    assert not torch.equal(x1, inputs.images(10, "train-images-0", 2, 8, "cpu"))
    p1, _ = inputs.weights(bulk.nets.from_config({"arch": "efficientnet_b0"}), 9, "cpu")
    p2, _ = inputs.weights(bulk.nets.from_config({"arch": "efficientnet_b0"}), 10, "cpu")
    assert not torch.equal(p1["classifier/w"], p2["classifier/w"])


def test_the_sampled_requests_go_first_and_the_longest_leads():
    """A slow window sends fewer requests: the sample is what it sent, and it holds the longest."""
    mix = json.loads((REPO / "benchmark/traffic/serve_bulk.json").read_text())
    seqs, keep = bulk.plan(mix, 2**31 + 7)
    assert len(keep) == len(bulk.request_sizes(mix))
    firsts = [seqs[c][0][0] for c in range(len(seqs))]
    assert max(firsts) == max(bulk.request_sizes(mix))
    for c, seq in enumerate(seqs):
        own = [seq[i][0] for i in range(len(seq)) if (c, i) in keep]
        assert own == sorted(own, reverse=True) and all((c, i) in keep for i in range(len(own)))


def test_the_modules_a_run_loads_hold_no_jax(limited_root):
    code = (f"import sys, torch, json; import benchmark.run as r; "
            f"c, res = r.run({TRAIN!r}, 4, 0.5, False, root=__import__('pathlib').Path({str(limited_root)!r}), "
            f"device=torch.device('cpu')); "
            f"print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "yet_another_mobilenet_series_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "yet_another_mobilenet_series_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "yet_another_mobilenet_series_tpu.config", sys)
    assert run.forbidden_modules() == ["yet_another_mobilenet_series_tpu"]


# -- faults planted underneath the timed path: correct comes out false ---------------------------

def _faulty_step(monkeypatch, fault):
    from yet_another_mobilenet_series_tpu_torch.parallel import dp

    real = dp.make_dp_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def faulty(ts, batch, gen):
            if fault == "unchanged":
                _, metrics = step(ts, batch, gen)
                return ts, metrics
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(ts, half, gen)

        return faulty

    monkeypatch.setattr(dp, "make_dp_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_faulty_train_step_is_not_correct(fault, limited_root, monkeypatch):
    _faulty_step(monkeypatch, fault)
    code, result = run.run(TRAIN, 6, 0.5, False, root=limited_root, device=CPU)
    assert code == 0 and result["correct"] is False


@pytest.mark.parametrize("fault", ["altered", "half_rows"])
def test_a_faulty_served_answer_is_not_correct(fault, limited_root, monkeypatch):
    from yet_another_mobilenet_series_tpu_torch.serve import engine

    real = engine.InferenceEngine.predict_async

    class Wrong:
        def __init__(self, pending):
            self.pending = pending

        def result(self):
            out = np.array(self.pending.result())
            if fault == "altered":
                out[:, 0] += 0.01 * np.sqrt(np.mean(out * out))
            else:
                out[out.shape[0] // 2:] = 0.0
            return out

    def faulty(self, images, *args, **kwargs):
        return Wrong(real(self, images, *args, **kwargs))

    monkeypatch.setattr(engine.InferenceEngine, "predict_async", faulty)
    code, result = run.run(SERVE, 8, 3.0, False, root=limited_root, device=CPU)
    assert code == 0 and result["correct"] is False


def test_the_open_loop_times_each_request_from_when_it_was_due():
    import concurrent.futures
    import time

    from benchmark.frozen import clients

    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        # each request takes 50 ms on one worker while they arrive every 10 ms: the queue grows,
        # and the latency from due time counts the wait a submission-time clock would hide
        arrivals, _ = clients.open_loop(lambda r: pool.submit(time.sleep, 0.05), range(6), [0.01] * 6)
    finally:
        pool.shutdown()
    waits = [a.done - a.due for a in arrivals]
    assert all(a.error is None and a.sent >= a.due for a in arrivals)
    assert waits[-1] > 0.2 and waits == sorted(waits)

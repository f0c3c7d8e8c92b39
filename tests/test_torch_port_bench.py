"""The port's benches (``bench/``), on the CPU: each prints one JSON line;
``--device cpu`` rehearses it (``cpu_rehearsal: true``, device metrics
null); asking for the card without one gives an ``error`` line and a
non-zero exit; the serve bench's refused arms and its open-loop arm; the
latency table against the JAX package's keys, loaded by both packages'
``nas/latency.py`` and turned into a penalty; ``trace_ops`` on a
synthetic and on a real CPU ``torch.profiler`` trace.
"""

import json

import numpy as np
import pytest

import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.config import PruneConfig as JaxPruneConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.nas import latency as jax_latency
from yet_another_mobilenet_series_tpu.nas import penalty as jax_penalty
from yet_another_mobilenet_series_tpu_torch.bench import first_steps, latency_table, serve_bench, trace_ops, train_bench
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, PruneConfig
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.nas import latency, penalty

TINY_TRAIN = ["--batch", "4", "--image-size", "32", "--width-mult", "0.35", "--num-classes", "10", "--steps", "2",
              "--warmup", "1", "--profile-steps", "1"]
TINY_SERVE = ["--arch", "tiny", "--image-sizes", "32", "--buckets", "1,2", "--iters", "3", "--rounds", "1",
              "--concurrent-iters", "1", "--ab-iters", "2", "--fuse-ladder", "2", "--fused-iters", "2",
              "--structural-rounds", "1", "--quant-iters", "1", "--quant-rounds", "1", "--quant-top1-min", "0.5",
              "--chaos-requests", "60", "--chaos-qps", "300"]
TINY_TABLE = ["--arch", "atomnas_supernet", "--width-mult", "0.35", "--image-sizes", "32", "--widths", "0.5,1.0",
              "--batch", "2", "--iters", "1"]


def _run(main, argv, capsys):
    rc = main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines  # one JSON line on stdout
    return rc, json.loads(lines[0])


def _rehearsal(out):
    assert out["platform"] == "cpu" and out["cpu_rehearsal"] is True and "error" not in out, out.get("error")
    prov = out["provenance"]
    assert prov["cpu_rehearsal"] is True and prov["device_name"] == "cpu" and prov["torch_version"] == torch.__version__


def test_train_bench_cpu_rehearsal(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    rc, out = _run(train_bench.main, ["--device", "cpu", *TINY_TRAIN, "--trace-out", str(trace)], capsys)
    assert rc == 0
    _rehearsal(out)
    for key in train_bench.DEVICE_METRICS:
        assert out[key] is None, key
    assert out["step_macs"] == 3 * out["model_fwd_macs"] * 4
    assert out["timed_steps"] == 2 and np.isfinite(out["loss"])
    assert out["tf32_cudnn"] is True and out["compute_dtype"] == "bfloat16"
    assert out["profile"]["device_busy_share"] is None and trace.exists()
    # the float32 run turns TF32 off, as cli/train.py does
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        rc, out = _run(train_bench.main, ["--device", "cpu", *TINY_TRAIN, "--dtype", "float32",
                                          "--profile-steps", "0"], capsys)
        assert rc == 0 and out["tf32_cudnn"] is False and out["tf32_matmul"] is False
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_train_bench_macs_are_the_profilers(capsys):
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

    rc, out = _run(train_bench.main, ["--device", "cpu", *TINY_TRAIN, "--profile-steps", "0"], capsys)
    net = get_model(ModelConfig(arch="mobilenet_v3_large", width_mult=0.35, num_classes=10), 32)
    assert rc == 0 and out["model_fwd_macs"] == profile_network(net, 32).total_macs


@pytest.mark.parametrize("name", ["H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_mfu_peak_is_the_data_sheets_or_null(name):
    peak, why = train_bench.peak_flops(name, "bfloat16")
    if name == "H100 80GB HBM3":
        assert peak == 989e12 and why is None
        assert train_bench.peak_flops(name, "float32") == (67e12, None)
    else:
        assert peak is None and name in why


@pytest.mark.parametrize("bench,argv", [
    (train_bench, TINY_TRAIN),
    (serve_bench, TINY_SERVE),
    (latency_table, TINY_TABLE),
    (trace_ops, ["missing_trace.json"]),
    (first_steps, ["--steps", "1"]),
])
def test_bench_without_a_card_fails_with_an_error_line(bench, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out = _run(bench.main, argv, capsys)
    assert rc != 0 and out["value"] is None
    assert "torch.cuda.is_available() is False" in out["error"]
    assert out["provenance"]["cpu_rehearsal"] is False and out["provenance"]["device_name"] == "cpu"


@pytest.mark.parametrize("flag,item", [("--overload", "S7"), ("--partition", "S7")])
def test_serve_bench_refuses_the_multi_model_and_fleet_arms(flag, item, capsys):
    rc, out = _run(serve_bench.main, ["--device", "cpu", *TINY_SERVE, flag], capsys)
    assert rc != 0 and out["value"] is None
    assert out["error"].startswith("ValueError") and item in out["error"] and flag in out["error"]


def test_serve_bench_zoo_arm_cpu_rehearsal(capsys):
    rc, out = _run(serve_bench.main, ["--device", "cpu", "--zoo", "--arch", "tiny", "--image-sizes", "32",
                                      "--zoo-requests", "12"], capsys)
    assert rc == 0
    _rehearsal(out)
    zoo = out["zoo"]
    cascade, big_only = zoo["arms"]["cascade"], zoo["arms"]["big_only"]
    assert zoo["models"]["small"]["weights"] == "int8" and zoo["models"]["big"]["weights"] == "float32"
    assert big_only["bitwise_match_big"] and zoo["arms"]["sharded"]["bitwise_match"]
    assert zoo["arms"]["sharded"]["misroutes"] == 0
    assert cascade["escalations"] > 0 and cascade["answered_small"] > 0 and cascade["answer_mismatches"] == 0
    assert all(a["unresolved"] == 0 and a["failed"] == 0 for a in zoo["arms"].values())
    # a ratio of counted FLOPs stands on the CPU; the times are null
    assert 0 < out["value"] == zoo["cost"]["cascade_vs_big_only"] < 1
    assert big_only["flops_per_request"] == zoo["models"]["big"]["flops_per_image"]
    # the threshold comes from a calibration set apart from the trace: the
    # ratio follows the trace's measured escalations
    assert zoo["calib_images"] == serve_bench.ZOO_CALIB_IMAGES
    assert zoo["margins"]["below_threshold"] == cascade["escalations"]
    small_f, big_f = zoo["models"]["small"]["flops_per_image"], zoo["models"]["big"]["flops_per_image"]
    assert cascade["flops_per_request"] == pytest.approx(small_f + cascade["escalation_rate"] * big_f, rel=1e-9)
    assert cascade["qps"] is None and cascade["p99_ms"] is None and zoo["spawn_s"] is None


def test_serve_bench_fleet_arm_cpu_rehearsal(capsys):
    rc, out = _run(serve_bench.main, ["--device", "cpu", "--fleet", "--arch", "tiny", "--image-sizes", "32",
                                      "--buckets", "1,4", "--fleet-requests", "10", "--fleet-phase-s", "0.5,1.5,0.5"],
                   capsys)
    assert rc == 0
    _rehearsal(out)
    fleet = out["fleet"]
    rounds = [fleet["hedge_ab"]["unhedged"], fleet["hedge_ab"]["hedged"], fleet["kill"], fleet["obs"]["round"],
              *fleet["autoscale"]["phases"]]
    assert all(r["unresolved"] == 0 and r["failed"] == 0 for r in rounds)
    assert fleet["kill"]["chaos_kills"] == 1 and fleet["kill"]["restarts"] >= 1
    assert fleet["kill"]["replicas_after_restart"] == 2 and fleet["obs"]["p99_match"]
    assert out["metric"] == "tiny_fleet_hedged_p99_ms" and "offered_qps" in out and "400 ms" in out["unit"]
    assert out["value"] is None and fleet["hedge_ab"]["unhedged"]["p99_ms"] is None


def test_serve_bench_cpu_rehearsal_runs_every_single_model_arm(capsys):
    rc, out = _run(serve_bench.main, ["--device", "cpu", *TINY_SERVE], capsys)
    assert rc == 0
    _rehearsal(out)
    assert out["arms"] == list(serve_bench.ARMS)
    assert out["value"] is None and out["peak_qps"] is None  # no CPU number under a device metric
    assert all(r["qps"] is None and r["p99_ms"] is None for r in out["direct"])
    assert [(r["batch"], r["image_size"]) for r in out["direct"]] == [(1, 32), (2, 32)]
    ab = out["ab"]
    assert ab["bf16_vs_fp32"]["parity_ok"] is True and ab["bf16_vs_fp32"]["parity_atol"] == 0.35
    fused = ab["fused_vs_chained"]
    assert all(r["bitwise_ok"] for r in fused["per_k"])
    assert [r["dispatches_per_request_fused"] for r in fused["per_k"] if r["on_ladder"]] == [1.0]
    sweep = ab["structural_sweep"]
    assert sweep["bitwise_ok"] is True and sweep["ring_probe"]["bitwise_ok"] is True
    assert sweep["ring_probe"]["dispatch_seconds_count_delta"] == 1
    assert sweep["modes"]["ring"]["ring_windows"] >= 1 and sweep["modes"]["sync"]["dispatches_per_wakeup"] is None
    assert sweep["modes"]["pipelined"]["dispatched_gflops"] > 0
    quant = ab["quant"]
    assert quant["parity"]["identity_norm_bitwise"] is True and quant["parity"]["wire_parity_ok"] is True
    assert quant["wire_bytes_ratio"] == 4.0
    assert out["k1_launches"]["total"] == 0  # the CPU runs the kernel's plain version


def test_serve_bench_open_loop_resolves_every_request(capsys):
    rc, out = _run(serve_bench.main, ["--device", "cpu", *TINY_SERVE, "--arms", "chaos", "--chaos-requests", "80",
                                      "--chaos-qps", "200,400", "--chaos-fault-rate", "0.2"], capsys)
    assert rc == 0
    chaos = out["chaos"]
    assert len(chaos["rounds"]) == 2
    for rnd in chaos["rounds"]:
        for kind in ("healthy", "faulty"):
            r = rnd[kind]
            assert r["unresolved"] == 0 and r["requests"] == 80
            total = r["classes"]["all"]
            assert total["submitted"] == 80
            assert total["completed"] + total["rejected"] + total["shed"] + total["failed"] == 80
            assert total["samples"] == total["completed"]
            assert sum(r["classes"][c]["submitted"] for c in serve_bench.CHAOS_CLASS_MIX) == 80
        assert rnd["faulty"]["injected_failures"] + rnd["faulty"]["injected_delays"] > 0
        assert rnd["healthy"]["injected_failures"] == 0


def test_latency_table_loads_in_both_packages_and_builds_a_penalty(tmp_path, capsys):
    path = tmp_path / "LATENCY_TABLE.json"
    rc, out = _run(latency_table.main, ["--device", "cpu", *TINY_TABLE, "--out", str(path)], capsys)
    assert rc == 0
    _rehearsal(out)
    assert out["timer"].startswith("host clock")
    jnet = jax_get_model(JaxModelConfig(arch="atomnas_supernet", width_mult=0.35), 32)
    sizes = jax_latency.block_input_sizes(jnet, 32)
    want = {jax_latency.block_key(b, sizes[i]) for i, b in enumerate(jnet.blocks)}
    assert {e["key"] for e in out["entries"]} == want and out["value"] == len(want)
    for e in out["entries"]:
        assert len(e["alive_channels"]) == 2 and e["alive_channels"][1] == e["expanded_channels"]
        assert all(v > 0 for v in e["latency_s"]) and e["cost_flops"][0] < e["cost_flops"][1]
    pnet = get_model(ModelConfig(arch="atomnas_supernet", width_mult=0.35), 32)
    jcost, jtotal = jax_latency.LatencyTable.load(str(path)).atom_cost_table(jnet)
    pcost, ptotal = latency.LatencyTable.load(str(path)).atom_cost_table(pnet)
    assert ptotal == jtotal > 0 and set(pcost) == set(jcost)
    for i in pcost:
        np.testing.assert_array_equal(pcost[i], jcost[i])
    pcfg = PruneConfig(enable=True, cost="latency_table", latency_table=str(path))
    ptable = penalty.atom_cost_table(pnet, pcfg)
    jtable = jax_penalty.atom_cost_table(jnet, JaxPruneConfig(enable=True, cost="latency_table",
                                                              latency_table=str(path)))
    assert set(ptable) == set(jtable) and ptable
    for i in ptable:
        np.testing.assert_allclose(np.asarray(ptable[i]), np.asarray(jtable[i]), rtol=1e-6)
    fn = penalty.make_penalty_fn(pnet, pcfg, 10, device="cpu")
    params, _ = pnet.init(torch.Generator().manual_seed(0))
    assert float(fn(params, None)) > 0


def _synthetic_trace():
    """Two streams' kernels overlapping in time, a copy, host ops: 100 us of
    window, device busy 0-30 and 40-70 = 60 us."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_conv", "ts": 0.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "void fused_dw_kernel<float>", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 40.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512>", "ts": 50.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "void fused_dw_kernel<float>", "ts": 60.0, "dur": 5.0},
        {"ph": "i", "cat": "instant", "name": "marker", "ts": 5.0},
    ]
    return {"traceEvents": ev, "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}]}


def test_trace_ops_on_a_synthetic_trace(tmp_path, capsys):
    agg = trace_ops.aggregate(_synthetic_trace())
    assert agg["device"] and agg["window_us"] == 100.0 and agg["busy_us"] == 60.0 and agg["busy_share"] == 0.6
    assert agg["per_name"]["void fused_dw_kernel<float>"] == 25.0 and agg["counts"]["void fused_dw_kernel<float>"] == 2
    assert agg["per_kind"] == {"convolutions and matmuls": 20.0, "K1 fused depthwise": 25.0, "copies and casts": 10.0,
                               "reductions": 20.0}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_synthetic_trace()))
    table = tmp_path / "table.json"
    table.write_text(json.dumps({"entries": [{"key": "a", "alive_channels": [4, 8], "latency_s": [1e-6, 2e-6]}],
                                 "provenance": {"device_name": "x"}}))
    rc, out = _run(trace_ops.main, [str(path), "--device", "cpu", "--steps", "1", "--images", "2",
                                    "--check-table", str(table)], capsys)
    assert rc == 0 and out["busy_share"] == 0.6 and out["value"] == 0.6
    assert out["top"][0]["name"] == "void fused_dw_kernel<float>" and out["events_per_step"] == 5
    assert out["trace_device_names"] == ["NVIDIA H100 80GB HBM3"]
    assert out["latency_table"]["blocks_total_ms"] == pytest.approx(2e-3)
    assert out["device_ms_per_image"] == pytest.approx(0.0375)


def test_trace_ops_on_a_cpu_profiler_trace(tmp_path, capsys):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (a @ a).relu().sum()
    path = tmp_path / "cpu_trace.json"
    prof.export_chrome_trace(str(path))
    rc, out = _run(trace_ops.main, [str(tmp_path), "--device", "cpu"], capsys)
    assert rc == 0 and out["trace"] == "cpu_trace.json"
    assert out["device_events"] is False and out["busy_share"] is None and out["value"] is None
    assert "host ops" in out["by_kind"] and any("aten::mm" in r["name"] for r in out["top"])


def test_latency_table_search_runs_through_a_rebuild(tmp_path, capsys):
    """A search with prune.cost=latency_table through the port's CLI, with a
    rematerialization mid-run: the rebuilt Trainer keeps each surviving
    atom's measured cost. The JAX package looks the shrunk blocks up in the
    table and raises KeyError (ROADMAP queue 3, F2): pinned here too."""
    import os

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.nas import rematerialize

    path = tmp_path / "LATENCY_TABLE.json"
    rc, _ = _run(latency_table.main, ["--device", "cpu", *TINY_TABLE, "--out", str(path)], capsys)
    assert rc == 0
    app = os.path.join(os.path.dirname(latency.__file__), "..", "apps", "atomnas_a_search.yml")
    cfg = parse_cli([f"app:{app}", "dist.num_devices=1", "data.dataset=fake", "model.width_mult=0.35",
                     "data.image_size=32", "model.num_classes=10", "train.batch_size=8", "data.fake_train_size=16",
                     "data.fake_eval_size=8", "train.eval_batch_size=8", "train.epochs=2", "train.log_every=2",
                     "prune.mask_interval=1", "prune.remat_epochs=1", "prune.gamma_threshold=1.0",
                     "prune.target_flops=1.2e6", "prune.cost=latency_table", f"prune.latency_table={path}",
                     f"train.log_dir={tmp_path / 'run'}"])
    summary = train_cli.run(cfg, device="cpu")
    remats = summary["remats"]
    assert summary["finite_steps"] == summary["steps"] == 4
    assert remats[0]["step"] == 2 and remats[0]["atoms_after"] < remats[0]["atoms_before"]
    assert all(np.isfinite(row["penalty"]) and row["penalty"] > 0 for row in summary["log"])
    # the surviving atoms keep their costs, sliced
    pnet = get_model(cfg.model, 32)
    trainer = train_cli.Trainer(cfg, pnet, "cpu")
    params, state = pnet.init(torch.Generator().manual_seed(0))
    masks = {k: torch.ones(v.size) for k, v in trainer.atom_costs.items()}
    k0 = sorted(masks, key=int)[0]
    masks[k0][::2] = 0.0
    new_net, *_, report = rematerialize.rematerialize(pnet, params, state, masks)
    sliced = train_cli._sliced_costs(trainer.atom_costs, masks, report)
    np.testing.assert_array_equal(sliced[str(report.index_map[int(k0)])], trainer.atom_costs[k0][1::2])
    assert set(sliced) == {str(report.index_map[int(k)]) for k in trainer.atom_costs}
    # the reference's fault: the shrunk block has no table entry
    jnet = jax_get_model(JaxModelConfig(arch="atomnas_supernet", width_mult=0.35, num_classes=10), 32)
    jcfg = JaxPruneConfig(enable=True, cost="latency_table", latency_table=str(path))
    import dataclasses

    shrunk = dataclasses.replace(jnet, blocks=tuple(
        dataclasses.replace(b, expanded_channels=new_net.blocks[report.index_map[i]].expanded_channels,
                            group_channels=new_net.blocks[report.index_map[i]].group_channels)
        if i == int(k0) else b for i, b in enumerate(jnet.blocks)))
    with pytest.raises(KeyError, match="no latency measurement"):
        jax_penalty.atom_cost_table(shrunk, jcfg)


def test_first_steps_cpu_rehearsal(tmp_path, capsys):
    rc, out = _run(first_steps.main, ["--device", "cpu", "--batch", "4", "--image-size", "32", "--steps", "1",
                                      "--override", "model.width_mult=0.35", "--override", "model.num_classes=10",
                                      "--override", "prune.target_flops=1.2e6", "--trace-dir", str(tmp_path)], capsys)
    assert rc == 0
    _rehearsal(out)
    assert list(out["windows"]) == ["first", "steady", "after_rebuild", "after_steady"]
    assert all(w["step_s"] is None and w["steps"] == 1 and np.isfinite(w["loss"]) for w in out["windows"].values())
    assert out["rebuild"]["atoms_after"] < out["rebuild"]["atoms_before"] and out["value"] is None
    assert sorted(p.name for p in tmp_path.glob("first_steps_*.json")) == [
        "first_steps_after_rebuild.json", "first_steps_after_steady.json", "first_steps_first.json",
        "first_steps_steady.json"]

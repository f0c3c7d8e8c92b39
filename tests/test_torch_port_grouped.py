"""The port's grouped train step (parallel/dp.py ``make_grouped_train_step``)
and the data-parallel knobs of its training CLI (cli/train.py), on the CPU.

On the CPU the grouped step runs its K steps eagerly (a CUDA graph needs a
card), so it equals K single steps bit for bit: plainly, with mixup (the
generator advances as K single steps advance it) and with the prune event
inside; the plain one is also held against the JAX package's grouped step.
The CLI runs the grouped dispatch loop, the replica check, and a world of
two gloo ranks started by ``run()`` itself, whose ranks report the same
metrics and whose checkpoint resumes at one rank and back.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.nas import masking, penalty
from yet_another_mobilenet_series_tpu_torch.parallel import dp, make_mesh
from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

from test_torch_port_trainer import _cfg

K = 2
FIELDS = ("params", "state", "opt_state", "ema_params", "ema_state", "masks", "rho_mult")
TINY_SPECS = [
    {"t": 2, "c": 8, "n": 1, "s": 2},
    {"t": 2, "c": 16, "n": 1, "s": 1, "k": [3, 5], "se": 0.25, "act": "hswish"},
]
SEARCH_SPECS = [
    {"t": 6, "c": 8, "n": 2, "s": 2, "k": [3, 5]},
    {"t": 6, "c": 12, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
]


def _plain_dict(**optim_extra):
    return {
        "model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0, "block_specs": TINY_SPECS},
        "optim": {"optimizer": "rmsprop", "weight_decay": 1e-5, **optim_extra},
        "schedule": {"schedule": "constant", "base_lr": 0.01, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": True, "decay": 0.9, "warmup": False},
        "train": {"compute_dtype": "float32"},
    }


def _search_dict():
    # tests/test_nas.py's grouped search: events at steps 2 and 4, seeded
    # gammas below the threshold so that atoms die at them
    return {
        "model": {"arch": "atomnas_supernet", "num_classes": 4, "dropout": 0.0, "block_specs": SEARCH_SPECS},
        "optim": {"optimizer": "sgd", "weight_decay": 0.0},
        "schedule": {"schedule": "constant", "base_lr": 0.05, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": False},
        "train": {"compute_dtype": "float32"},
        "prune": {"enable": True, "rho": 1e-4, "mask_interval": 2, "gamma_threshold": 0.12, "target_flops": 1.0,
                  "rho_schedule": "adaptive", "rho_adapt_rate": 0.05},
    }


def _batches(n, batch=8, size=16, seed=20):
    out = []
    for i in range(n):
        rs = np.random.RandomState(seed + i)
        out.append({"image": torch.from_numpy(rs.normal(0, 1, (batch, size, size, 3)).astype(np.float32)),
                    "label": torch.from_numpy(((np.arange(batch) + i) % 4).astype(np.int32))})
    return out


def _port(d, seed=0):
    cfg = config_from_dict(d)
    net = get_model(cfg.model, image_size=16)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, 8, 1, 100)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(seed), device="cpu")
    pen = penalty.make_penalty_fn(net, cfg.prune, device="cpu") if cfg.prune.enable else None
    event = masking.make_prune_event(net, cfg.prune, stop_step=100, device="cpu") if cfg.prune.enable else None
    return cfg, net, steps.make_train_step(net, cfg, opt, lr_fn, penalty_fn=pen), event, ts


def _singles(step, event, ts, batches, gen, interval=2):
    out = []
    for b in batches:
        ts, m = step(ts, b, gen)
        if event is not None and int(ts.step) % interval == 0:  # the CLI's host gate
            masks, rho = event(ts.params, ts.masks, ts.rho_mult, ts.step)
            ts = ts.replace(masks=masks, rho_mult=rho)
        out.append(m)
    return ts, out


def _grouped(step, event, ts, batches, gen):
    grouped = dp.make_grouped_train_step(step, K, event, mesh=make_mesh("cpu"))
    assert grouped.mode == "eager (cpu)"
    out = []
    for i in range(0, len(batches), K):
        ts, ms = grouped(ts, batches[i: i + K], gen)
        out += ms
    return ts, out


def _assert_equal_states(a, b):
    for field in FIELDS:
        va, vb = getattr(a, field), getattr(b, field)
        if va is None or isinstance(va, torch.Tensor):
            assert (va is None and vb is None) or torch.equal(va, vb), field
            continue
        fa, fb = convert.flatten_tree(va), convert.flatten_tree(vb)
        assert fa.keys() == fb.keys(), field
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (field, k)
    assert int(a.step) == int(b.step)


def test_grouped_step_equals_single_steps():
    """Two groups of K=2 against four single steps, bit for bit on the CPU;
    and against the JAX package's grouped step from the same weights at its
    20-step trajectory bar (tests/test_torch_port_step.py: |diff| / (1 +
    |JAX|) below 5e-6; measured here 3.9e-7)."""
    import jax
    import jax.numpy as jnp

    from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
    from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
    from yet_another_mobilenet_series_tpu.parallel import dp as jdp, mesh as jmesh
    from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
    from test_torch_port_step import _diffs, _numpy_params

    d = _plain_dict()
    cfg, net, step, _, _ = _port(d)
    jc = jax_config_from_dict(d)
    jnet = jax_get_model(jc.model, image_size=16)
    jlr = jsched.make_lr_schedule(jc.schedule, 8, 1, 100)
    params = _numpy_params(jnet, 0)
    jopt = joptim.make_optimizer(jc.optim, jlr, params)
    jts = jsteps.init_train_state(jnet, jc, jopt, jax.random.PRNGKey(0))
    jts = jts.replace(params=params, opt_state=jopt.init(params), ema_params=jax.tree.map(jnp.copy, params))
    ts0 = convert.train_state_from_jax(jts)
    batches = _batches(4)
    single, ms = _singles(step, None, ts0, batches, torch.Generator().manual_seed(3))
    grouped, mg = _grouped(step, None, ts0, batches, torch.Generator().manual_seed(3))
    _assert_equal_states(single, grouped)
    assert [float(m["loss"]) for m in ms] == [float(m["loss"]) for m in mg]

    mesh = jmesh.make_mesh(1)
    jgrouped = jdp.make_grouped_train_step(jdp.make_dp_train_step(jnet, jc, jopt, jlr, mesh), K)
    jts = jmesh.replicate(jts, mesh)
    for i in range(0, 4, K):
        bs = tuple(jmesh.shard_batch({k: jnp.asarray(v.numpy()) for k, v in b.items()}, mesh)
                   for b in batches[i: i + K])
        jts, jm = jgrouped(jts, bs, jax.random.PRNGKey(0))
    assert max(_diffs(jax.device_get(jts), grouped).values()) < 5e-6
    np.testing.assert_allclose(float(mg[-1]["loss"]), float(jm[-1]["loss"]), rtol=1e-5)
    with pytest.raises(ValueError, match="k >= 2"):
        dp.make_grouped_train_step(step, 1)


def test_grouped_step_with_mixup_draws_what_single_steps_draw():
    """In-step Mixup/CutMix draws from the step generator: K grouped steps
    advance it as K single steps do, so the mixes, and the states, are the
    same (tests/test_parallel.py's mixup composition pin)."""
    cfg, net, step, _, ts0 = _port(_plain_dict(mixup_alpha=0.2, cutmix_alpha=1.0))
    batches = _batches(4, seed=40)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    single, ms = _singles(step, None, ts0, batches, g1)
    grouped, mg = _grouped(step, None, ts0, batches, g2)
    _assert_equal_states(single, grouped)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert [float(m["loss"]) for m in ms] == [float(m["loss"]) for m in mg]


def test_grouped_search_step_equals_singles():
    """The prune event after every grouped sub-step (its own step gate makes
    the off-cadence ones no-ops) against the CLI's host-gated event after
    single steps: masks, rho_mult and every other field bit for bit, and
    atoms died inside the groups (tests/test_nas.py's grouped search)."""
    cfg, net, step, event, ts0 = _port(_search_dict())
    p = convert.flatten_tree(ts0.params)
    p["blocks/0/dw_bn/gamma"] = p["blocks/0/dw_bn/gamma"].clone()
    p["blocks/0/dw_bn/gamma"][1:4] = 0.01
    ts0 = ts0.replace(params=convert.unflatten_tree(p))
    batches = _batches(4, seed=60)
    single, _ = _singles(step, event, ts0, batches, torch.Generator())
    grouped, _ = _grouped(step, event, ts0, batches, torch.Generator())
    _assert_equal_states(single, grouped)
    summary = masking.mask_summary(net, grouped.masks)
    assert summary["alive_atoms"] < summary["total_atoms"]
    assert float(grouped.rho_mult) != 1.0


def test_grouped_step_over_gloo_runs_eagerly(tmp_path):
    """A gloo group's collectives cannot be captured in a CUDA graph: the
    grouped step over one says it runs eagerly (a world of one here)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = make_mesh("cpu", dist.group.WORLD)
        cfg, net, step, _, ts0 = _port(_plain_dict())
        grouped = dp.make_grouped_train_step(step, K, mesh=mesh)
        assert grouped.mode == "eager (gloo collectives are not capturable)"
        lr_fn = schedules.make_lr_schedule(cfg.schedule, 8, 1, 100)
        dp_step = dp.make_dp_train_step(net, cfg, optim.make_optimizer(cfg.optim, lr_fn, ts0.params), lr_fn, mesh)
        one, _ = step(ts0, _batches(1)[0], torch.Generator())
        world, _ = dp_step(ts0, _batches(1)[0], torch.Generator())
        _assert_equal_states(one, world)  # a sum over one rank and a division by 1 are exact
        assert float(dp.make_replica_sync_check(mesh)(world.params)) == 0.0
    finally:
        dist.destroy_process_group()


def test_cli_grouped_dispatch_equals_single_steps(tmp_path):
    """cli/train.py with train.steps_per_dispatch=4 over epochs of 6 steps
    (a group of 4, then two single steps) and the replica check every 2
    steps, against the same run dispatched step by step: the same log rows
    and eval, and every check 0.0 (one process)."""
    single = train_cli.run(_cfg(tmp_path / "a", "train.epochs=2"), device="cpu")
    grouped = train_cli.run(_cfg(tmp_path / "b", "train.epochs=2", "train.steps_per_dispatch=4",
                                 "train.param_checksum_every=2"), device="cpu")
    assert grouped["grouped"] == {"k": 4, "mode": "eager (cpu)"}
    assert grouped["log"][0]["grouped_k"] == 4.0 and grouped["log"][0]["grouped_graph"] == 0.0
    assert [r["step"] for r in grouped["replica_checks"]] == [2, 4, 6, 8, 10, 12]
    assert all(r["divergence"] == 0.0 for r in grouped["replica_checks"])
    keys = ("loss", "grad_norm", "top1", "lr")
    assert [[r[k] for k in keys] for r in single["log"]] == [[r[k] for k in keys] for r in grouped["log"]]
    assert single["eval_loss"] == grouped["eval_loss"] and grouped["step"] == 12


def test_cli_grouped_search_equals_single_steps(tmp_path):
    """The search through cli/train.py grouped (the event inside the groups,
    the epoch tail's single steps with the host-gated one) and step by step:
    the same searched architecture and log rows."""
    search = ["prune.enable=true", "model.arch=atomnas_supernet", "prune.mask_interval=2",
              "prune.gamma_threshold=1.0", "prune.target_flops=1.0", "prune.remat_epochs=1", "train.epochs=2"]
    a = train_cli.run(_cfg(tmp_path / "a", *search), device="cpu")
    b = train_cli.run(_cfg(tmp_path / "b", *search, "train.steps_per_dispatch=4"), device="cpu")
    assert a["searched"]["macs"] == b["searched"]["macs"] and a["remats"] == b["remats"]
    assert [r["loss"] for r in a["log"]] == [r["loss"] for r in b["log"]]
    assert b["searched"]["macs"] < a["remats"][0]["macs_before"]


def test_cli_two_ranks_report_the_same_metrics_and_resume_at_one(tmp_path):
    """dist.num_devices=2 on the CPU: run() starts two gloo ranks, which
    report the same log rows and eval (SyncBN, averaged gradients and
    metrics, summed eval counts), with the ZeRO update and the replica
    check on; rank 0 alone writes the checkpoint, which a run of one rank
    resumes to the end (2 -> 1; 1 -> 2 is tests/test_torch_port_parallel.py's
    checkpoint test)."""
    extra = ["dist.shard_optimizer=true", "optim.grad_clip_norm=1.0", "train.param_checksum_every=1"]
    two = train_cli.run(_cfg(tmp_path, "dist.num_devices=2", "train.epochs=0.5", *extra), device="cpu")
    r0, r1 = two["ranks"]
    assert (r0["rank"], r1["rank"], r0["world"], two["rank"]) == (0, 1, 2, 0)

    def rows(r):
        return [{k: v for k, v in row.items() if "images_per_sec" not in k} for row in r["log"]]

    assert rows(r0) == rows(r1) and len(rows(r0)) == 1
    assert r0["eval_loss"] == r1["eval_loss"] and r0["eval_n"] == r1["eval_n"] == 20
    assert [c["divergence"] for c in r0["replica_checks"]] == [0.0, 0.0, 0.0]
    assert r0["checkpoints"] == [3] and sorted(os.listdir(tmp_path / "log" / "ckpt")) == ["3", "digests.json"]
    one = train_cli.run(_cfg(tmp_path, "dist.num_devices=1", *extra), device="cpu")
    assert one["resumed_from"] == 3 and one["step"] == 6 and one["world"] == 1 and one["finite_steps"] == 3


def test_data_parallel_asks_for_what_it_needs(tmp_path, monkeypatch):
    """Two cards where there are none raise (the port never runs quietly at
    a world of one); dist.multihost without torchrun's rendezvous raises;
    train() of one process refuses a world it would have to start."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            train_cli.run(_cfg(tmp_path, "dist.num_devices=2"), device="cuda")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="env://"):
        train_cli.run(_cfg(tmp_path, "dist.multihost=true"), device="cpu")
    with pytest.raises(ValueError, match="world of 2"):
        train_cli.train(_cfg(tmp_path, "dist.num_devices=2"), device="cpu")

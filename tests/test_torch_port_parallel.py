"""The port's data parallel (parallel/mesh.py, dp.py, zero.py, the SyncBN of
ops/layers.py and the group-aware steps of train/steps.py) against the JAX
package's, on the CPU.

The port's ranks are two gloo processes on this machine, started once for
the module; the JAX side is a 2-device CPU mesh (tests/conftest.py forces 8
host devices). Both start from one TrainState, the JAX package's with
weights made by numpy from a seed and carried across by models/convert.py,
and take one global batch of GLOBAL images, rank r (device r) holding rows
r*GLOBAL/2 on. Dropout and drop_path are at rate 0, so no random draw
differs. Params and BN state after one step are held to the repository's
float32 bar, rtol 1e-4 and atol 1e-5.
"""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.parallel import (dp, local_batch_slice, make_mesh, prefetch_to_mesh,
                                                              replicate, shard_batch, zero)
from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

RTOL, ATOL = 1e-4, 1e-5  # the repository's float32 bar
IMAGE = 16
GLOBAL = 8
WORLD = 2
TINY_SPECS = [
    {"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
    {"t": 3, "c": 16, "n": 2, "s": 2},
]


def _cfg_dict(bn_mode="exact", sync_bn=True, shard=False, clip=0.0):
    # num_classes 5: odd leaves, which the ZeRO shards pad
    return {
        "model": {"arch": "mobilenet_v2", "num_classes": 5, "dropout": 0.0, "block_specs": TINY_SPECS},
        "optim": {"optimizer": "rmsprop", "weight_decay": 1e-5, "grad_clip_norm": clip},
        "schedule": {"schedule": "constant", "base_lr": 0.02, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": True, "decay": 0.9, "warmup": False},
        "train": {"compute_dtype": "float32", "bn_mode": bn_mode, "batch_size": GLOBAL},
        "dist": {"sync_bn": sync_bn, "shard_optimizer": shard},
    }


SCENARIOS = {
    "exact": _cfg_dict("exact"),
    "fused_vjp": _cfg_dict("fused_vjp"),
    "no_sync_bn": _cfg_dict("exact", sync_bn=False),
    # the clip engages (the first step's grad norm is about 2)
    "zero": _cfg_dict("exact", shard=True, clip=0.5),
}


def _batch():
    rs = np.random.RandomState(1)
    return {"image": rs.normal(0, 1, (GLOBAL, IMAGE, IMAGE, 3)).astype(np.float32),
            "label": (np.arange(GLOBAL) % 5).astype(np.int32)}


def _port_pieces(d, group=None):
    cfg = config_from_dict(d)
    net = get_model(cfg.model, image_size=IMAGE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, GLOBAL, 1, 100)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0],
                               shard_group=group if cfg.dist.shard_optimizer else None)
    return cfg, net, lr_fn, opt


def _rows(batch, rank):
    local = GLOBAL // WORLD
    return {k: torch.from_numpy(v[rank * local: (rank + 1) * local]) for k, v in batch.items()}


def _worker(rank: int, init_method: str, work: str) -> None:
    """One gloo rank: every scenario's DP step, the replica check, the eval
    counts and a ZeRO checkpoint; the results go to ``rank<r>.pt``."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=WORLD)
    mesh = make_mesh("cpu", dist.group.WORLD)
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    batch = setup["batch"]
    out = {}
    for name, d in SCENARIOS.items():
        cfg, net, lr_fn, opt = _port_pieces(d, mesh.group)
        ts = steps.train_state_from_dict(setup["ts"])
        if cfg.dist.shard_optimizer:
            ts = ts.replace(opt_state=zero.init_opt_state(opt, ts.params, mesh))
        step = dp.make_dp_train_step(net, cfg, opt, lr_fn, mesh, clip_shard_aware=cfg.dist.shard_optimizer)
        new, m = step(ts, _rows(batch, rank), dp.rank_generator(0, mesh))
        if cfg.dist.shard_optimizer:
            zero_live = new.opt_state
            new = new.replace(opt_state=zero.gather_opt_state(new.opt_state, new.params, mesh))
        out[name] = {"ts": steps.train_state_to_dict(new), "metrics": {k: float(v) for k, v in m.items()}}
    # replicate: rank 0's values of a tree that differs per rank, each dtype
    mixed = {"f": torch.full((3,), float(rank + 1)), "i": {"n": torch.tensor([rank, 7], dtype=torch.int32)}}
    out["replicated"] = replicate(mixed, mesh)
    check = dp.make_replica_sync_check(mesh)
    params = out["exact"]["ts"]["params"]
    out["check"] = float(check(params))
    drifted = convert.unflatten_tree({k: v.clone() for k, v in convert.flatten_tree(params).items()})
    if rank == 1:
        w = drifted["classifier"]["b"]
        w[3] = torch.nextafter(w[3], torch.tensor(float("inf")))
    out["check_drift"] = float(check(drifted))
    cfg, net, _, _ = _port_pieces(SCENARIOS["exact"])
    evals = dp.make_dp_eval_step(net, cfg, mesh)
    ts = out["exact"]["ts"]
    out["eval"] = {k: float(v) for k, v in evals(ts["params"], ts["state"], _rows(batch, rank), {}).items()}
    # a checkpoint of the ZeRO run, written by rank 0 alone, then restored
    # at this world's size: each rank's shards are the ones it held
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry

    cfg, net, _, opt = _port_pieces(SCENARIOS["zero"], mesh.group)
    saves0 = get_registry().counter("ckpt.saves").value
    mgr = CheckpointManager(os.path.join(work, "ckpt"), group=mesh.group)
    zts = steps.train_state_from_dict(out["zero"]["ts"])
    mgr.save(1, net, zts)
    mgr.wait()
    restored = mgr.restore_tree(1, steps.train_state_to_dict(zts))
    mgr.close()
    out["ckpt_saves"] = get_registry().counter("ckpt.saves").value - saves0
    mine = zero.scatter_opt_state(restored["opt_state"], mesh)
    # the padding past a leaf's end is 0 in a scattered shard, and holds
    # what the update made of it in a live one: compare the leaf's elements
    sizes = {k: v.numel() for k, v in convert.flatten_tree(zts.params).items()}
    equal = torch.equal(mine["count"], zero_live["count"])
    for name in ("nu", "trace"):
        for k, a in convert.flatten_tree(mine[name]).items():
            real = min(max(sizes[k] - rank * a.numel(), 0), a.numel())
            equal = equal and torch.equal(a[:real], convert.flatten_tree(zero_live[name])[k][:real])
    out["ckpt_shards_equal"] = equal
    # a checkpoint written by one process (setup), restored by both ranks
    # and cut to their shards: put back together, it is the saved state
    mgr = CheckpointManager(os.path.join(work, "ckpt_world1"), group=mesh.group)
    tree = mgr.restore_tree(1, steps.train_state_to_dict(zts))
    mgr.close()
    back = zero.gather_opt_state(zero.scatter_opt_state(tree["opt_state"], mesh), zts.params, mesh)
    out["world1_restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        convert.flatten_tree(back).values(), convert.flatten_tree(tree["opt_state"]).values()))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(target, work, world=WORLD):
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target, args=(r, init, str(work))) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    for p in procs:
        p.join(timeout=240)
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * len(procs), [p.exitcode for p in procs]


def _jax_steps(mesh, jax_parts, batch):
    """One JAX DP step per scenario on the 2-device mesh."""
    import jax
    import jax.numpy as jnp

    from yet_another_mobilenet_series_tpu.parallel import dp as jdp, mesh as jmesh, zero as jzero

    jb = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    out = {}
    for name, (jc, jnet, jlr, jopt, jts) in jax_parts.items():
        shard = jc.dist.shard_optimizer
        template = jax.device_get(jts.opt_state)
        live = jmesh.replicate(jax.tree.map(jnp.copy, jts), mesh)  # the step donates its input
        if shard:
            live = live.replace(opt_state=jzero.init_opt_state(jopt, live.params, mesh))
        step = jdp.make_dp_train_step(jnet, jc, jopt, jlr, mesh, clip_shard_aware=shard)
        new, m = step(live, jb, jax.random.PRNGKey(7))
        new = jax.device_get(new)
        if shard:
            new = new.replace(opt_state=jax.device_get(jax.jit(jzero.gather_opt_state)(new.opt_state, new.params)))
        out[name] = {"ts": new, "metrics": {k: float(v) for k, v in m.items()}, "opt_template": template}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX package's one DP step per scenario on a 2-device mesh, and the
    port's two gloo ranks running every scenario from the same initial
    state (started first: they run while the JAX steps compile)."""
    import jax
    import jax.numpy as jnp

    from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
    from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
    from yet_another_mobilenet_series_tpu.parallel import mesh as jmesh
    from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
    from test_torch_port_step import _numpy_params

    jax_parts = {}
    for name, d in SCENARIOS.items():
        jc = jax_config_from_dict(d)
        jnet = jax_get_model(jc.model, image_size=IMAGE)
        jlr = jsched.make_lr_schedule(jc.schedule, GLOBAL, 1, 100)
        params = _numpy_params(jnet, 0)
        jopt = joptim.make_optimizer(jc.optim, jlr, params,
                                     shard_axis=jmesh.DATA_AXIS if jc.dist.shard_optimizer else None)
        jts = jsteps.init_train_state(jnet, jc, jopt, jax.random.PRNGKey(0))
        jts = jts.replace(params=params, opt_state=jopt.init(params), ema_params=jax.tree.map(jnp.copy, params))
        jax_parts[name] = (jc, jnet, jlr, jopt, jts)
    work = tmp_path_factory.mktemp("dp")
    pts = convert.train_state_from_jax(jax.device_get(jax_parts["exact"][4]))
    batch = _batch()
    torch.save({"ts": steps.train_state_to_dict(pts), "batch": batch}, work / "setup.pt")
    # a checkpoint of one process, in the ZeRO run's form (params-shaped
    # optimizer state), for the ranks to restore at a world of two
    cfg, net, _, _ = _port_pieces(SCENARIOS["zero"])
    mgr = CheckpointManager(str(work / "ckpt_world1"))
    mgr.save(1, net, pts)
    mgr.close()
    procs = _start(_worker, work)
    try:
        refs = _jax_steps(jmesh.make_mesh(WORLD), jax_parts, batch)
    finally:
        _join(procs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "jax": refs, "work": work, "pts": pts}


def _jax_layout(port_ts: dict, jax_ref) -> dict:
    return convert.train_state_to_jax(steps.train_state_from_dict(port_ts), jax_ref["opt_template"])


def _assert_close(got: dict, want, fields=("params", "state")):
    import jax

    for field in fields:
        a = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, getattr(want, field) if not isinstance(want, dict)
                                                   else want[field]))
        b = jax.tree_util.tree_leaves(got[field])
        assert len(a) == len(b), field
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=RTOL, atol=ATOL, err_msg=field)


@pytest.mark.parametrize("scenario", ["exact", "fused_vjp", "no_sync_bn"])
def test_dp_step_matches_jax(world, scenario):
    """One DP step of the two ranks against the JAX package's
    make_dp_train_step on 2 devices: params and BN state at the float32
    bar, the averaged metrics alike, and both ranks bit for bit equal."""
    r0, r1 = world["ranks"]
    ref = world["jax"][scenario]
    _assert_close(_jax_layout(r0[scenario]["ts"], ref), ref["ts"])
    for k in ("loss", "grad_norm", "top1", "lr"):
        np.testing.assert_allclose(r0[scenario]["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
    for a, b in zip(convert.flatten_tree(r0[scenario]["ts"]["params"]).values(),
                    convert.flatten_tree(r1[scenario]["ts"]["params"]).values()):
        assert torch.equal(a, b)
    assert r0[scenario]["metrics"] == r1[scenario]["metrics"]


def test_dp_step_matches_one_process_at_the_global_batch(world):
    """SyncBN over two ranks of GLOBAL/2 rows is BN over GLOBAL rows: the
    port's DP step equals its one-process step at the global batch."""
    r0, pts = world["ranks"][0], world["pts"]
    batch = _batch()
    for scenario in ("exact", "fused_vjp"):
        cfg, net, lr_fn, opt = _port_pieces(SCENARIOS[scenario])
        new, m = steps.make_train_step(net, cfg, opt, lr_fn)(
            pts, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
        got = r0[scenario]["ts"]
        for field in ("params", "state", "ema_params"):
            for k, v in convert.flatten_tree(getattr(new, field)).items():
                torch.testing.assert_close(convert.flatten_tree(got[field])[k], v, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r0[scenario]["metrics"]["loss"], float(m["loss"]), rtol=1e-6)


def test_no_sync_bn_keeps_rank_zero_running_statistics(world):
    """dist.sync_bn=false: each rank normalizes with its own statistics, and
    both keep rank 0's running statistics: the BN state equals the one
    process step's on rank 0's rows, while the weights follow the gradient
    averaged over both ranks' rows."""
    (r0, r1), pts = world["ranks"], world["pts"]
    cfg, net, lr_fn, opt = _port_pieces(SCENARIOS["no_sync_bn"])
    new, _ = steps.make_train_step(net, cfg, opt, lr_fn)(pts, _rows(_batch(), 0), torch.Generator())
    for k, v in convert.flatten_tree(new.state).items():
        torch.testing.assert_close(convert.flatten_tree(r0["no_sync_bn"]["ts"]["state"])[k], v, rtol=0, atol=0)
        assert torch.equal(convert.flatten_tree(r1["no_sync_bn"]["ts"]["state"])[k], v)
    synced = convert.flatten_tree(r0["exact"]["ts"]["state"])
    assert any(not torch.allclose(synced[k], v) for k, v in convert.flatten_tree(new.state).items())


def test_zero_update_matches_jax(world):
    """dist.shard_optimizer with the clip engaged, on leaves that do not
    divide by 2 (num_classes 5): params, BN state and the gathered optimizer
    state against the JAX package's ZeRO update, and the clip's global norm
    summed over the shards (the grad norm metric)."""
    r0, r1 = world["ranks"]
    ref = world["jax"]["zero"]
    got = _jax_layout(r0["zero"]["ts"], ref)
    _assert_close(got, ref["ts"], fields=("params", "state", "opt_state"))
    np.testing.assert_allclose(r0["zero"]["metrics"]["grad_norm"], ref["metrics"]["grad_norm"], rtol=1e-5)
    assert r0["zero"]["metrics"]["grad_norm"] > 0.5  # the clip engaged
    assert r0["zero"]["metrics"] == r1["zero"]["metrics"]


def test_zero_pads_ragged_leaves():
    """The shard layout of a size that does not divide by the world: each
    rank's chunk is ceil(size / n) rounded up to ALIGN, the padding is 0,
    and the shards of every rank put back together are the leaf."""
    x = torch.arange(1, 8, dtype=torch.float32)  # 7 elements
    shards = [zero.shard_params_local({"x": x}, r, 2)["x"] for r in range(2)]
    assert shards[0].numel() == zero._chunk(7, 2) == 16
    assert torch.equal(torch.cat(shards)[:7], x) and not torch.cat(shards)[7:].any()
    assert zero._chunk(64, 2) == 32 and zero._chunk(1, 4) == 16


def test_replica_check_reads_zero_then_a_planted_drift(world):
    """Identical replicas read exactly 0.0; one ulp added to one element of
    one leaf on rank 1 reads that ulp, on both ranks."""
    r0, r1 = world["ranks"]
    assert r0["check"] == r1["check"] == 0.0
    b = r0["exact"]["ts"]["params"]["classifier"]["b"][3]
    ulp = float(torch.nextafter(b, torch.tensor(float("inf"))) - b)
    assert r0["check_drift"] == r1["check_drift"] == pytest.approx(ulp, rel=1e-6) and ulp > 0


def test_eval_counts_are_summed_over_the_ranks(world):
    """The eval step's counts over the two ranks' halves, summed by the
    group, equal one process's counts over the whole batch."""
    r0, r1 = world["ranks"]
    cfg, net, _, _ = _port_pieces(SCENARIOS["exact"])
    ts = r0["exact"]["ts"]
    one = steps.make_eval_step(net, cfg)(ts["params"], ts["state"],
                                         {k: torch.from_numpy(v) for k, v in _batch().items()}, {})
    assert r0["eval"] == r1["eval"]
    for k in ("top1", "top5", "n"):
        assert r0["eval"][k] == float(one[k])
    assert r0["eval"]["n"] == GLOBAL
    np.testing.assert_allclose(r0["eval"]["loss_sum"], float(one["loss_sum"]), rtol=1e-6)


def test_zero_checkpoint_written_once_and_restored_at_world_1_and_2(world):
    """A ZeRO run's checkpoint: rank 0 alone writes it (its save counter
    moves, rank 1's does not); restored at world 2 each rank's scattered
    shards are the ones it held; restored at world 1 (this process, no
    group) the optimizer state is the gathered one, bit for bit. And a
    checkpoint of one process restores at world 2: its optimizer state,
    scattered to the ranks' shards and gathered back, is the saved one."""
    (r0, r1), work = world["ranks"], world["work"]
    assert (r0["ckpt_saves"], r1["ckpt_saves"]) == (1, 0)
    assert r0["ckpt_shards_equal"] and r1["ckpt_shards_equal"]
    assert r0["world1_restored_equal"] and r1["world1_restored_equal"]
    mgr = CheckpointManager(str(work / "ckpt"))
    assert mgr.all_steps() == [1]
    zts = steps.train_state_from_dict(r0["zero"]["ts"])
    tree = mgr.restore_tree(1, steps.train_state_to_dict(zts))
    mgr.close()
    one = make_mesh("cpu")
    assert zero.scatter_opt_state(tree["opt_state"], one)["nu"].keys() == zts.opt_state["nu"].keys()
    for a, b in zip(convert.flatten_tree(tree["opt_state"]).values(),
                    convert.flatten_tree(zts.opt_state).values()):
        assert torch.equal(a, b)


def test_grad_clip_with_zero_needs_a_shard_aware_optimizer():
    cfg, net, lr_fn, opt = _port_pieces(SCENARIOS["zero"])
    with pytest.raises(ValueError, match="shard_group"):
        dp.make_dp_train_step(net, cfg, opt, lr_fn, make_mesh("cpu"))


def test_replicate_broadcasts_rank_zero(world):
    r0, r1 = world["ranks"]
    for r in (r0, r1):
        assert torch.equal(r["replicated"]["f"], torch.full((3,), 1.0))
        assert torch.equal(r["replicated"]["i"]["n"], torch.tensor([0, 7], dtype=torch.int32))


def test_batch_slices_and_prefetch():
    """local_batch_slice keeps the JAX package's divisibility error; a rank
    holds rows rank*local on of each global batch; prefetch_to_mesh hands
    them over in order (on the CPU a plain copy) and refuses depth 0."""
    from yet_another_mobilenet_series_tpu_torch.parallel import Mesh

    mesh = Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    assert local_batch_slice(8, mesh) == 4
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        local_batch_slice(7, mesh)
    batches = [{"image": torch.arange(8.0) + 10 * i, "label": torch.arange(8)} for i in range(3)]
    assert torch.equal(shard_batch(batches[0], mesh)["image"], torch.arange(4.0, 8.0))
    got = list(prefetch_to_mesh(iter(batches), mesh, depth=2))
    assert [b["image"][0].item() for b in got] == [4.0, 14.0, 24.0]
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_mesh(iter(batches), mesh, depth=0)

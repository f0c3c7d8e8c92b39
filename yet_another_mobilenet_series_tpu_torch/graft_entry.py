"""Compile-check entry point of the port: the torch twin of ``entry()`` in
the repository's ``__graft_entry__.py``.

:func:`entry` returns ``(fn, example_args)`` for the bf16 eval forward of
MobileNetV3-Large 1.0, ``Network.apply(train=False,
compute_dtype=torch.bfloat16)``, with the weights and BN state of
``net.init`` from seed 0 and a zero batch of
``batch`` images at ``image_size``, on ``device`` (the card unless the
caller asks for the CPU). ``fn(*example_args)`` gives (batch, 1000) float32
logits.

:func:`dryrun_multichip` is the twin of the JAX package's data-parallel dry
run: two full AtomNAS training steps (SyncBN over the group, the gradient
all-reduce, the ZeRO update, EMA, the FLOPs-weighted penalty, the mask
refresh) in a world of ``n_devices`` ranks, one process per rank: NCCL
between cards, gloo between CPU processes when the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import queue as queue_lib

import numpy as np
import torch

from .config import ModelConfig, config_from_dict
from .models import get_model
from .utils.device import resolve_device

# the dry run's images: 32 x 32, a global batch of 2 per rank
DRYRUN_IMAGE_SIZE = 32
DRYRUN_TIMEOUT_S = 600


def entry(device: str | torch.device = "cuda", batch: int = 32, image_size: int = 224):
    """``(fn, (params, state, x))``: the bf16 eval forward of
    MobileNetV3-Large and its example arguments on ``device``."""
    dev = resolve_device(device)
    net = get_model(ModelConfig(arch="mobilenet_v3_large"), image_size=image_size)
    params, state = net.init(torch.Generator().manual_seed(0))

    def put(tree):
        return {k: put(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    def fwd(params, state, x):
        with torch.inference_mode():
            return net.apply(params, state, x, train=False, compute_dtype=torch.bfloat16)

    x = torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32, device=dev)
    return fwd, (put(params), put(state), x)


def _dryrun_config(n_devices: int):
    """The JAX dry run's config: the SE supernet with 16 classes and its two
    block specs, RMSProp, the exponential decay with a warm-up epoch, EMA,
    bf16, the prune search, SyncBN and the ZeRO update."""
    return config_from_dict({
        "model": {"arch": "atomnas_supernet_se", "num_classes": 16, "dropout": 0.1,
                  "block_specs": [{"t": 6, "c": 16, "n": 2, "s": 2, "k": [3, 5, 7], "se": 0.25},
                                  {"t": 6, "c": 24, "n": 1, "s": 2, "k": [3, 5, 7], "se": 0.25}]},
        "optim": {"optimizer": "rmsprop", "weight_decay": 1e-5},
        "schedule": {"schedule": "exp_decay", "base_lr": 0.064, "warmup_epochs": 1.0},
        "ema": {"enable": True},
        "train": {"compute_dtype": "bfloat16", "batch_size": 2 * n_devices},
        "prune": {"enable": True, "rho": 1e-4},
        "dist": {"sync_bn": True, "shard_optimizer": True},
    })


def _dryrun_rank(rank: int, world: int, init_method: str, device: str, results) -> None:
    """One rank of :func:`dryrun_multichip`: join the group, run the two
    steps and the mask refresh on its rows of the global batch, and report
    its step counts, finiteness and the replica check."""
    import torch.distributed as dist

    from .nas import masking, penalty
    from .ops.fused_depthwise import fused_depthwise
    from .parallel import dp, zero
    from .parallel import mesh as mesh_lib
    from .train import optim, schedules, steps

    try:
        mesh = mesh_lib.init_mesh(device, rank=rank, world=world, init_method=init_method)
        try:
            cfg = _dryrun_config(world)
            net = get_model(cfg.model, DRYRUN_IMAGE_SIZE)
            lr_fn = schedules.make_lr_schedule(cfg.schedule, cfg.train.batch_size, 10, 10)
            optimizer = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0],
                                             shard_group=mesh.group)
            ts = steps.init_train_state(net, cfg, optimizer, torch.Generator().manual_seed(0), device=mesh.device)
            ts = ts.replace(params=mesh_lib.replicate(ts.params, mesh), state=mesh_lib.replicate(ts.state, mesh))
            ts = ts.replace(opt_state=zero.init_opt_state(optimizer, ts.params, mesh))
            pen_fn = penalty.make_penalty_fn(net, cfg.prune, device=mesh.device)
            mask_update = masking.make_mask_update(net, cfg.prune)
            rs = np.random.RandomState(0)
            batch = mesh_lib.shard_batch({
                "image": torch.from_numpy(rs.normal(0, 1, (cfg.train.batch_size, DRYRUN_IMAGE_SIZE, DRYRUN_IMAGE_SIZE,
                                                           3)).astype(np.float32)),
                "label": torch.from_numpy((np.arange(cfg.train.batch_size) % cfg.model.num_classes).astype(np.int64)),
            }, mesh)
            out = {"rank": rank, "world": world, "backend": mesh.backend, "device": str(mesh.device), "steps": [],
                   "finite": [], "loss": []}
            # step 1 as configured, then the mask refresh; step 2 under the
            # fused BN backward, the 1x1 convs as matmuls and save_conv remat
            cfg_v = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, bn_mode="fused_vjp", conv1x1_dot=True, remat=True, remat_policy="save_conv"))
            for i, c in enumerate((cfg, cfg_v)):
                step = dp.make_dp_train_step(net, c, optimizer, lr_fn, mesh, penalty_fn=pen_fn, clip_shard_aware=True)
                ts, metrics = step(ts, batch, dp.rank_generator(i + 1, mesh))
                if i == 0:
                    ts = ts.replace(masks=mask_update(ts.params, ts.masks))
                out["steps"].append(int(ts.step))
                out["finite"].append(float(metrics["finite"]))
                out["loss"].append(float(metrics["loss"]))
            out["replica_check"] = float(dp.make_replica_sync_check(mesh)(ts.params))
            out["k1_launches"] = fused_depthwise.launches  # training runs no K1
            results.put(out)
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — reported to the parent, then re-raised
        results.put({"rank": rank, "error": f"{type(e).__name__}: {e}"})
        raise


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """Two full data-parallel AtomNAS training steps of the JAX dry run's
    config at 32 x 32 in a world of ``n_devices`` ranks, each a spawned
    process: NCCL on ``cuda:0`` .. ``cuda:n-1``, gloo on the CPU. Step 1
    runs as configured, then the masks refresh; step 2 runs with
    ``bn_mode=fused_vjp``, ``conv1x1_dot`` and remat at ``save_conv``.
    Raises unless every rank's steps count 1 then 2, every step is finite
    and the replicas agree; more ranks than cards raises before any spawn.
    Returns ``{"world", "backend", "ranks": [per-rank results]}``."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs n_devices >= 1, got {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards but only "
                           f"{torch.cuda.device_count()} are visible; pass device='cpu' for gloo ranks on the CPU")
    from .cli.train import _free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, init_method, dev.type, results),
                         name=f"dryrun-rank-{r}") for r in range(n_devices)]
    for p in procs:
        p.start()
    ranks: dict = {}
    failure = None
    try:
        while len(ranks) < n_devices and failure is None:
            try:
                res = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = next((p for p in procs if p.exitcode not in (None, 0)), None)
                if dead is not None:
                    failure = f"{dead.name} exited with code {dead.exitcode} before it reported"
                continue
            if "error" in res:
                failure = f"rank {res['rank']}: {res['error']}"
            else:
                ranks[res["rank"]] = res
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=DRYRUN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: {failure}")
    out = {"world": n_devices, "backend": ranks[0]["backend"], "ranks": [ranks[r] for r in range(n_devices)]}
    for r in out["ranks"]:
        if r["steps"] != [1, 2] or r["finite"] != [1.0, 1.0] or r["replica_check"] != 0.0:
            raise AssertionError(f"dryrun_multichip({n_devices}): rank {r['rank']} {r}")
    return out

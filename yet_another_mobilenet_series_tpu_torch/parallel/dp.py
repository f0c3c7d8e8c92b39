"""Data-parallel train and eval steps, the replica check and the grouped
step: the torch twin of ``yet_another_mobilenet_series_tpu/parallel/dp.py``.

The JAX package compiles one ``shard_map`` program per step. Here each rank
runs the port's eager step (``train/steps.py``) on its slice of the global
batch with its process group: the BN moments are summed over the group
(SyncBN), the gradients averaged in one bucketed all-reduce, or
reduce-scattered into the ZeRO update (``parallel/zero.py``), and the
metrics averaged, so every rank holds the same state after every step.

The grouped step (``train.steps_per_dispatch`` = K) runs K steps in one
dispatch. On a card it is ONE CUDA graph that captures the K steps, the
prune event after each: the host enqueues one replay where it enqueued a
few thousand kernels a step. Under gloo, which cannot be captured, and on
the CPU it runs the K steps eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..data.pipeline import stream_seed
from ..models.convert import flatten_tree, unflatten_tree
from ..train.guard import wrap_step_fn
from ..train.steps import TrainState, make_eval_step, make_train_step, train_state_from_dict, train_state_to_dict
from ..utils import collectives
from ..utils.device import resolve_device
from . import zero
from .mesh import Mesh

# the salt of a rank's step-generator seed (stream_seed)
RANK_SALT = 3


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """The step generator of this rank, on its device: rank 0's is seeded
    with ``seed`` (one process draws what it drew before data parallel),
    rank r's with a hash of (seed, r), so every rank draws its own dropout,
    drop-path and mixup noise (the JAX package folds ``axis_index`` into
    the step's key)."""
    s = seed if mesh.rank == 0 else stream_seed(RANK_SALT, seed, mesh.rank)
    return torch.Generator(device=mesh.device).manual_seed(s)


def make_dp_train_step(net, cfg, optimizer, lr_fn, mesh: Mesh, *, penalty_fn=None, clip_shard_aware: bool = False):
    """(ts, batch, generator) -> (ts, metrics) on this rank's slice of the
    batch, over ``mesh``'s group. With ``dist.shard_optimizer`` the update
    is ZeRO's and ``ts.opt_state`` this rank's shard (``zero.init_opt_state``).
    With ``train.guard.enable`` the non-finite rollback wraps the step,
    collectives included: every rank reads the same averaged verdict."""
    sharded_update = None
    if cfg.dist.shard_optimizer:
        if cfg.optim.grad_clip_norm > 0 and not clip_shard_aware:
            # a plain clip inside the ZeRO update would clip each gradient
            # shard by its own norm (~global/sqrt(N))
            raise ValueError(
                "grad_clip_norm with shard_optimizer requires an optimizer built with "
                "make_optimizer(..., shard_group=mesh.group); pass clip_shard_aware=True to attest")
        sharded_update = zero.make_zero_update(optimizer, mesh)
    step = make_train_step(net, cfg, optimizer, lr_fn, penalty_fn=penalty_fn, group=mesh.group,
                           sharded_update=sharded_update)
    return wrap_step_fn(step) if cfg.train.guard.enable else step


def make_dp_eval_step(net, cfg, mesh: Mesh):
    """(params, state, batch, masks) -> the counts summed over the group."""
    return make_eval_step(net, cfg, group=mesh.group)


def make_replica_sync_check(mesh: Mesh):
    """Returns check(tree) -> 0-dim float32 tensor: the max over leaves of
    max |leaf_r - leaf_0| over the ranks r, elementwise, per leaf: exactly
    0.0 when every rank holds rank 0's bits. A summed checksum would round a
    one-leaf drift away among millions of weights. Each rank compares its
    leaves, cast to float32, with rank 0's (one broadcast of a bucket) and
    the ranks take the maximum (one all-reduce). Every rank must call it;
    on one process it is 0."""

    def check(tree) -> torch.Tensor:
        leaves = [v.float() for v in ([tree] if isinstance(tree, torch.Tensor) else flatten_tree(tree).values())]
        if mesh.group is None:
            return torch.zeros((), device=leaves[0].device)
        mine = collectives.pack(leaves)
        first = mine.clone()
        dist.broadcast(first, src=collectives.first_rank(mesh.group), group=mesh.group)
        worst = (mine - first).abs().max()
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=mesh.group)
        return worst

    return check


def _leaves(ts: TrainState) -> tuple[list[str], list[torch.Tensor]]:
    flat = {k: v for k, v in flatten_tree(train_state_to_dict(ts)).items() if v is not None}
    return list(flat), list(flat.values())


def _rebuild(template: TrainState, keys: list[str], tensors: list[torch.Tensor]) -> TrainState:
    flat = flatten_tree(train_state_to_dict(template))
    flat.update(zip(keys, tensors))
    return train_state_from_dict(unflatten_tree(flat))


class GroupedStep:
    """K sequential steps in one dispatch: ``grouped(ts, batches, generator)
    -> (ts, [metrics_0 .. metrics_{K-1}])``, each batch consumed in place,
    in order, with the generator advanced as K single steps advance it.

    ``mode`` is "cuda graph" or "eager (<why>)". In a graph:

    - the first call warms the K steps up on a side stream (kernel loading,
      cuDNN's choice, the NCCL communicator, the allocator) on copies of the
      state, puts the generator back where it was, and captures them with
      the generator registered with the graph, so each replay draws fresh
      numbers and K grouped steps draw what K single steps draw;
    - the graph reads its static state and batches and ends by copying the
      K-th step's state into the static state: the TrainState it returns
      is that static state, rewritten in place by the next replay (the
      caller drops the old one, as the training loop does). A state that
      is not the static one is copied in first;
    - the metrics of the K steps are one (K, M) static tensor, cloned after
      each replay, so the ones returned survive the next replay;
    - a replay makes no host sync.
    """

    def __init__(self, step_fn, k: int, event_fn=None, *, graph: bool = True, why_eager: str = ""):
        if k < 2:
            raise ValueError(f"grouped step needs k >= 2, got {k}")
        self.step_fn, self.k, self.event_fn = step_fn, k, event_fn
        self._allow_graph = graph
        self._graph = None
        self.mode = "cuda graph" if graph else f"eager ({why_eager})"

    def _run(self, ts: TrainState, batches, generator):
        out = []
        for b in batches:
            ts, metrics = self.step_fn(ts, b, generator)
            if self.event_fn is not None:
                masks, rho_mult = self.event_fn(ts.params, ts.masks, ts.rho_mult, ts.step)
                ts = ts.replace(masks=masks, rho_mult=rho_mult)
            out.append(metrics)
        return ts, out

    def __call__(self, ts: TrainState, batches, generator):
        if len(batches) != self.k:
            raise ValueError(f"grouped step of k={self.k} got {len(batches)} batches")
        if not (self._allow_graph and ts.step.device.type == "cuda"):
            if self._allow_graph:
                self.mode = "eager (the state is not on a card)"
            return self._run(ts, batches, generator)
        if self._graph is None:
            self._capture(ts, batches, generator)
        keys, leaves = _leaves(ts)
        if keys != self._keys:
            raise ValueError("the grouped step's graph was captured for another TrainState layout; rebuild it")
        if any(a.data_ptr() != b.data_ptr() for a, b in zip(leaves, self._static)):
            torch._foreach_copy_(self._static, leaves)
        for static, b in zip(self._batches, batches):
            torch._foreach_copy_([static[name] for name in self._batch_keys], [b[name] for name in self._batch_keys])
        self._graph.replay()
        rows = self._metrics.clone()
        metrics = [dict(zip(self._metric_keys, row.unbind(0))) for row in rows.unbind(0)]
        return _rebuild(ts, keys, self._static), metrics

    def _capture(self, ts: TrainState, batches, generator) -> None:
        dev = ts.step.device
        self._keys, leaves = _leaves(ts)
        self._static = [t.clone() for t in leaves]
        self._batch_keys = sorted(batches[0])
        self._batches = [{name: b[name].clone() for name in self._batch_keys} for b in batches]
        static_ts = _rebuild(ts, self._keys, self._static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            saved = generator.get_state()
            self._run(static_ts, self._batches, generator)
            generator.set_state(saved)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=side,
                              capture_error_mode="thread_local"):
            out_ts, metrics = self._run(static_ts, self._batches, generator)
            _, out_leaves = _leaves(out_ts)
            torch._foreach_copy_(self._static, out_leaves)
            self._metric_keys = list(metrics[0])
            self._metrics = torch.stack([torch.stack([m[name].float() for name in self._metric_keys])
                                         for m in metrics])
        self._graph = graph


def make_grouped_train_step(step_fn, k: int, event_fn=None, *, mesh: Mesh | None = None) -> GroupedStep:
    """ONE dispatch of ``k`` sequential train steps (the JAX package's
    ``make_grouped_train_step``), with ``event_fn`` (``nas/masking.py``'s
    prune event, gated on the device by its own step test) after every
    sub-step, so a search's mask cadence is that of k single steps. On a
    card it is one CUDA graph; over a gloo group, whose collectives a graph
    cannot capture, and on the CPU it runs the k steps eagerly."""
    backend = None if mesh is None else mesh.backend
    if backend == "gloo":
        return GroupedStep(step_fn, k, event_fn, graph=False, why_eager="gloo collectives are not capturable")
    if mesh is not None and resolve_device(mesh.device).type != "cuda":
        return GroupedStep(step_fn, k, event_fn, graph=False, why_eager="cpu")
    return GroupedStep(step_fn, k, event_fn)

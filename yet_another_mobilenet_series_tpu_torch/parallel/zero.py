"""Cross-replica sharding of the weight update (PAPERS.md:5,
arXiv:2004.13336), the ZeRO-style option on top of data parallelism: the
torch twin of ``yet_another_mobilenet_series_tpu/parallel/zero.py``.

Instead of every rank applying the same optimizer update to every weight,
each rank updates a 1/N shard:

  grads --reduce_scatter / N--> this rank's shard of the averaged gradients
  the hand-written optimizer (train/optim.py) updates this rank's shard of
    the weights; its accumulators live sharded (memory / N)
  new shards --all_gather--> every rank holds every weight again

Layout: each leaf is flattened and zero-padded to N shards of ``_chunk``
elements (a multiple of ``collectives.ALIGN``), and the leaves' shards sit
side by side in one buffer per rank, so one ``reduce_scatter_tensor`` and
one ``all_gather_into_tensor`` move every leaf. The padding's gradient is 0,
so it adds nothing to the norm and its weights stay 0.

The optimizer state's canonical form is params-shaped and replicated:
checkpoints hold it so (a run saved at one world size resumes at any other)
and a rematerialization slices it like the weights. The sharded form, a
tree of (chunk,) leaves, lives only inside a running world
(:func:`gather_opt_state` / :func:`scatter_opt_state`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.convert import flatten_tree, unflatten_tree
from ..train.optim import apply_updates, global_norm
from ..utils.collectives import ALIGN


def _chunk(total: int, n: int) -> int:
    """Elements of one rank's shard of a leaf of ``total`` elements:
    ceil(total / n), rounded up to a multiple of ALIGN."""
    per_rank = -(-total // n)
    return -(-per_rank // ALIGN) * ALIGN


def _pad_flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """(total,) -> (n*chunk,), zero-padded."""
    flat = x.reshape(-1)
    return F.pad(flat, (0, n * _chunk(flat.numel(), n) - flat.numel()))


def shard_params_local(params, idx: int, n: int):
    """Rank ``idx``'s (chunk,) shard of every leaf of ``params``."""
    def shard(p):
        c = _chunk(p.numel(), n)
        return _pad_flat(p, n)[idx * c: (idx + 1) * c]

    return unflatten_tree({k: shard(v) for k, v in flatten_tree(params).items()})


def _side_by_side(leaves: list[torch.Tensor], n: int) -> torch.Tensor:
    """(n, sum of chunks): row r holds rank r's shard of every leaf."""
    return torch.cat([_pad_flat(t, n).view(n, -1) for t in leaves], dim=1)


def _split(row: torch.Tensor, like: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    return list(row.split([_chunk(t.numel(), n) for t in like]))


def _gather_full(shards: list[torch.Tensor], like: list[torch.Tensor], group, n: int) -> list[torch.Tensor]:
    """Every rank's shards of each leaf, reassembled into the leaf's shape."""
    mine = torch.cat(shards)
    if group is None:
        full = mine.view(1, -1)
    else:
        full = torch.empty(n * mine.numel(), dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(full, mine, group=group)
        full = full.view(n, -1)
    out = []
    for piece, t in zip(full.split([_chunk(t.numel(), n) for t in like], dim=1), like):
        out.append(piece.reshape(-1)[: t.numel()].view(t.shape).to(t.dtype))
    return out


def make_zero_update(optimizer, mesh):
    """Returns update(grads_local, opt_state_shard, params) ->
    (new_params, new_opt_state_shard, global_grad_norm), the step's
    ``sharded_update``. ``grads_local`` are this rank's UN-averaged
    gradients: the mean is the reduce-scatter's sum over the world divided
    by its size. The optimizer must clip by the global norm
    (``make_optimizer(..., shard_group=mesh.group)``)."""
    n, group, rank = mesh.size, mesh.group, mesh.rank

    def update(grads, opt_state_sh, params):
        flat_p = flatten_tree(params)
        keys = list(flat_p)
        flat_g = flatten_tree(grads)
        p_list = [flat_p[k] for k in keys]
        g_all = _side_by_side([flat_g[k] for k in keys], n)
        if group is None:
            g_row = g_all[0]
        else:
            g_row = torch.empty(g_all.shape[1], dtype=g_all.dtype, device=g_all.device)
            dist.reduce_scatter_tensor(g_row, g_all.reshape(-1), group=group)
            g_row = g_row / n
        g_sh = _split(g_row, p_list, n)
        p_sh = _split(_side_by_side(p_list, n)[rank], p_list, n)
        updates, new_opt_sh = optimizer.update(unflatten_tree(dict(zip(keys, g_sh))), opt_state_sh,
                                               unflatten_tree(dict(zip(keys, p_sh))))
        new_sh = flatten_tree(apply_updates(unflatten_tree(dict(zip(keys, p_sh))), updates))
        new_params = _gather_full([new_sh[k] for k in keys], p_list, group, n)
        sq = torch.square(global_norm(g_sh))
        if group is not None:
            dist.all_reduce(sq, group=group)
        return unflatten_tree(dict(zip(keys, new_params))), new_opt_sh, torch.sqrt(sq)

    return update


def init_opt_state(optimizer, params, mesh):
    """This rank's sharded optimizer state for ``params``."""
    return optimizer.init(shard_params_local(params, mesh.rank, mesh.size))


def gather_opt_state(opt_state_sh: dict, params, mesh) -> dict:
    """Sharded -> params-shaped and replicated (a collective: every rank
    calls it). The params-shaped items are the state's dicts; ``count``
    and any other tensor stay as they are."""
    flat_p = flatten_tree(params)
    keys = list(flat_p)
    like = [flat_p[k] for k in keys]
    out = {}
    for name, value in opt_state_sh.items():
        if isinstance(value, dict):
            flat = flatten_tree(value)
            full = _gather_full([flat[k] for k in keys], like, mesh.group, mesh.size)
            out[name] = unflatten_tree(dict(zip(keys, full)))
        else:
            out[name] = value
    return out


def scatter_opt_state(opt_state_gathered: dict, mesh) -> dict:
    """Params-shaped -> this rank's shards, at this world's size (any)."""
    return {name: shard_params_local(value, mesh.rank, mesh.size) if isinstance(value, dict) else value
            for name, value in opt_state_gathered.items()}

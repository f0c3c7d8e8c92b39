"""The optimizer, written by hand: the torch twin of
``yet_another_mobilenet_series_tpu/train/optim.py`` (an optax chain there).

The chain, in order, as the JAX package builds it:

1. ``clip_by_global_norm`` when ``grad_clip_norm > 0``; built with
   ``shard_group`` (the ZeRO update, ``parallel/zero.py``, hands it this
   rank's shard of every gradient) it sums the squared norm over the
   group's ranks, so every shard is clipped by the global norm;
2. coupled L2 weight decay, ``g + wd * p``, on the leaves ``wd_mask``
   selects (torch ``weight_decay=`` semantics, not AdamW-decoupled);
3. the optimizer:
   - ``rmsprop``, TF-style: ``nu`` starts at 1, ``nu = d*nu + (1-d)*g²`` is
     updated before it normalizes, eps sits inside the sqrt
     (``g / sqrt(nu + eps)``); then, when ``rmsprop_tf_momentum_order``,
     the LR is scaled in before the heavy-ball trace (``mom = m*mom +
     lr*g/sqrt(nu+eps)``, so each contribution keeps the LR of its step),
     else the trace comes first and the LR last (torch's RMSprop order);
   - ``sgd``: the heavy-ball trace (``buf = m*buf + g``), then the LR;
   - ``adamw``: optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8,
     bias-corrected), then the LR.

The LR is read from the optimizer's own step count, as optax's
``scale_by_learning_rate`` keeps one, so the state carries ``count`` beside
``nu``/``trace`` (``mu`` for adamw). Every transform runs over all leaves at
once with ``torch._foreach_*`` ops: one step is a few dozen launches, not
one per tensor per operation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed

from ..config import OptimConfig
from ..models.convert import flatten_tree, unflatten_tree


def wd_mask(params, cfg: OptimConfig):
    """True = apply weight decay. Walks the param tree by key names: BN
    params live under '*_bn'/'bn' subtrees with leaves gamma/beta; biases are
    leaves named 'b'; depthwise kernels live under 'dw*' subtrees."""

    def mask_tree(tree, path=()):
        if isinstance(tree, dict):
            return {k: mask_tree(v, path + (k,)) for k, v in tree.items()}
        leaf_name = path[-1] if path else ""
        in_bn = any(p == "bn" or p.endswith("_bn") for p in path)
        in_dw = any(p.startswith("dw") and not p.endswith("_bn") for p in path)
        if cfg.wd_skip_bn and (in_bn or leaf_name in ("gamma", "beta")):
            return False
        if cfg.wd_skip_bias and leaf_name == "b":
            return False
        if cfg.wd_skip_depthwise and in_dw:
            return False
        return True

    return mask_tree(params)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, a 0-dim f32 tensor."""
    return torch.linalg.vector_norm(torch.stack([n.float() for n in torch._foreach_norm(tensors)]))


def clip_by_global_norm(tensors: list[torch.Tensor], max_norm: float, group=None) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: scale by min(1, max_norm / norm).
    With ``group`` the tensors are shards and the squared norm is summed
    over the group's ranks (the JAX package's ``psum_axis``)."""
    norm = global_norm(tensors)
    if group is not None:
        sq = torch.square(norm)
        torch.distributed.all_reduce(sq, group=group)
        norm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-16), 1.0)
    return list(torch._foreach_mul(tensors, scale))


def _moment(buf: list, g: list, decay: float, power: int) -> list:
    """``decay * buf + (1 - decay) * g**power`` over lists."""
    out = list(torch._foreach_mul(buf, decay))
    torch._foreach_add_(out, torch._foreach_mul(g, g) if power == 2 else g, alpha=1.0 - decay)
    return out


def _trace(buf: list, g: list, decay: float) -> list:
    """optax's ``trace``: ``g + decay * buf`` (becomes the update and the buffer)."""
    out = list(torch._foreach_mul(buf, decay))
    torch._foreach_add_(out, g)
    return out


class Optimizer:
    """optax's interface over trees of tensors: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, new_state)``; apply the
    updates with :func:`apply_updates`. The state is a dict: ``count`` (0-dim
    int32) and the trees the chain keeps (``nu``, ``trace``, ``mu``)."""

    def __init__(self, cfg: OptimConfig, lr_fn: Callable, params_example, shard_group=None):
        if cfg.optimizer not in ("rmsprop", "sgd", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.lr_fn = lr_fn
        self.shard_group = shard_group
        mask = flatten_tree(wd_mask(params_example, cfg))
        self._decayed = {k for k, v in mask.items() if v}

    def _buffers(self) -> dict[str, float]:
        """The trees the state keeps, with their initial value."""
        cfg = self.cfg
        if cfg.optimizer == "rmsprop":
            return {"nu": 1.0, **({"trace": 0.0} if cfg.momentum > 0 else {})}
        if cfg.optimizer == "sgd":
            return {"trace": 0.0} if cfg.momentum > 0 else {}
        return {"mu": 0.0, "nu": 0.0}

    def init(self, params) -> dict:
        flat = flatten_tree(params)
        device = next(iter(flat.values())).device
        state = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        for name, value in self._buffers().items():
            state[name] = unflatten_tree({k: torch.full_like(v, value) for k, v in flat.items()})
        return state

    def update(self, grads, state: dict, params):
        cfg = self.cfg
        flat_p = flatten_tree(params)
        keys = list(flat_p)
        flat_g = flatten_tree(grads)
        g = [flat_g[k] for k in keys]
        bufs = {}
        for name in self._buffers():
            flat = flatten_tree(state[name])
            bufs[name] = [flat[k] for k in keys]
        count = state["count"]
        if cfg.grad_clip_norm > 0:
            g = clip_by_global_norm(g, cfg.grad_clip_norm, self.shard_group)
        if cfg.weight_decay > 0:
            idx = [i for i, k in enumerate(keys) if k in self._decayed]
            if idx:
                decayed = torch._foreach_add([g[i] for i in idx], [flat_p[keys[i]] for i in idx],
                                             alpha=cfg.weight_decay)
                for i, t in zip(idx, decayed):
                    g[i] = t
        neg_lr = -self.lr_fn(count)
        new = {}
        lr_applied = False
        if cfg.optimizer == "rmsprop":
            new["nu"] = _moment(bufs["nu"], g, cfg.rmsprop_decay, 2)
            den = list(torch._foreach_add(new["nu"], cfg.rmsprop_eps))
            torch._foreach_sqrt_(den)
            g = list(torch._foreach_div(g, den))
            if cfg.momentum > 0:
                if cfg.rmsprop_tf_momentum_order:
                    g = list(torch._foreach_mul(g, neg_lr))
                    lr_applied = True
                g = new["trace"] = _trace(bufs["trace"], g, cfg.momentum)
        elif cfg.optimizer == "sgd":
            if cfg.momentum > 0:
                g = new["trace"] = _trace(bufs["trace"], g, cfg.momentum)
        else:  # adamw
            b1, b2, eps = 0.9, 0.999, 1e-8
            new["mu"] = _moment(bufs["mu"], g, b1, 1)
            new["nu"] = _moment(bufs["nu"], g, b2, 2)
            t = (count + 1).to(torch.float32)
            mu_hat = torch._foreach_div(new["mu"], 1.0 - torch.pow(b1, t))
            den = list(torch._foreach_div(new["nu"], 1.0 - torch.pow(b2, t)))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            g = list(torch._foreach_div(mu_hat, den))
        if not lr_applied:
            g = list(torch._foreach_mul(g, neg_lr))
        new_state = {"count": count + 1}
        for name, buf in new.items():
            new_state[name] = unflatten_tree(dict(zip(keys, buf)))
        return unflatten_tree(dict(zip(keys, g))), new_state


def make_optimizer(cfg: OptimConfig, lr_fn: Callable, params_example, *, shard_group=None) -> Optimizer:
    """``shard_group``: the process group whose ranks each update a shard
    of the gradients (``dist.shard_optimizer``), so that the clip sums the
    global norm over it instead of clipping each shard by its own."""
    return Optimizer(cfg, lr_fn, params_example, shard_group)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf (one ``_foreach`` launch); new tensors."""
    flat_p, flat_u = flatten_tree(params), flatten_tree(updates)
    keys = list(flat_p)
    out = torch._foreach_add([flat_p[k] for k in keys], [flat_u[k] for k in keys])
    return unflatten_tree(dict(zip(keys, out)))

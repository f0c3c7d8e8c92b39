"""Carry weights across between the JAX package's trees and the port's.

Both packages key parameters by the same nested-dict paths; flattened with
``/`` they are the keys of a bundle's ``weights.npz`` (``serve/export.py``
``flatten_tree``), so one file serves both. Only the layouts differ:

| Weight    | JAX layout          | Port layout                               |
| --------- | ------------------- | ----------------------------------------- |
| conv      | HWIO (k, k, I, O)   | OIHW (O, I, k, k) — PyTorch's             |
| depthwise | (k, k, 1, C)        | (C, 1, k, k); the kernel's (k, k, C) copy  |
|           |                     | is made once by :func:`depthwise_taps`    |
| Dense     | (in, out)           | kept, used as ``x @ w``                   |
| vectors   | (C,)                | kept                                      |

:func:`train_state_from_jax` and :func:`train_state_to_jax` carry a whole
TrainState across: params, BN state, the optimizer's ``nu``/``trace``/``mu``
and ``count`` (out of and into optax's chain-state tuple, walked by its
field names, so this module needs neither JAX nor optax), the EMA shadows,
the AtomNAS masks and ``rho_mult``, and the step. The optimizer state of
a rematerialized network crosses the same way (its buffers are sliced to
the new shapes, its structure is unchanged), so the two packages' sliced
states compare leaf by leaf.

Every 4-D array of these trees is a conv weight (the int8 ``w_q`` of a
quantized bundle too, which keeps its dtype), so the mapping needs no key
names: :func:`from_jax` permutes HWIO -> OIHW (the inverse of the
JAX package's ``ckpt/torch_import.py`` ``_conv_w``) and :func:`to_jax` the
other way. Both work on unfolded ``(params, state)`` trees and on folded
serving trees alike.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': leaf}. '/' never appears in this codebase's
    param keys (block indices are plain digits), so the join is unambiguous."""
    out = {}
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"param key {k!r} contains '/'")
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """{'a/b/c': leaf} -> nested dict (the inverse of :func:`flatten_tree`)."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = v
    return out


def array_from_jax(a) -> torch.Tensor:
    """One JAX-layout array -> a port-layout CPU tensor: float32, or int8
    for the ``w_q`` of an int8-weight bundle (``serve/quant.py``)."""
    a = np.asarray(a)
    a = a if a.dtype == np.int8 else a.astype(np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy the tensor owns


def array_to_jax(t: torch.Tensor) -> np.ndarray:
    """One port-layout tensor -> a JAX-layout numpy array: float32, or int8
    for an int8 tensor."""
    t = t.detach().to("cpu")
    a = (t if t.dtype == torch.int8 else t.float()).numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return np.ascontiguousarray(a)


def from_jax(flat: dict) -> dict:
    """JAX-layout arrays keyed by '/'-joined paths (what ``weights.npz``
    holds) -> the port's nested tree of CPU tensors."""
    return unflatten_tree({k: array_from_jax(v) for k, v in flat.items()})


def to_jax(tree: dict) -> dict[str, np.ndarray]:
    """The port's tree -> JAX-layout numpy arrays keyed by ``/``-joined
    paths (what ``weights.npz`` holds)."""
    return {k: array_to_jax(v) for k, v in flatten_tree(tree).items()}


def depthwise_taps(w: torch.Tensor) -> torch.Tensor:
    """(C, 1, k, k) depthwise weight -> the contiguous (k, k, C) float32
    taps the fused depthwise kernel reads (channel index fastest)."""
    if w.dim() != 4 or w.shape[1] != 1 or w.shape[2] != w.shape[3]:
        raise ValueError(f"not a depthwise (C, 1, k, k) weight: {tuple(w.shape)}")
    return w[:, 0].permute(1, 2, 0).contiguous().float()


def _nested_from_jax(tree) -> dict:
    """A nested dict of JAX-layout arrays (any array type numpy reads) ->
    the port's nested tree of CPU tensors."""
    return from_jax({k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def _nested_to_jax(tree) -> dict:
    """The port's nested tree -> a nested dict of JAX-layout numpy arrays."""
    return unflatten_tree(to_jax(tree))


# the optimizer buffers of the port's state, by their optax field names
_OPT_TREES = ("nu", "trace", "mu")


def opt_state_from_jax(opt_state) -> dict:
    """optax's chain-state tuple -> the port's optimizer state
    ``{'count', 'nu'?, 'trace'?, 'mu'?}`` (``train/optim.py``). The count is
    the LR schedule's (``ScaleByScheduleState``; ``scale_by_adam`` keeps an
    equal one)."""
    out: dict = {}

    def walk(node):
        if hasattr(node, "_fields"):  # an optax NamedTuple state
            for f in node._fields:
                v = getattr(node, f)
                if f == "count":
                    out["count"] = torch.tensor(int(np.asarray(v)), dtype=torch.int32)
                elif f in _OPT_TREES:
                    out[f] = _nested_from_jax(v)
                else:
                    walk(v)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    return out


def opt_state_to_jax(state: dict, template):
    """The port's optimizer state written into a copy of ``template`` (the
    JAX optimizer's ``init`` output): every ``count``, ``nu``, ``trace`` and
    ``mu`` field of the chain takes the port's value as numpy arrays."""

    def walk(node):
        if hasattr(node, "_fields"):
            changes = {}
            for f in node._fields:
                v = getattr(node, f)
                if f == "count":
                    changes[f] = np.asarray(state["count"].cpu(), dtype=np.int32)
                elif f in _OPT_TREES:
                    changes[f] = _nested_to_jax(state[f])
                else:
                    changes[f] = walk(v)
            return node._replace(**changes)
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        return node

    return walk(template)


def train_state_from_jax(ts, device: str | torch.device = "cpu"):
    """A JAX ``TrainState`` (or a dict of its fields) -> the port's
    ``train.steps.TrainState`` on ``device``."""
    from ..train.steps import TrainState

    get = ts.get if isinstance(ts, dict) else lambda k: getattr(ts, k, None)

    def put(tree):
        return None if tree is None else unflatten_tree({k: v.to(device) for k, v in flatten_tree(tree).items()})

    masks, rho = get("masks"), get("rho_mult")
    return TrainState(
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32, device=device),
        params=put(_nested_from_jax(get("params"))),
        state=put(_nested_from_jax(get("state"))),
        opt_state=put(opt_state_from_jax(get("opt_state"))),
        ema_params=None if get("ema_params") is None else put(_nested_from_jax(get("ema_params"))),
        ema_state=None if get("ema_state") is None else put(_nested_from_jax(get("ema_state"))),
        masks={k: torch.from_numpy(np.array(v, np.float32)).to(device) for k, v in (masks or {}).items()},
        rho_mult=None if rho is None else torch.tensor(float(np.asarray(rho)), device=device),
    )


def train_state_to_jax(ts, opt_template) -> dict:
    """The port's TrainState -> the JAX TrainState's fields as numpy arrays
    in the JAX layouts (``yet_another_mobilenet_series_tpu.train.steps.
    TrainState(**fields)`` rebuilds it). ``opt_template`` is the JAX
    optimizer's ``init`` output, whose chain structure the state fills."""
    return {
        "step": np.asarray(int(ts.step), dtype=np.int32),
        "params": _nested_to_jax(ts.params),
        "state": _nested_to_jax(ts.state),
        "opt_state": opt_state_to_jax(ts.opt_state, opt_template),
        "ema_params": None if ts.ema_params is None else _nested_to_jax(ts.ema_params),
        "ema_state": None if ts.ema_state is None else _nested_to_jax(ts.ema_state),
        "masks": {k: v.detach().cpu().float().numpy() for k, v in (ts.masks or {}).items()},
        "rho_mult": None if ts.rho_mult is None else np.asarray(float(ts.rho_mult), np.float32),
    }

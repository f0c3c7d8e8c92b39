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

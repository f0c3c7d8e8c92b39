"""Exponential moving average of params + BN stats: the torch twin of
``yet_another_mobilenet_series_tpu/train/ema.py``.

Shadow = decay * shadow + (1-decay) * value; with ``warmup`` the decay is
min(decay, (1+t)/(10+t)), so early steps are not dominated by the init.
"""

from __future__ import annotations

import torch

from ..config import EMAConfig
from ..models.convert import flatten_tree, unflatten_tree


def ema_update(cfg: EMAConfig, shadow: dict, value: dict, step):
    """One EMA step over matching trees of tensors; returns a new tree
    (the shadow never aliases ``value``). ``step`` is the pre-step count,
    a Python number or a 0-dim tensor on the trees' device. Three
    ``_foreach`` launches cover every leaf."""
    if not cfg.enable:
        return shadow
    flat_s, flat_v = flatten_tree(shadow), flatten_tree(value)
    keys = list(flat_s)
    s_list = [flat_s[k] for k in keys]
    v_list = [flat_v[k].to(flat_s[k].dtype) for k in keys]
    device = s_list[0].device
    decay = torch.full((), cfg.decay, dtype=torch.float32, device=device)
    if cfg.warmup:
        t = torch.as_tensor(step).to(device=device, dtype=torch.float32)
        decay = torch.minimum(decay, (1.0 + t) / (10.0 + t))
    out = torch._foreach_mul(s_list, decay)
    torch._foreach_add_(out, torch._foreach_mul(v_list, 1.0 - decay))
    return unflatten_tree(dict(zip(keys, out)))

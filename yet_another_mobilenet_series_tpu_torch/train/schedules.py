"""LR schedules, stepped per iteration: the torch twin of
``yet_another_mobilenet_series_tpu/train/schedules.py`` (linear warmup, then
a staircase exponential decay, a cosine or a constant)."""

from __future__ import annotations

import math

import torch

from ..config import ScheduleConfig


def make_lr_schedule(cfg: ScheduleConfig, total_batch: int, steps_per_epoch: int, total_epochs: float):
    """Returns lr(step) -> 0-dim float32 tensor. ``step`` is a Python
    number or an integer tensor; a tensor's device is kept, so the
    optimizer reads its LR on the card without a host sync."""
    base_lr = cfg.base_lr * (total_batch / 256.0) if cfg.scale_by_batch else cfg.base_lr
    warmup_steps = max(int(cfg.warmup_epochs * steps_per_epoch), 0)
    total_steps = max(int(total_epochs * steps_per_epoch), warmup_steps + 1)
    if cfg.schedule not in ("exp_decay", "cosine", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    decay_steps = max(int(cfg.decay_epochs * steps_per_epoch), 1)
    floor = cfg.final_lr_factor * base_lr

    def lr_fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        if cfg.schedule == "exp_decay":
            n_decays = torch.floor(torch.clamp_min(step - warmup_steps, 0.0) / decay_steps)
            after = base_lr * torch.pow(torch.full_like(step, cfg.decay_rate), n_decays)
        elif cfg.schedule == "cosine":
            t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
            after = floor + (base_lr - floor) * (0.5 * (1.0 + torch.cos(math.pi * t)))
        else:
            after = torch.full_like(step, base_lr)
        return torch.where(step < warmup_steps, warm, after).to(torch.float32)

    return lr_fn

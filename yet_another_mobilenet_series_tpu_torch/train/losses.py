"""Losses: the torch twin of ``yet_another_mobilenet_series_tpu/train/losses.py``."""

from __future__ import annotations

import torch


def cross_entropy_label_smooth(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1) -> torch.Tensor:
    """Mean label-smoothed cross entropy, computed in float32: target =
    (1-eps)*onehot + eps/K, loss = -sum(target * log_softmax(logits))."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)) -> dict[str, torch.Tensor]:
    """Counts (float32 tensors) of top-k correct predictions."""
    max_k = max(ks)
    if max_k > logits.shape[-1]:
        raise ValueError(f"top-{max_k} with only {logits.shape[-1]} classes")
    pred = torch.topk(logits, max_k, dim=-1).indices  # (N, max_k)
    hit = pred == labels.long()[:, None]
    return {f"top{k}": hit[:, :k].sum().float() for k in ks}

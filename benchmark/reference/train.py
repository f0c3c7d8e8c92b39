"""The plain reference of the training step: forward in train mode, label-smoothed cross entropy,
the gradients by autograd, coupled L2 weight decay on every weight but BN's and the biases,
TF-style RMSProp with momentum, and the EMA of the weights and of the BN running statistics.

It imports torch and ``nets`` alone, and works everything out again from the inputs it is given:
the drawn weights and running statistics, the batches, the recipe's numbers, and the seed of the
step's random draws.

The recipe, as its configuration states it:

- LR: ``base_lr * batch / 256`` (when ``scale_by_batch``), linear warm-up over ``warmup_epochs``,
  then multiplied by ``decay_rate`` every ``decay_epochs``; an epoch is ``train_examples // batch``
  steps;
- RMSProp: ``nu = d nu + (1 - d) g^2`` from ``nu = 1``; ``mom = m mom + lr g / sqrt(nu + eps)``
  from ``mom = 0`` (the LR of each step folded in as it accumulates); ``w -= mom``;
- EMA: ``shadow = a shadow + (1 - a) value`` with ``a = min(decay, (1 + t) / (10 + t))`` and t
  the step count before the step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import nets


@dataclass(frozen=True)
class Recipe:
    batch: int
    base_lr: float
    scale_by_batch: bool
    warmup_epochs: float
    decay_rate: float
    decay_epochs: float
    train_examples: int
    rmsprop_decay: float
    rmsprop_eps: float
    momentum: float
    weight_decay: float
    label_smoothing: float
    ema_decay: float
    start_step: int

    @classmethod
    def from_config(cls, cfg: dict, batch: int) -> "Recipe":
        o, s, e, r = cfg["optim"], cfg["schedule"], cfg["ema"], cfg["run"]
        return cls(batch, s["base_lr"], s["scale_by_batch"], s["warmup_epochs"], s["decay_rate"],
                   s["decay_epochs"], cfg["data"]["num_train_examples"], o["rmsprop_decay"], o["rmsprop_eps"],
                   o["momentum"], o["weight_decay"], o["label_smoothing"], e["decay"], r["start_step"])

    def lr(self, step: int) -> float:
        base = self.base_lr * self.batch / 256.0 if self.scale_by_batch else self.base_lr
        per_epoch = max(self.train_examples // self.batch, 1)
        warmup = int(self.warmup_epochs * per_epoch)
        if step < warmup:
            return base * step / max(warmup, 1)
        return base * self.decay_rate ** math.floor((step - warmup) / max(int(self.decay_epochs * per_epoch), 1))


def decayed(name: str) -> bool:
    """Weight decay applies to conv and dense weights, not to BN's gamma and beta or to biases."""
    leaf = name.rsplit("/", 1)[-1]
    return leaf == "w"


@dataclass
class Trajectory:
    losses: list[float]
    grad_norms: dict[str, float]  # the first step's gradient, weight decay added, per leaf
    params: dict[str, torch.Tensor]  # after the last step
    state: dict[str, torch.Tensor]
    ema: dict[str, torch.Tensor]  # the weights' shadow
    ema_state: dict[str, torch.Tensor]  # the running statistics' shadow


def run(arch: nets.Arch, recipe: Recipe, params: dict, state: dict, ema: dict, batches, step_seed: int, *,
        ops: nets.Ops = nets.PLAIN, rows: int | None = None) -> Trajectory:
    """``len(batches)`` steps from ``params``/``state`` and the weights' shadow ``ema`` (float32
    on one device, left as they are), each batch an ``(images NHWC, labels)`` pair. The random draws come from a generator
    on that device seeded with ``step_seed``, drawn for the full batch as the step draws them;
    ``rows`` (a fault of the check's own tests) trains on the first rows only."""
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(step_seed)
    p = {k: v.detach().clone() for k, v in params.items()}
    s = {k: v.detach().clone() for k, v in state.items()}
    nu = {k: torch.ones_like(v) for k, v in p.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    ema = {k: v.detach().clone() for k, v in ema.items()}
    ema_s = {k: v.clone() for k, v in s.items()}
    losses, grad_norms = [], {}
    for i, (x, y) in enumerate(batches):
        t = recipe.start_step + i
        noise = nets.draw_noise(arch, gen, x.shape[0], dev)
        if rows is not None:
            x, y = x[:rows], y[:rows]
            noise = {"drop_path": {k: v[:rows] for k, v in noise["drop_path"].items()},
                     **({"dropout": noise["dropout"][:rows]} if "dropout" in noise else {})}
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            logits, s_new = nets.forward(arch, leaves, s, x, train=True, noise=noise, ops=ops, checkpoint=True)
            loss = nets.smoothed_cross_entropy(logits, y, recipe.label_smoothing)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        lr = recipe.lr(t)
        d, eps, m = recipe.rmsprop_decay, recipe.rmsprop_eps, recipe.momentum
        with torch.no_grad():
            for (k, w), g in zip(leaves.items(), grads):
                w = w.detach()
                if decayed(k):
                    g = g + recipe.weight_decay * w
                if i == 0:
                    grad_norms[k] = float(torch.linalg.vector_norm(g.double()))
                nu[k] = d * nu[k] + (1.0 - d) * g * g
                mom[k] = m * mom[k] + lr * g / torch.sqrt(nu[k] + eps)
                p[k] = w - mom[k]
            a = min(recipe.ema_decay, (1.0 + t) / (10.0 + t))
            for k in ema:
                ema[k] = a * ema[k] + (1.0 - a) * p[k]
            s = {k: v.detach() for k, v in s_new.items()}
            for k in ema_s:
                ema_s[k] = a * ema_s[k] + (1.0 - a) * s[k]
        del logits, loss, grads, leaves
    return Trajectory(losses, grad_norms, p, s, ema, ema_s)

"""Eval-mode NN primitives: the torch twin of ``yet_another_mobilenet_series_tpu/ops/layers.py``.

Layers are static specs (frozen dataclasses of hashable configuration) with
``init(generator)`` returning parameter/state dicts of tensors and
``apply(params, x)`` as a plain function on tensors, like the JAX package.

Conventions of the port:
- Activations between layers are NCHW-shaped tensors in ``channels_last``
  memory, which is NHWC in memory: the JAX package's layout, so the public
  functions take and give NHWC with ``permute`` and no copy.
- Conv weights are OIHW (PyTorch's layout); a depthwise weight is
  (C, 1, k, k). Dense weights keep the JAX layout (in, out) and apply as
  ``x @ w``. ``models/convert.py`` maps the JAX trees onto these layouts.
- Symmetric ``k//2`` padding (not TF 'SAME', which pads asymmetrically at
  stride 2).
- Parameters are float32; ``compute_dtype`` may be bfloat16 for the convs
  while BN statistics and pooling stay float32.

Train-mode BatchNorm, dropout and the fused BN backward wait for the
training slice of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers (torch-default-compatible: kaiming fan_out for convs)
# ---------------------------------------------------------------------------


def kaiming_normal_fan_out(gen: torch.Generator, shape) -> torch.Tensor:
    """He-normal with fan_out = kh*kw*out_ch over an OIHW ``shape``. For a
    grouped/depthwise kernel fan_out is still kh*kw*O (torch semantics)."""
    o, _, kh, kw = shape
    std = math.sqrt(2.0 / (kh * kw * o))
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def normal_init(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def uniform_init(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


# ---------------------------------------------------------------------------
# Conv2D
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Conv2D:
    """2-D convolution spec; groups=in_channels gives a depthwise conv."""

    in_channels: int
    out_channels: int
    kernel_size: int = 1
    stride: int = 1
    groups: int = 1
    use_bias: bool = False

    def __post_init__(self):
        if self.in_channels % self.groups or self.out_channels % self.groups:
            raise ValueError(f"channels ({self.in_channels}->{self.out_channels}) not divisible by groups={self.groups}")

    def init(self, gen: torch.Generator) -> dict:
        k = self.kernel_size
        shape = (self.out_channels, self.in_channels // self.groups, k, k)
        params = {"w": kaiming_normal_fan_out(gen, shape)}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_channels)
        return params

    def apply(self, params: dict, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        """x: (N, C, H, W), channels_last in memory -> the same layout."""
        bias = params["b"].to(compute_dtype) if self.use_bias else None
        return F.conv2d(x.to(compute_dtype), params["w"].to(compute_dtype), bias, stride=self.stride,
                        padding=self.kernel_size // 2, groups=self.groups)


# ---------------------------------------------------------------------------
# BatchNorm (eval)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchNorm:
    """BatchNorm over N,H,W in eval mode: normalizes with the running
    statistics, ``(f32(x) - mean) * (gamma * rsqrt(var + eps)) + beta`` (the
    JAX package's "exact" mode). Train mode waits for the training slice."""

    num_features: int
    momentum: float = 0.1
    eps: float = 1e-5

    def init(self) -> tuple[dict, dict]:
        c = self.num_features
        params = {"gamma": torch.ones(c), "beta": torch.zeros(c)}
        state = {"mean": torch.zeros(c), "var": torch.ones(c)}
        return params, state

    def apply(self, params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(state["var"] + self.eps) * params["gamma"]
        y = (x.float() - state["mean"][:, None, None]) * scale[:, None, None] + params["beta"][:, None, None]
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dense:
    in_features: int
    out_features: int
    use_bias: bool = True
    init_std: float = 0.01  # reference lineage: classifier ~ N(0, 0.01)

    def init(self, gen: torch.Generator) -> dict:
        params = {"w": normal_init(gen, (self.in_features, self.out_features), self.init_std)}
        if self.use_bias:
            params["b"] = torch.zeros(self.out_features)
        return params

    def apply(self, params: dict, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        y = x.to(compute_dtype) @ params["w"].to(compute_dtype)
        if self.use_bias:
            y = y + params["b"].to(compute_dtype)
        return y


# ---------------------------------------------------------------------------
# Stateless helpers
# ---------------------------------------------------------------------------


def bn_scale_shift(gamma, beta, mean, var, eps: float = 1e-5):
    """Eval-mode BN collapsed to a per-channel affine: scale = gamma *
    rsqrt(var + eps), shift = beta - mean * scale. The single source of the
    fold (serve/export.py) and of the kernel's scale/shift operands."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H,W of an (N, C, H, W) tensor -> (N, C). Computed in
    float32 (bf16 accumulation over 49+ terms hurts SE gates and the head)."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Channel rounding used throughout the MobileNet family. Never rounds
    down by more than 10%."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v

"""NN primitives: the torch twin of ``yet_another_mobilenet_series_tpu/ops/layers.py``.

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
- ``apply(..., train=False)`` returns the output alone (the serving forward);
  ``train=True`` returns ``(output, new_state)`` like the JAX package's.

SyncBN: in training, ``group`` (a ``torch.distributed`` process group, the
JAX package's ``axis_name``) sums the batch moments over the group's ranks,
so the statistics are the global batch's; ``group=None`` is one process.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..utils.collectives import group_size

# the BatchNorm.apply normalize variants (the JAX package's tuple; the step
# builder validates against it)
BN_MODES = ("exact", "folded", "compute", "fused_vjp", "sdot", "compute_sdot")

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

    def apply(self, params: dict, x: torch.Tensor, *, compute_dtype=torch.float32,
              as_dot: bool = False) -> torch.Tensor:
        """x: (N, C, H, W), channels_last in memory -> the same layout.

        ``as_dot`` runs a 1x1 ungrouped conv as an explicit matmul over the
        NHWC view, ``(N, H, W, Cin) @ (Cin, Cout)``, with a stride as a
        subsample (its padding is 0); a no-op for k > 1 or a grouped conv."""
        w = params["w"].to(compute_dtype)
        x = x.to(compute_dtype)
        bias = params["b"].to(compute_dtype) if self.use_bias else None
        if as_dot and self.kernel_size == 1 and self.groups == 1:
            if self.stride > 1:
                x = x[:, :, :: self.stride, :: self.stride]
            y = x.permute(0, 2, 3, 1) @ w.reshape(self.out_channels, self.in_channels).t()
            if bias is not None:
                y = y + bias
            return y.permute(0, 3, 1, 2)
        return F.conv2d(x, w, bias, stride=self.stride, padding=self.kernel_size // 2, groups=self.groups)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def _channel(v: torch.Tensor) -> torch.Tensor:
    """A (C,) vector broadcast over an (N, C, H, W) tensor."""
    return v[:, None, None]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group's ranks that autograd differentiates: the
    transpose of a sum over ranks is the sum over ranks of the cotangents
    (``lax.psum``'s). The input is left as it was."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dy):
        out = dy.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def _group_sums(s1, s2, group):
    """(s1, s2) summed over the group's ranks in ONE all-reduce of the two
    packed; unchanged for ``group=None``."""
    if group is None:
        return s1, s2
    c = s1.shape[0]
    both = _AllReduceSum.apply(torch.cat([s1, s2]), group)
    return both[:c], both[c:]


def _finalize_moments(s1, s2, n: int, group=None):
    """Mean and biased variance from the f32 sums, summed over ``group``,
    the variance clamped at 0, and the global count. Every rank holds the
    same local batch, so the global count is ``n`` times the group's size,
    a Python int as in one process."""
    s1, s2 = _group_sums(s1, s2, group)
    n = n * group_size(group)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
    return mean, var, n


def _bn_moments(x: torch.Tensor, group=None):
    """f32 moments of x over N, H, W (and the group's ranks): (mean, biased
    var, n). The sums accumulate in float32 whatever x's dtype."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    s1 = torch.sum(x, dim=(0, 2, 3), dtype=torch.float32)
    s2 = torch.sum(torch.square(x.float()), dim=(0, 2, 3))
    return _finalize_moments(s1, s2, n, group)


def _bn_moments_dot(x: torch.Tensor, group=None):
    """The moments as matrix products over the NHWC rows (the JAX package's
    ``sdot`` statistics): s1 = ones . x and s2 = sum_rows x*x as a
    channel-batched self-contraction. Both run in float32: the products of
    bf16 inputs are exact there, as in the f32 accumulator of the JAX
    package's dots, so the sums agree with ``_bn_moments`` up to
    accumulation order."""
    c = x.shape[1]
    xt = x.permute(0, 2, 3, 1).reshape(-1, c).float()
    n = xt.shape[0]
    s1 = torch.ones(n, dtype=torch.float32, device=x.device) @ xt
    s2 = torch.einsum("nc,nc->c", xt, xt)
    return _finalize_moments(s1, s2, n, group)


class _BNTrainFused(torch.autograd.Function):
    """Train-mode BN with the closed-form backward through the batch
    statistics (the JAX package's ``_bn_train_fused``):

        dβ = Σ dy;  dγ = Σ dy·x̂;  dx = γ·inv · (dy − dβ/n − x̂·dγ/n)

    The residuals are x in its own dtype and the per-channel f32 stats; x̂
    and any f32 copy of the activation are recomputed in backward. The
    mean/var outputs feed only the running statistics, which the loss never
    differentiates: a gradient arriving on them is rejected, not dropped.

    Under ``group`` (SyncBN) the moments and n are global, and so are the
    sums in dx's correction terms; dγ and dβ are this rank's partial sums,
    which the step's gradient average combines (the JAX package's contract,
    ``_bn_train_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        mean, var, n = _bn_moments(x, group)
        inv = torch.rsqrt(var + eps)
        scale = gamma * inv
        bias = beta - mean * scale
        y = (x.float() * _channel(scale) + _channel(bias)).to(x.dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.n = n
        ctx.group = group
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        if dmean is not None or dvar is not None:
            raise TypeError(
                "bn_mode='fused_vjp' received non-zero cotangents for the batch "
                "mean/var outputs; its closed-form backward discards them by "
                "contract. A loss term differentiating the batch statistics "
                "must use an autodiff bn_mode ('exact'/'folded').")
        x, gamma, mean, inv = ctx.saved_tensors
        if dy is None:  # nothing differentiates y either
            return torch.zeros_like(x), torch.zeros_like(gamma), torch.zeros_like(gamma), None, None
        n = ctx.n
        dyf = dy.float()
        x_hat = (x.float() - _channel(mean)) * _channel(inv)
        dbeta = dyf.sum(dim=(0, 2, 3))
        dgamma = (dyf * x_hat).sum(dim=(0, 2, 3))
        s1, s2 = _group_sums(dbeta, dgamma, ctx.group)
        dx = _channel(gamma * inv) * (dyf - _channel(s1 / n) - x_hat * _channel(s2 / n))
        return dx.to(x.dtype), dgamma, dbeta, None, None


@dataclass(frozen=True)
class BatchNorm:
    """BatchNorm over N,H,W with torch semantics:

    - normalization uses the biased batch variance;
    - running stats update ``running = (1-m)*running + m*batch`` with
      momentum m and the unbiased batch variance over n = N·H·W.

    Eval normalizes with the running statistics. ``mode`` picks the
    normalize expression, as in the JAX package (whose docstring has the
    rationale of each):

    - "exact": ``(f32(x) - mean) * (gamma*rsqrt(var+eps)) + beta``;
    - "folded": per-channel ``scale``/``bias`` in f32, then one FMA;
    - "compute": "folded" with scale/bias cast to x's dtype and the FMA in
      the compute dtype;
    - "fused_vjp": "folded" under :class:`_BNTrainFused` in training;
    - "sdot" / "compute_sdot": "folded" / "compute" over statistics
      computed as matrix products (:func:`_bn_moments_dot`).
    """

    num_features: int
    momentum: float = 0.1
    eps: float = 1e-5

    def init(self) -> tuple[dict, dict]:
        c = self.num_features
        params = {"gamma": torch.ones(c), "beta": torch.zeros(c)}
        state = {"mean": torch.zeros(c), "var": torch.ones(c)}
        return params, state

    def _running(self, state: dict, mean, var, n: int) -> dict:
        m = self.momentum
        unbiased = var * (n / max(n - 1.0, 1.0))
        return {"mean": (1.0 - m) * state["mean"] + m * mean,
                "var": (1.0 - m) * state["var"] + m * unbiased}

    def apply(self, params: dict, state: dict, x: torch.Tensor, *, train: bool = False, mode: str = "exact",
              group=None):
        """Eval: the normalized x. Train: ``(y, new_state)``, the batch
        moments summed over ``group``'s ranks when one is given (SyncBN)."""
        if mode not in BN_MODES:
            raise ValueError(f"unknown bn mode {mode!r}")
        if train and mode == "fused_vjp":
            y, mean, var = _BNTrainFused.apply(x, params["gamma"], params["beta"], self.eps, group)
            n = x.shape[0] * x.shape[2] * x.shape[3] * group_size(group)
            return y, self._running(state, mean, var, n)
        if train:
            moments = _bn_moments_dot if mode in ("sdot", "compute_sdot") else _bn_moments
            mean, var, n = moments(x, group)
            new_state = self._running(state, mean, var, n)
        else:
            mean, var = state["mean"], state["var"]
        scale = torch.rsqrt(var + self.eps) * params["gamma"]
        if mode == "exact":
            y = (x.float() - _channel(mean)) * _channel(scale) + _channel(params["beta"])
        elif mode in ("compute", "compute_sdot"):
            bias = params["beta"] - mean * scale
            y = x * _channel(scale.to(x.dtype)) + _channel(bias.to(x.dtype))
        else:  # "folded"/"sdot", and eval-mode "fused_vjp" (same expression)
            bias = params["beta"] - mean * scale
            y = x.float() * _channel(scale) + _channel(bias)
        y = y.to(x.dtype)
        return (y, new_state) if train else y


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


def dropout(x: torch.Tensor, rate: float, train: bool, *, keep: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout: ``where(keep, x / (1 - rate), 0)``. ``keep`` (a
    boolean tensor of x's shape) is the mask; without it one is drawn from
    ``generator``."""
    if not train or rate == 0.0:
        return x
    p_keep = 1.0 - rate
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < p_keep
    return torch.where(keep, x / p_keep, torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Channel rounding used throughout the MobileNet family. Never rounds
    down by more than 10%."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v

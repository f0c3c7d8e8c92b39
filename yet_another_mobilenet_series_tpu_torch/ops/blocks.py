"""Composite blocks: the torch twin of ``yet_another_mobilenet_series_tpu/ops/blocks.py``.

The spec dataclasses and their validation are the same as the JAX
package's, so ``models/serialize.py`` round-trips them across the two
packages. ``apply(..., train=False)`` is the eval forward (BN from the
running statistics) and returns the output; ``train=True`` normalizes with
the batch statistics and returns ``(output, new_state)``.

An AtomNAS block splits its expanded channels into per-kernel-size
depthwise branches ("atoms") over channel slices, with one concatenated
``dw_bn`` whose gamma is the prune handle; the optional ``mask`` multiplies
the expanded channels after the depthwise activation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .activations import get_activation
from .layers import BatchNorm, Conv2D, global_avg_pool, uniform_init


@dataclass(frozen=True)
class ConvBNAct:
    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    groups: int = 1
    active_fn: str = "relu6"
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5

    def __post_init__(self):
        get_activation(self.active_fn)  # fail at spec-build time

    @property
    def conv(self) -> Conv2D:
        return Conv2D(self.in_channels, self.out_channels, self.kernel_size, self.stride, self.groups)

    @property
    def bn(self) -> BatchNorm:
        return BatchNorm(self.out_channels, self.bn_momentum, self.bn_eps)

    def init(self, gen: torch.Generator):
        params = {"conv": self.conv.init(gen)}
        params["bn"], bn_s = self.bn.init()
        return params, {"bn": bn_s}

    def apply(self, params, state, x, *, train: bool = False, compute_dtype=torch.float32, bn_mode: str = "exact",
              conv1x1_dot: bool = False, group=None):
        y = self.conv.apply(params["conv"], x, compute_dtype=compute_dtype, as_dot=conv1x1_dot)
        if not train:
            return get_activation(self.active_fn)(self.bn.apply(params["bn"], state["bn"], y, mode=bn_mode))
        y, bn_s = self.bn.apply(params["bn"], state["bn"], y, train=True, mode=bn_mode, group=group)
        return get_activation(self.active_fn)(y), {"bn": bn_s}


@dataclass(frozen=True)
class SqueezeExcite:
    """SE over (N, C, H, W) features: squeeze (global mean) -> reduce FC ->
    act -> expand FC -> gate. The squeeze and the gate run in float32."""

    channels: int
    se_channels: int
    inner_act: str = "relu"
    gate_fn: str = "hsigmoid"

    def init(self, gen: torch.Generator):
        # torch Conv2d-default init for the SE FCs: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        return {
            "reduce": {"w": uniform_init(gen, (self.channels, self.se_channels), 1.0 / math.sqrt(self.channels)),
                       "b": torch.zeros(self.se_channels)},
            "expand": {"w": uniform_init(gen, (self.se_channels, self.channels), 1.0 / math.sqrt(self.se_channels)),
                       "b": torch.zeros(self.channels)},
        }

    def apply(self, params, x):
        s = global_avg_pool(x).float()  # (N, C)
        s = s @ params["reduce"]["w"] + params["reduce"]["b"]
        s = get_activation(self.inner_act)(s)
        s = s @ params["expand"]["w"] + params["expand"]["b"]
        gate = get_activation(self.gate_fn)(s).to(x.dtype)
        return x * gate[:, :, None, None]


@dataclass(frozen=True)
class InvertedResidual:
    """MBConv / AtomNAS block (same fields and validation as the JAX spec).

    ``group_channels[i]`` expanded channels go through a depthwise conv of
    size ``kernel_sizes[i]``; a standard MBConv is the single-kernel case.
    Residual iff stride==1 and in_channels==out_channels.
    """

    in_channels: int
    out_channels: int
    expanded_channels: int
    stride: int = 1
    kernel_sizes: tuple[int, ...] = (3,)
    group_channels: tuple[int, ...] = ()  # defaults to all channels on kernel_sizes[0]
    active_fn: str = "relu6"
    se_channels: int = 0  # 0 = no SE
    se_gate_fn: str = "hsigmoid"
    se_inner_act: str = "relu"
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    project_act: str = "identity"
    allow_residual: bool = True
    force_expand: bool = False
    # per-sample stochastic depth of the residual branch in training,
    # inverse-scaled by the keep probability; eval ignores it
    drop_path: float = 0.0

    def __post_init__(self):
        for name in (self.active_fn, self.project_act, self.se_gate_fn, self.se_inner_act):
            get_activation(name)  # fail at spec-build time
        if not 0.0 <= self.drop_path < 1.0:
            raise ValueError(f"drop_path must be in [0, 1), got {self.drop_path}")
        groups = self.group_channels or (self.expanded_channels,)
        object.__setattr__(self, "group_channels", tuple(groups))
        if len(self.group_channels) != len(self.kernel_sizes):
            raise ValueError(f"group_channels {self.group_channels} vs kernel_sizes {self.kernel_sizes}")
        if sum(self.group_channels) != self.expanded_channels:
            raise ValueError(f"group_channels {self.group_channels} must sum to expanded={self.expanded_channels}")
        if any(g <= 0 for g in self.group_channels):
            raise ValueError(f"empty atomic group in {self.group_channels}")

    @property
    def has_expand(self) -> bool:
        return self.force_expand or self.expanded_channels != self.in_channels

    @property
    def has_residual(self) -> bool:
        return self.allow_residual and self.stride == 1 and self.in_channels == self.out_channels

    def _bn(self, c):
        return BatchNorm(c, self.bn_momentum, self.bn_eps)

    def _branches(self):
        """Yields (branch_index, kernel_size, group_channels, offset): the
        expanded-channel layout shared by the eval and folded forwards."""
        offset = 0
        for i, (k, g) in enumerate(zip(self.kernel_sizes, self.group_channels)):
            yield i, k, g, offset
            offset += g

    def _se(self) -> SqueezeExcite:
        return SqueezeExcite(self.expanded_channels, self.se_channels, self.se_inner_act, self.se_gate_fn)

    def init(self, gen: torch.Generator):
        params, state = {}, {}
        if self.has_expand:
            params["expand"] = Conv2D(self.in_channels, self.expanded_channels, 1).init(gen)
            params["expand_bn"], state["expand_bn"] = self._bn(self.expanded_channels).init()
        for i, k, g, _ in self._branches():
            params[f"dw{i}_k{k}"] = Conv2D(g, g, k, self.stride, groups=g).init(gen)
        params["dw_bn"], state["dw_bn"] = self._bn(self.expanded_channels).init()
        if self.se_channels:
            params["se"] = self._se().init(gen)
        params["project"] = Conv2D(self.expanded_channels, self.out_channels, 1).init(gen)
        params["project_bn"], state["project_bn"] = self._bn(self.out_channels).init()
        return params, state

    def apply(self, params, state, x, *, train: bool = False, compute_dtype=torch.float32,
              mask: torch.Tensor | None = None, bn_mode: str = "exact", conv1x1_dot: bool = False,
              keep: torch.Tensor | None = None, group=None):
        """Forward of (N, C, H, W) -> (N, C', H', W'). mask: optional
        (expanded_channels,) multiplier zeroing dead atoms. In training,
        ``keep`` is the (N,) 0/1 drop-path draw of this block (None = no
        drop path); ``Network.apply`` makes it."""
        act = get_activation(self.active_fn)
        new_state = {}

        def bn(name, c, h):
            if not train:
                return self._bn(c).apply(params[name], state[name], h, mode=bn_mode)
            h, new_state[name] = self._bn(c).apply(params[name], state[name], h, train=True, mode=bn_mode,
                                                   group=group)
            return h

        h = x
        if self.has_expand:
            h = Conv2D(self.in_channels, self.expanded_channels, 1).apply(
                params["expand"], h, compute_dtype=compute_dtype, as_dot=conv1x1_dot)
            h = act(bn("expand_bn", self.expanded_channels, h))
        branches = []
        for i, k, g, off in self._branches():
            branches.append(Conv2D(g, g, k, self.stride, groups=g).apply(
                params[f"dw{i}_k{k}"], h[:, off: off + g], compute_dtype=compute_dtype))
        h = branches[0] if len(branches) == 1 else torch.cat(branches, dim=1)
        h = act(bn("dw_bn", self.expanded_channels, h))
        if mask is not None:
            h = h * mask.to(h.dtype)[:, None, None]
        if self.se_channels:
            h = self._se().apply(params["se"], h)
        h = Conv2D(self.expanded_channels, self.out_channels, 1).apply(
            params["project"], h, compute_dtype=compute_dtype, as_dot=conv1x1_dot)
        h = bn("project_bn", self.out_channels, h)
        h = get_activation(self.project_act)(h)
        if self.has_residual:
            if train and self.drop_path > 0 and keep is not None:
                keep_prob = torch.full((), 1.0 - self.drop_path, dtype=h.dtype, device=h.device)
                h = h * (keep.to(h.dtype) / keep_prob)[:, None, None, None]
            if mask is not None:
                # a fully masked block equals identity exactly (the project
                # BN's shift must not leak through zeroed inputs)
                h = h * (mask.max() > 0).to(h.dtype)
            h = h + x.to(h.dtype)
        return (h, new_state) if train else h

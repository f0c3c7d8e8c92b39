# Copy of yet_another_mobilenet_series_tpu/utils/profiling.py: the port keeps its own copy so that it never
# imports the JAX package (whose models/specs.py this one's twin replaces). Keep the two in step by hand.
"""Analytic FLOPs/params profiler (reference: utils/model_profiling.py,
SURVEY.md §2 #10).

The reference attaches forward hooks to count per-module n_macs/n_params; in
JAX the model is a static spec tree, so we compute the same numbers
analytically — exactly, with no tracing — including the **per-atom FLOPs cost
table** that weights the AtomNAS BN-gamma L1 penalty (SURVEY.md §3.2).

Conventions match the common MobileNet accounting (and the reference's
profiler): MACs counted for convs and fully-connected layers only; BN and
activations are free; params count all trainables incl. BN gamma/beta but not
running stats.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.specs import Network
from ..ops.blocks import ConvBNAct, InvertedResidual


def _conv_out(hw: int, k: int, stride: int) -> int:
    # symmetric padding k//2 (see ops/layers.py): out = floor((h-1)/s)+1
    return (hw - 1) // stride + 1


@dataclass(frozen=True)
class LayerProfile:
    name: str
    macs: int
    params: int
    out_hw: int
    out_channels: int


@dataclass(frozen=True)
class ModelProfile:
    layers: tuple[LayerProfile, ...]
    # per-block cost vector: macs attributable to each expanded channel
    # ("atom") of every InvertedResidual block, keyed by block index.
    atom_costs: dict[int, np.ndarray]

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    def summary(self) -> str:
        lines = [f"{'layer':<16}{'out':>10}{'ch':>6}{'MACs':>14}{'params':>12}"]
        for l in self.layers:
            lines.append(f"{l.name:<16}{l.out_hw:>10}{l.out_channels:>6}{l.macs:>14,}{l.params:>12,}")
        lines.append(f"{'TOTAL':<32}{self.total_macs:>14,}{self.total_params:>12,}")
        return "\n".join(lines)


def _profile_conv_bn_act(spec: ConvBNAct, hw: int) -> tuple[int, int, int]:
    out_hw = _conv_out(hw, spec.kernel_size, spec.stride)
    macs = out_hw * out_hw * spec.kernel_size**2 * (spec.in_channels // spec.groups) * spec.out_channels
    params = spec.kernel_size**2 * (spec.in_channels // spec.groups) * spec.out_channels + 2 * spec.out_channels
    return macs, params, out_hw


def _profile_block(spec: InvertedResidual, hw: int) -> tuple[int, int, int, np.ndarray]:
    """Returns (macs, params, out_hw, per-atom cost vector)."""
    e = spec.expanded_channels
    out_hw = _conv_out(hw, 1, spec.stride)
    cost = np.zeros(e, dtype=np.float64)
    macs = 0
    params = 0
    if spec.has_expand:
        # 1x1 expand at input resolution: each expanded channel costs hw^2*cin
        macs += hw * hw * spec.in_channels * e
        params += spec.in_channels * e + 2 * e
        cost += hw * hw * spec.in_channels
    # depthwise branches at output resolution
    off = 0
    for k, g in zip(spec.kernel_sizes, spec.group_channels):
        macs += out_hw * out_hw * k * k * g
        params += k * k * g
        cost[off : off + g] += out_hw * out_hw * k * k
        off += g
    params += 2 * e  # dw BN
    if spec.se_channels:
        se = spec.se_channels
        macs += e * se + se * e
        params += e * se + se + se * e + e
        cost += 2 * se  # one reduce row + one expand column per atom
    # 1x1 project at output resolution
    macs += out_hw * out_hw * e * spec.out_channels
    params += e * spec.out_channels + 2 * spec.out_channels
    cost += out_hw * out_hw * spec.out_channels
    return macs, params, out_hw, cost


def profile_network(net: Network, image_size: int | None = None) -> ModelProfile:
    hw = image_size or net.image_size
    layers: list[LayerProfile] = []
    atom_costs: dict[int, np.ndarray] = {}

    macs, params, hw = _profile_conv_bn_act(net.stem, hw)
    layers.append(LayerProfile("stem", macs, params, hw, net.stem.out_channels))

    for i, blk in enumerate(net.blocks):
        macs, params, hw, cost = _profile_block(blk, hw)
        layers.append(LayerProfile(f"block{i}", macs, params, hw, blk.out_channels))
        atom_costs[i] = cost

    if net.head is not None:
        macs, params, hw = _profile_conv_bn_act(net.head, hw)
        layers.append(LayerProfile("head", macs, params, hw, net.head.out_channels))

    if net.feature is not None:
        f = net.feature
        layers.append(LayerProfile("feature", f.in_features * f.out_features, f.in_features * f.out_features + f.out_features, 1, f.out_features))

    c = net.classifier
    layers.append(LayerProfile("classifier", c.in_features * c.out_features, c.in_features * c.out_features + c.out_features, 1, c.out_features))
    return ModelProfile(tuple(layers), atom_costs)


def masked_macs(net: Network, masks: dict[int, np.ndarray], image_size: int | None = None) -> float:
    """Effective MACs of the supernet under channel masks — the 'remaining
    FLOPs' number the AtomNAS shrink loop logs (SURVEY.md §3.2). Exact for
    atom removal (expand/dw/SE/project terms all scale per-channel)."""
    prof = profile_network(net, image_size)
    total = float(prof.total_macs)
    for i, cost in prof.atom_costs.items():
        m = masks.get(i)
        if m is not None:
            dead = 1.0 - np.asarray(m, dtype=np.float64)
            total -= float(np.dot(cost, dead))
    return total

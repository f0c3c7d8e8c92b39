"""Activation zoo: the torch twin of ``yet_another_mobilenet_series_tpu/ops/activations.py``.

Every piecewise-linear form is written exactly as the MobileNetV3 paper
defines it (h-swish = x*relu6(x+3)/6), with the same operation order as the
JAX package, so the two agree to f32 rounding. The name table is the same;
the CUDA kernel (``csrc/fused_depthwise.cu``) switches on ``ACT_CODES``.
"""

from __future__ import annotations

import torch


def relu(x):
    return torch.clamp_min(x, 0)


def relu6(x):
    return torch.clamp(x, 0, 6)


def hsigmoid(x):
    return relu6(x + 3.0) * (1.0 / 6.0)


def hswish(x):
    return x * relu6(x + 3.0) * (1.0 / 6.0)


def sigmoid(x):
    # torch.sigmoid is numerically stable in both directions (a hand-rolled
    # 1/(1+exp(-x)) overflows exp(-x) at x < -88 in f32)
    return torch.sigmoid(x)


def swish(x):
    # a.k.a. SiLU; used by the AtomNAS "+" variants
    return x * torch.sigmoid(x)


def identity(x):
    return x


_ACTIVATIONS = {
    "relu": relu,
    "relu6": relu6,
    "hswish": hswish,
    "h_swish": hswish,
    "hsigmoid": hsigmoid,
    "h_sigmoid": hsigmoid,
    "swish": swish,
    "silu": swish,
    "sigmoid": sigmoid,
    "identity": identity,
    "linear": identity,
}

# integer codes of the activation switch in csrc/fused_depthwise.cu; every
# name of the table above has one (aliases share their function's code)
ACT_CODES = {
    "identity": 0, "linear": 0,
    "relu": 1,
    "relu6": 2,
    "hswish": 3, "h_swish": 3,
    "hsigmoid": 4, "h_sigmoid": 4,
    "swish": 5, "silu": 5,
    "sigmoid": 6,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}") from None

"""The controls of the comparison: the plain reference put in the program's place and computed in
the precision just below the one the configuration states.

- bfloat16 training: FP8 (e4m3) operands in every convolution and dense layer of the forward,
  each tensor scaled by its own amax to e4m3's largest value, as an FP8 training recipe scales
  it; products and sums stay float32, and the backward passes the gradient straight through the
  rounding;
- float32 serving with TF32 off: the same float32 reference with TF32 on in cuDNN and in matmul.
"""

from __future__ import annotations

import contextlib

import torch

from . import nets

E4M3_MAX = 448.0


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)


class Fp8Ops(nets.Ops):
    def conv(self, x, w, stride: int, groups: int):
        return super().conv(fp8(x), fp8(w), stride, groups)

    def linear(self, x, w, b):
        return super().linear(fp8(x), fp8(w), b)


FP8 = Fp8Ops()


class Bf16Ops(nets.Ops):
    """Not a control but a witness: the reference in the program's own precision, bfloat16
    operands and outputs in every convolution and dense layer (so their gradients are bfloat16
    too), float32 elsewhere. Against the float32 reference it reads the gaps that bfloat16's
    rounding alone makes."""

    def conv(self, x, w, stride: int, groups: int):
        return super().conv(x.bfloat16(), w.bfloat16(), stride, groups).float()

    def linear(self, x, w, b):
        return super().linear(x.bfloat16(), w.bfloat16(), b.bfloat16()).float()


BF16 = Bf16Ops()


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuDNN's convolutions and in matmul set to ``on`` inside, restored after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before

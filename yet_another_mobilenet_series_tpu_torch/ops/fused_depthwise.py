"""Fused depthwise conv + affine + activation + mask: the port of the JAX
package's one TPU kernel (``yet_another_mobilenet_series_tpu/ops/pallas_kernels.py``:
``_dw_kernel`` launched by ``_fused_dw_fwd`` through ``pl.pallas_call``,
public entry ``fused_depthwise_inference``).

    y = act(dwconv(x, w; k x k, stride s, zero pad k//2) * scale + shift) * mask

accumulated in float32, with the output in x's dtype. x is NHWC; w is
(k, k, C) float32; scale, shift and mask are (C,) float32.

Three things live here, as for every kernel of the port:

- :func:`fused_depthwise` — the wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel (``csrc/fused_depthwise.cu``, built by
  ``ops/cuda_build.py``) on PyTorch's current stream, or raises; it has no
  fallback. On a CPU tensor it computes the plain version, because the
  tensor lies on the CPU. It counts its kernel launches in
  ``fused_depthwise.launches``. It is a ``torch.autograd.Function`` whose
  backward recomputes through the plain version, as the JAX ``_vjp_bwd``
  differentiates ``_reference_fwd``.
- :func:`fused_depthwise_reference` — the plain version: ``F.conv2d`` with
  ``groups=C`` in float32, then the affine, the activation and the mask.
  The CPU tests and chip_smoke.py's comparison on the card use it; nothing
  on the main path calls it when a card is present.

What bounds the kernel on an H100: bytes. It does about 2*k*k flops per
output element against 4 (f32) or 2 (bf16) bytes read and written per
element, far below the card's ratio of compute to bandwidth. A batch-32 f32
MobileNetV3-Large forward moves 483.9 MB through its 15 launches (each input
read once, each output written once), so its least time on an NVIDIA H100
80GB HBM3 (SXM, 3.35 TB/s published) is 0.144 ms. chip_smoke.py measures
the kernel against that bound; PERF.md records both with the card's name
and power limit. This first kernel is the simple design that is right and
runs about 9x above the bound; tiling it is later work.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import cuda_build
from .activations import ACT_CODES, get_activation

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and given its ctypes signature on first
    use (never at import). Every pointer and the stream are c_void_p: as a
    default int, ctypes would cut them to 32 bits."""
    lib = cuda_build.load("fused_depthwise")
    fn = lib.yamt_fused_depthwise
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.yamt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yamt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def out_size(size: int, stride: int) -> int:
    """Output height/width of a symmetric k//2-padded odd-k conv."""
    return (size - 1) // stride + 1


def fused_depthwise_reference(x, w, scale, shift, mask, stride: int = 1, act: str = "relu6"):
    """The plain PyTorch version of the kernel (and its backward's recompute
    path): x (N, H, W, C) -> (N, OH, OW, C) in x's dtype."""
    k = w.shape[0]
    c = x.shape[-1]
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.float().permute(2, 0, 1).unsqueeze(1)  # (k, k, C) -> (C, 1, k, k)
    y = F.conv2d(xf, wf, stride=stride, padding=k // 2, groups=c)
    y = y * scale.float()[:, None, None] + shift.float()[:, None, None]
    y = get_activation(act)(y) * mask.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _check_cuda_operands(x, w, scale, shift, mask, stride: int, act: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_depthwise: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"fused_depthwise: x must be a contiguous NHWC tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    k = w.shape[0] if w.dim() == 3 else -1
    if w.dim() != 3 or w.shape != (k, k, c) or k % 2 == 0:
        raise ValueError(f"fused_depthwise: w must be (k, k, {c}) with odd k, got {tuple(w.shape)}")
    for name, t in (("w", w), ("scale", scale), ("shift", shift), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"fused_depthwise: {name} must be contiguous float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_depthwise: {name} is on {t.device}, x on {x.device}")
    for name, t in (("scale", scale), ("shift", shift), ("mask", mask)):
        if t.shape != (c,):
            raise ValueError(f"fused_depthwise: {name} must be ({c},), got {tuple(t.shape)}")
    if stride < 1:
        raise ValueError(f"fused_depthwise: stride must be >= 1, got {stride}")
    if act not in ACT_CODES:
        raise ValueError(f"fused_depthwise: unknown activation {act!r}; known: {sorted(ACT_CODES)}")
    if x.numel() >= 2**31:
        raise ValueError("fused_depthwise: x has 2**31 elements or more")


def _launch(x, w, scale, shift, mask, stride: int, act: str):
    """Launch the CUDA kernel on the current stream; raises on any refusal."""
    _check_cuda_operands(x, w, scale, shift, mask, stride, act)
    lib = _lib()
    n, h, wd, c = x.shape
    k = w.shape[0]
    y = torch.empty((n, out_size(h, stride), out_size(wd, stride), c), dtype=x.dtype, device=x.device)
    # the launch goes to the calling thread's current device: make it x's
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.yamt_fused_depthwise(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), mask.data_ptr(), y.data_ptr(),
            n, h, wd, c, k, int(stride), ACT_CODES[act], _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        msg = lib.yamt_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_depthwise kernel launch failed: {msg} (cudaError {err}) "
                           f"for x {tuple(x.shape)} {x.dtype}, k={k}, stride={stride}, act={act}")
    with _COUNT_LOCK:
        fused_depthwise.launches += 1
    return y


def _forward(x, w, scale, shift, mask, stride: int, act: str):
    if x.device.type == "cuda":
        return _launch(x, w, scale, shift, mask, stride, act)
    if x.device.type == "cpu":
        return fused_depthwise_reference(x, w, scale, shift, mask, stride, act)
    raise RuntimeError(f"fused_depthwise: no kernel for device {x.device}")


class _FusedDepthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, mask, stride, act):
        ctx.save_for_backward(x, w, scale, shift, mask)
        ctx.stride, ctx.act = stride, act
        return _forward(x, w, scale, shift, mask, stride, act)

    @staticmethod
    def backward(ctx, g):
        # correctness-first backward, as the JAX _vjp_bwd: differentiate the
        # plain version at the saved inputs
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, wanted)]
            y = fused_depthwise_reference(*inputs, ctx.stride, ctx.act)
            diff = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, diff, g)) if diff else iter(())
        return (*[next(grads) if need else None for need in wanted], None, None)


def fused_depthwise(x, w, scale, shift, mask, stride: int = 1, act: str = "relu6"):
    """Fused dw-conv + affine + activation + mask (see the module docstring).

    Args:
      x: (N, H, W, C) float32 or bfloat16, contiguous.
      w: (k, k, C) float32 depthwise taps, k odd.
      scale, shift: (C,) float32 (the folded BN; ones and the bias for a
        folded conv); mask: (C,) float32 AtomNAS atom mask (ones when unused).
    """
    return _FusedDepthwise.apply(x, w, scale, shift, mask, int(stride), act)


# kernel launches since the count was last set to 0 (CUDA tensors only)
fused_depthwise.launches = 0

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
  ``fused_depthwise.launches``. Where an input needs a gradient it goes
  through a ``torch.autograd.Function`` whose backward recomputes through
  the plain version, as the JAX ``_vjp_bwd`` differentiates
  ``_reference_fwd``.
- :func:`fused_depthwise_reference` — the plain version: ``F.conv2d`` with
  ``groups=C`` in float32, then the affine, the activation and the mask.
  The CPU tests and chip_smoke.py's comparison on the card use it; nothing
  on the main path calls it when a card is present.

What bounds the kernel on an H100: bytes. It does about 2*k*k flops per
output element against 4 (f32) or 2 (bf16) bytes read and written per
element, far below the card's ratio of compute to bandwidth. A batch-32 f32
MobileNetV3-Large forward moves 483.9 MB through its 15 launches (each input
read once, each output written once), so its least time on an NVIDIA H100
80GB HBM3 (SXM, 3.35 TB/s published) is 0.144 ms. The kernel stages a halo
tile of the input in shared memory by 16-byte asynchronous copies and
computes a strip of outputs per thread from it (``csrc/fused_depthwise.cu``);
:func:`plan` chooses the tile per shape. chip_smoke.py measures the kernel
against its bound and cuDNN's depthwise conv; PERF.md records the numbers
with the card's name and power limit.

x and ``out`` may be channel slices of wider NHWC tensors
(``t[..., off:off + c]`` of a contiguous tensor): the kernel reads and
writes them in place through their pixel pitch, so the branches of an
AtomNAS block need no slice copy and no concatenation.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_build
from .activations import ACT_CODES, get_activation

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()

# the card the plan is made for: an H100 has 132 SMs with 227 KB of shared
# memory a block can use and 2048 resident threads each
SMS = 132
SM_SMEM = 227 * 1024
SM_THREADS = 2048
MAX_THREADS = 256  # the kernel's __launch_bounds__
# shared memory the plan aims under: the most a launch takes without the
# dynamic-shared-memory attribute, which leaves room for four resident
# blocks on an SM; a tile needs more only for very large k or stride
SMEM_DEFAULT = 48 * 1024
# the plan's cost model, in bytes moved by one SM: a block's fixed cost
# (scheduling, the barrier) and one round of resident blocks' latency
# (about 2 us at an SM's share of 3.35 TB/s)
BLOCK_COST = 4 * 1024
ROUND_COST = 48 * 1024


@dataclass(frozen=True)
class Plan:
    """How one launch tiles its output: blocks of ``th`` x ``tw`` output
    pixels of one image by ``cb`` channels, ``threads`` threads each, each
    thread computing ``r`` consecutive columns of one row for ``vec``
    channels at a time (``vec`` = 1: the scalar path). ``pad`` and
    ``row_pitch`` lay out the staged input tile (:func:`staged_layout`); the
    kernel takes them from the plan."""

    vec: int
    r: int
    th: int
    tw: int
    cb: int
    threads: int
    smem: int  # bytes of dynamic shared memory a block declares
    pad: int
    row_pitch: int
    tiles_h: int
    tiles_w: int
    chunks: int
    blocks: int


def out_size(size: int, stride: int) -> int:
    """Output height/width of a symmetric k//2-padded odd-k conv."""
    return (size - 1) // stride + 1


def strip_width(vec: int) -> int:
    """Output columns per thread (the kernel's ``strip_width``): 32 sums a
    thread, as 8 columns of 4 float32 channels or of 1 scalar channel, or 4
    columns of 8 bfloat16 channels."""
    return 4 if vec == 8 else 8


def staged_layout(tw: int, cb: int, k: int, stride: int, vec: int) -> tuple[int, int]:
    """(pad, row pitch) of the staged input tile, in staged elements, which
    the kernel takes from the plan. A warp's thread t reads channel vector
    t % nvec of strip t // nvec; strips are r*stride columns apart, so each
    group of that many columns is followed by ``pad`` units (16 bytes, or 4
    on the scalar path) that make a strip's stride congruent to nvec modulo
    the 8 (32) units the shared-memory banks span, and the row pitch is
    padded likewise where the stride allows: the loads of a warp fall on
    distinct banks."""
    banks = 8 if vec > 1 else 32
    nvec = cb // vec
    group = strip_width(vec) * stride
    pad = (nvec * (1 - group)) % banks
    iw = (tw - 1) * stride + k
    row = (iw - 1) * nvec + ((iw - 1) // group) * pad + nvec
    row_items = (tw // strip_width(vec)) * nvec
    if stride == 1:
        row += (row_items - row) % banks
    elif stride == 2 and row_items % 2 == 0:
        row += (row_items // 2 - row) % (banks // 2)
    return pad * vec, row * vec


def smem_bytes(th: int, row_pitch: int, cb: int, k: int, stride: int, staged_itemsize: int) -> int:
    """Shared memory of one block: the input tile with its halo, rows
    ``row_pitch`` staged elements apart (:func:`staged_layout`), then the
    (k, k, cb) taps and the cb-wide scale, shift and mask in float32."""
    return ((th - 1) * stride + k) * row_pitch * staged_itemsize + (k * k + 3) * cb * 4


def tilings(n: int, h: int, w: int, c: int, k: int, stride: int, itemsize: int, vector: bool = True):
    """Every tiling :func:`plan` weighs, as (modelled cost, Plan) pairs.

    The channel chunk keeps 64 to 512 bytes of a pixel together, in whole
    32-byte sectors (all the channels where they are fewer). The spatial tile is
    up to 16 strips wide and 64 rows high. The cost is the bytes that the
    busiest SM stages (halo included) and writes, plus a fixed cost per
    block and a latency per round of resident blocks."""
    vec = 16 // itemsize if vector else 1
    r = strip_width(vec)
    staged = itemsize if vector else 4
    step = max(vec, 32 // itemsize) if vector else 1
    oh, ow = out_size(h, stride), out_size(w, stride)
    whole = -(-c // vec) * vec
    widths = {whole} if whole * staged <= 512 else set()
    for chunks in range(2, -(-c // step) + 1):
        cb = -(-math.ceil(c / chunks) // step) * step
        if cb * staged < 64:
            break
        if cb * staged <= 512:
            widths.add(cb)
    if not widths:
        widths.add(step)
    for cb in sorted(widths):
        chunks = math.ceil(c / cb)
        for tw in range(r, min(-(-ow // r) * r, 16 * r) + 1, r):
            pad, row_pitch = staged_layout(tw, cb, k, stride, vec)
            for th in range(1, min(oh, 64) + 1):
                smem = smem_bytes(th, row_pitch, cb, k, stride, staged)
                items = th * (tw // r) * (cb // vec)
                threads = min(MAX_THREADS, -(-items // 32) * 32)
                blocks = n * math.ceil(oh / th) * math.ceil(ow / tw) * chunks
                resident = max(1, min(SM_SMEM // (smem + 1024), SM_THREADS // threads, 32))
                work = smem - (k * k + 3) * cb * 4 + th * tw * cb * itemsize + BLOCK_COST
                cost = math.ceil(blocks / SMS) * work + math.ceil(blocks / (SMS * resident)) * ROUND_COST
                yield cost, Plan(vec, r, th, tw, cb, threads, smem, pad, row_pitch, math.ceil(oh / th),
                                 math.ceil(ow / tw), chunks, blocks)


@functools.lru_cache(maxsize=4096)
def plan(n: int, h: int, w: int, c: int, k: int, stride: int, itemsize: int, vector: bool = True) -> Plan:
    """The tiling of one launch, cached per shape: of :func:`tilings`, the
    least modelled cost among those whose block fits ``SMEM_DEFAULT`` (the
    smallest block when none does). ``vector`` says whether the operands
    allow 16-byte access (:func:`vector_ok`). So narrow, large images get
    wide spatial tiles over all channels, small images a whole image per
    channel chunk, and a small batch smaller tiles, until the blocks cover
    the SMs."""
    best = min(tilings(n, h, w, c, k, stride, itemsize, vector),
               key=lambda cp: (cp[1].smem > SMEM_DEFAULT, cp[1].smem if cp[1].smem > SMEM_DEFAULT else cp[0],
                               -cp[1].th * cp[1].tw * cp[1].cb))[1]
    if best.smem > SM_SMEM:
        raise ValueError(f"fused_depthwise: no tile of k={k}, stride={stride} fits in shared memory")
    return best


def pixel_pitch(t: torch.Tensor, name: str = "x") -> int:
    """Elements from one pixel to the next of an NHWC tensor that is
    contiguous or a channel slice ``u[..., off:off + c]`` of a contiguous
    one; raises for any other layout."""
    if t.dim() != 4:
        raise ValueError(f"fused_depthwise: {name} must be a contiguous NHWC tensor or a channel slice of one, "
                         f"got shape {tuple(t.shape)}")
    if t.is_contiguous():
        return t.shape[-1]
    n, h, w, c = t.shape
    s0, s1, s2, s3 = t.stride()
    if not (s3 == 1 and s2 >= c and s1 == w * s2 and s0 == h * s1):
        raise ValueError(f"fused_depthwise: {name} must be a contiguous NHWC tensor or a channel slice of one, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    return s2


def vector_ok(x: torch.Tensor, y: torch.Tensor, x_pitch: int | None = None, y_pitch: int | None = None) -> bool:
    """Whether x and y allow 16-byte access: C, both pixel pitches and both
    channel offsets (through the pointers) in whole 16-byte vectors. The
    pitches are :func:`pixel_pitch`'s, computed here unless given."""
    vec = 16 // x.element_size()
    x_pitch = pixel_pitch(x) if x_pitch is None else x_pitch
    y_pitch = pixel_pitch(y, "out") if y_pitch is None else y_pitch
    return (x.shape[-1] % vec == 0 and x_pitch % vec == 0 and y_pitch % vec == 0
            and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)


def launch_plan(x: torch.Tensor, k: int, stride: int, y: torch.Tensor, x_pitch: int | None = None,
                y_pitch: int | None = None) -> Plan:
    """The plan a launch from x into y takes."""
    n, h, w, c = x.shape
    return plan(n, h, w, c, k, stride, x.element_size(), vector_ok(x, y, x_pitch, y_pitch))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give a library built from ``csrc/fused_depthwise.cu`` its ctypes
    signature. Every pointer and the stream are c_void_p: as a default int,
    ctypes would cut them to 32 bits. The integers go as one array
    (:func:`_int_args`), made once per shape, so that a call converts none
    of them: the wrapper's host cost paces launches that take the device
    less time than the host (PERF.md)."""
    fn = lib.yamt_fused_depthwise
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    lib.yamt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.yamt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and bound on first use (never at import)."""
    return bind(cuda_build.load("fused_depthwise"))


# the order of the kernel's integer arguments (yamt_fused_depthwise's args)
INT_ARGS = ("device", "n", "h", "wd", "c", "k", "stride", "act", "dtype", "x_pitch", "y_pitch", "th", "tw", "cb",
            "threads", "vec", "smem_bytes", "pad", "row_pitch")


def _int_args(device, n, h, wd, c, k, stride, act, dtype, x_pitch, y_pitch, p: Plan) -> ctypes.Array:
    return (ctypes.c_int * len(INT_ARGS))(device, n, h, wd, c, k, stride, act, dtype, x_pitch, y_pitch, p.th, p.tw,
                                          p.cb, p.threads, p.vec, p.smem, p.pad, p.row_pitch)


@functools.lru_cache(maxsize=4096)
def _planned_args(device, n, h, wd, c, k, stride, act, dtype, x_pitch, y_pitch, itemsize,
                  vector) -> tuple[Plan, ctypes.Array]:
    """The plan of one launch shape and its integer arguments, made once."""
    p = plan(n, h, wd, c, k, stride, itemsize, vector)
    return p, _int_args(device, n, h, wd, c, k, stride, act, dtype, x_pitch, y_pitch, p)


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


def _check_cuda_operands(x, w, scale, shift, mask, stride: int, act: str) -> int:
    """Raises on what the kernel does not take; returns x's pixel pitch."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_depthwise: x must be float32 or bfloat16, got {x.dtype}")
    pitch = pixel_pitch(x)
    c = x.shape[-1]
    k = w.shape[0] if w.dim() == 3 else -1
    if w.shape != (k, k, c) or k % 2 == 0:
        raise ValueError(f"fused_depthwise: w must be (k, k, {c}) with odd k, got {tuple(w.shape)}")
    # the device as an index: cheaper to read than a torch.device
    device = x.get_device()
    for name, t in (("w", w), ("scale", scale), ("shift", shift), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"fused_depthwise: {name} must be contiguous float32, got {t.dtype}")
        if t.get_device() != device:
            raise ValueError(f"fused_depthwise: {name} is on {t.device}, x on {x.device}")
    if scale.shape != (c,) or shift.shape != (c,) or mask.shape != (c,):
        raise ValueError(f"fused_depthwise: scale, shift and mask must be ({c},), got {tuple(scale.shape)}, "
                         f"{tuple(shift.shape)} and {tuple(mask.shape)}")
    if stride < 1:
        raise ValueError(f"fused_depthwise: stride must be >= 1, got {stride}")
    if act not in ACT_CODES:
        raise ValueError(f"fused_depthwise: unknown activation {act!r}; known: {sorted(ACT_CODES)}")
    if x.shape[0] * x.shape[1] * x.shape[2] * pitch >= 2**31:
        raise ValueError("fused_depthwise: x spans 2**31 elements or more")
    return pitch


def _check_out(out, x, stride: int) -> int:
    """Raises unless ``out`` can take the result; returns its pixel pitch."""
    n, h, w, c = x.shape
    want = (n, out_size(h, stride), out_size(w, stride), c)
    if out.shape != want or out.dtype != x.dtype or out.get_device() != x.get_device():
        raise ValueError(f"fused_depthwise: out must be {want} {x.dtype} on {x.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    pitch = pixel_pitch(out, "out")
    if want[0] * want[1] * want[2] * pitch >= 2**31:
        raise ValueError("fused_depthwise: out spans 2**31 elements or more")
    return pitch


def _launch(x, w, scale, shift, mask, stride: int, act: str, out=None, tile: Plan | None = None):
    """Launch the CUDA kernel on the current stream, into ``out`` when it is
    given; raises on any refusal. ``tile`` overrides the plan (for tuning)."""
    x_pitch = _check_cuda_operands(x, w, scale, shift, mask, stride, act)
    lib = _lib()
    n, h, wd, c = x.shape
    k = w.shape[0]
    if out is None:
        y, y_pitch = x.new_empty((n, out_size(h, stride), out_size(wd, stride), c)), c
    else:
        y, y_pitch = out, _check_out(out, x, stride)
    device = x.get_device()
    shape = (device, n, h, wd, c, k, int(stride), ACT_CODES[act], _DTYPE_CODES[x.dtype], x_pitch, y_pitch)
    if tile is None:
        p, args = _planned_args(*shape, x.element_size(), vector_ok(x, y, x_pitch, y_pitch))
    else:
        p, args = tile, _int_args(*shape, tile)
    # PyTorch's current stream on x's device, as torch.cuda.current_stream(
    # device).cuda_stream gives it but without building a Stream object; the
    # C entry makes x's device current around the launch
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = lib.yamt_fused_depthwise(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), mask.data_ptr(),
                                   y.data_ptr(), args, stream)
    if err != 0:
        msg = lib.yamt_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_depthwise kernel launch failed: {msg} (cudaError {err}) "
                           f"for x {tuple(x.shape)} {x.dtype}, k={k}, stride={stride}, act={act}, {p}")
    with _COUNT_LOCK:
        fused_depthwise.launches += 1
    return y


def _forward(x, w, scale, shift, mask, stride: int, act: str, out=None):
    if x.is_cuda:
        return _launch(x, w, scale, shift, mask, stride, act, out)
    if x.device.type == "cpu":
        y = fused_depthwise_reference(x, w, scale, shift, mask, stride, act)
        if out is None:
            return y
        _check_out(out, x, stride)
        return out.copy_(y)
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


def fused_depthwise(x, w, scale, shift, mask, stride: int = 1, act: str = "relu6", out=None):
    """Fused dw-conv + affine + activation + mask (see the module docstring).

    Args:
      x: (N, H, W, C) float32 or bfloat16, contiguous or a channel slice of
        a contiguous NHWC tensor.
      w: (k, k, C) float32 depthwise taps, k odd.
      scale, shift: (C,) float32 (the folded BN; ones and the bias for a
        folded conv); mask: (C,) float32 AtomNAS atom mask (ones when unused).
      out: optional (N, OH, OW, C) tensor of x's dtype, contiguous or a
        channel slice of a contiguous one, that receives the result in
        place; it records no gradient, so it refuses inputs that need one.

    Where an input needs a gradient, the call goes through the
    ``autograd.Function``; otherwise (inference) straight to the launch.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, scale, shift, mask)):
        if out is not None:
            raise RuntimeError("fused_depthwise: out= records no gradient; call it without out= to differentiate")
        return _FusedDepthwise.apply(x, w, scale, shift, mask, int(stride), act)
    # nothing to differentiate: skip the autograd.Function and its host cost
    return _forward(x, w, scale, shift, mask, int(stride), act, out)


# kernel launches since the count was last set to 0 (CUDA tensors only)
fused_depthwise.launches = 0

"""Bucketed inference engine: the torch twin of ``yet_another_mobilenet_series_tpu/serve/engine.py``.

The engine fixes a small ladder of batch **buckets** (e.g. 1/8/32) and an
**image-size ladder**, and dispatches every batch to the smallest bucket
that fits, zero-padding the tail rows and slicing them back off the logits.
Padding is sound because the folded forward is row-independent (the fold
removed BN), so the real rows' logits are bitwise identical to an unpadded
run of the same bucket. A request larger than the biggest bucket becomes
chunks of the biggest bucket, as the JAX engine does with ``fuse_ladder=()``.

:meth:`InferenceEngine.predict_async` stages and dispatches every piece of
a request and returns a :class:`PendingPrediction` without synchronizing:
PyTorch enqueues the forward's kernels on the card's stream and returns, so
the device computes while the host stages the next piece. The one
host<->device sync is :meth:`PendingPrediction.result` (a once-latch, safe
under concurrent callers). ``predict`` is ``predict_async(...).result()``.

Tail padding writes into a **reused per-(bucket, size) staging buffer**:
no allocation per dispatch, and only the pad rows are re-zeroed. Reuse right
after dispatch is safe because the host-to-device copy is synchronous in
this slice (``tensor.to(device)`` from pageable memory returns after the
copy has read the host buffer), exactly the reason the JAX engine's legacy
path gives. Pinned buffers with async copies and CUDA-event fences are
queue 1b, S2 of ROADMAP.md.

Every depthwise stage of the forward runs the fused Hopper kernel
(``ops/fused_depthwise.py``) when the engine's device is ``cuda``.

Not ported yet, and refused with a ``ValueError`` naming its ROADMAP item:
a data-parallel ``mesh``, a non-empty ``fuse_ladder``, ``overlap_staging``,
``ring_slots``, the uint8 wire, int8 weights and more than one model.

Instrumentation: ``serve.dispatch_seconds`` (host stage+dispatch per
piece), ``serve.dispatch_to_complete_seconds``, ``serve.run_seconds``,
``serve.h2d_seconds``, ``serve.compile_seconds`` (one warmup forward per
(bucket, size): the first run's cost on the card, which includes cuDNN's
algorithm choice), ``serve.infer_images`` / ``serve.padded_rows`` /
``serve.bucket_hits.<b>``, and ``serve/stage``, ``serve/h2d``,
``serve/dispatch`` and ``serve/complete`` spans.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from ..models.specs import Network
from ..obs import device as obs_device
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.device import resolve_device
from . import quant
from .export import InferenceBundle, apply_folded, prepare_folded

# the implicit model name of a single-bundle engine (the JAX engine's)
DEFAULT_MODEL = "default"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PendingPrediction:
    """Device-side handle returned by :meth:`InferenceEngine.predict_async`.

    Holds the dispatched-but-unsynced logits of every piece; ``result()`` is
    the ONE host<->device sync (copy to host, slice off pad rows, concat)
    and caches its value. A once-latch serializes concurrent callers:
    exactly one performs the sync and everyone gets the same cached array.
    ``dispatches`` counts the engine pieces behind the handle.
    """

    __slots__ = ("_engine", "_parts", "_t_start", "_t_dispatched", "_out", "_lock", "_ctxs",
                 "dispatches")

    def __init__(self, engine: "InferenceEngine", parts, t_start: float, t_dispatched: float, ctxs=()):
        self._engine = engine
        self._parts = parts  # [(device_logits, real_rows), ...]
        self.dispatches = len(parts)
        self._t_start = t_start
        self._t_dispatched = t_dispatched
        self._out: np.ndarray | None = None
        self._ctxs = tuple(ctxs)
        self._lock = threading.Lock()

    def result(self) -> np.ndarray:
        """Block until every piece's logits are on host; (N, num_classes)."""
        with self._lock:
            if self._out is None:
                reg = self._engine._reg
                with obs_trace.get_tracer().span("serve/complete", "serve", pieces=len(self._parts)):
                    outs = [dev.cpu().numpy()[:rows] for dev, rows in self._parts]
                    for c in self._ctxs:
                        c.advance("completed")
                now = time.perf_counter()
                reg.histogram("serve.dispatch_to_complete_seconds").observe(now - self._t_dispatched)
                reg.histogram("serve.run_seconds").observe(now - self._t_start)
                self._out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
                self._parts = ()  # drop the device references as soon as synced
            return self._out


class InferenceEngine:
    """Serving wrapper around a loaded :class:`InferenceBundle` on one device.

    ``predict(images)`` accepts any batch size: requests larger than the
    biggest bucket are served in chunks of that bucket, everything else is
    padded up to the smallest fitting bucket. ``predict_async`` is the
    no-sync variant the pipelined batcher drives. A size off the
    ``image_sizes`` ladder is served too; its staging buffers live in a
    bounded LRU (``offladder_cache``).
    """

    def __init__(
        self,
        bundle: InferenceBundle | None = None,
        *,
        models: dict[str, InferenceBundle] | None = None,
        buckets: Sequence[int] = (1, 8, 32),
        compute_dtype: str = "float32",
        device: str | torch.device = "cuda",
        mesh=None,
        image_size: int | None = None,
        image_sizes: Sequence[int] | None = None,
        fuse_ladder: Sequence[int] = (),
        offladder_cache: int = 8,
        overlap_staging: bool = False,
        ring_slots: int = 0,
        wire: str = "float32",
    ):
        if mesh is not None:
            raise ValueError("mesh: data-parallel serving is not ported yet (ROADMAP queue 1, item 8: data parallel)")
        if fuse_ladder:
            raise ValueError(f"fuse_ladder={tuple(fuse_ladder)}: fused multi-chunk dispatch is not ported yet "
                             "(ROADMAP queue 1b, S1: the fused-K ladder); pass fuse_ladder=()")
        if overlap_staging:
            raise ValueError("overlap_staging: overlapped staging is not ported yet "
                             "(ROADMAP queue 1b, S2: pinned buffers, async H2D, CUDA-event fences)")
        if ring_slots:
            raise ValueError(f"ring_slots={ring_slots}: the device-resident request ring is not ported yet "
                             "(ROADMAP queue 1b, S3: the request ring)")
        if wire != "float32":
            quant.wire_np_dtype(wire)  # an unknown name fails as in the JAX engine
            raise ValueError(f"wire={wire!r}: the uint8 wire is not ported yet "
                             "(ROADMAP queue 1b, S4: uint8 wire and int8 weights)")
        if models is not None:
            raise ValueError(f"models={sorted(models)}: multi-model serving is not ported yet "
                             "(ROADMAP queue 1b, S5: the model zoo); pass one bundle")
        if bundle is None:
            raise ValueError("engine needs a bundle")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(_DTYPES)}, got {compute_dtype!r}")
        if not buckets:
            raise ValueError("engine needs at least one batch bucket")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"batch buckets must be >= 1, got {self.buckets}")
        if offladder_cache < 1:
            raise ValueError(f"offladder_cache must be >= 1, got {offladder_cache}")
        self.device = resolve_device(device)
        self._compute_dtype = _DTYPES[compute_dtype]
        if self.device.type == "cuda" and self._compute_dtype == torch.float32:
            # cuDNN runs float32 convolutions in TF32 by default (about three
            # decimal digits), which would break the float32 parity with the
            # JAX reference and the CPU forward: turn TF32 off for cuDNN and
            # for matmul. These flags are process-wide in PyTorch.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.net: Network = bundle.net
        self.image_size = int(image_size) if image_size else int(bundle.net.image_size)
        self.image_sizes = tuple(sorted(set(int(s) for s in (image_sizes or ())) | {self.image_size}))
        if self.image_sizes[0] < 1:
            raise ValueError(f"image sizes must be >= 1, got {self.image_sizes}")
        self.fuse_ladder: tuple[int, ...] = ()
        self._offladder_cap = int(offladder_cache)
        # the folded tree as the forward reads it, on the device, made once
        # here and never per call (the kernel's (k, k, C) taps included)
        self._params = prepare_folded(self.net, bundle.params, device=self.device,
                                      compute_dtype=self._compute_dtype)
        # staging buffers keyed (bucket, size); off-ladder sizes in an LRU
        self._staging: dict[tuple[int, int], np.ndarray] = {}
        self._offladder: OrderedDict[tuple[int, int], None] = OrderedDict()
        # one dispatcher at a time: staging buffers are reused across calls
        self._dispatch_lock = threading.Lock()
        # guards _staging/_offladder mutation + LRU bookkeeping
        self._cache_lock = threading.Lock()
        self._reg = get_registry()
        obs_device.install_memory_gauges(self._reg)

    # -- the surface the batchers and the CLI read --------------------------

    # the request ring is not ported (ROADMAP queue 1b, S3): 0 keeps the
    # pipelined batcher on the per-batch path
    ring_slots = 0

    @property
    def wire_np_dtype(self):
        """numpy dtype the batchers coerce client images to (the f32 wire)."""
        return np.float32

    @property
    def quant_mode(self) -> str:
        """The ``serve.quant_mode`` build-info label (docs/OBSERVABILITY.md)."""
        return "wire=float32,weights=float32"

    # -- forward ------------------------------------------------------------

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return apply_folded(self.net, self._params, x, compute_dtype=self._compute_dtype)

    def warmup(self) -> None:
        """Run each (bucket, image_size) of the ladder once and time it into
        ``serve.compile_seconds``: the first run on the card pays cuDNN's
        algorithm choice and the kernel library's load, so the first request
        of any ladder shape does not."""
        for s in self.image_sizes:
            for b in self.buckets:
                t0 = time.perf_counter()
                with obs_trace.get_tracer().span("serve/compile", "serve", bucket=b, image_size=s, k=1):
                    x = torch.zeros((b, s, s, 3), dtype=torch.float32, device=self.device)
                    self._forward(x).cpu()
                self._reg.histogram("serve.compile_seconds").observe(time.perf_counter() - t0)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- dispatch -----------------------------------------------------------

    def _plan(self, n: int) -> list[tuple[int, int, int]]:
        """Split an N-row request into dispatch pieces ``(start, rows,
        bucket)``, in row order: chunks of the biggest bucket, the tail into
        the smallest bucket that fits it."""
        cap = self.buckets[-1]
        pieces = []
        for start in range(0, n, cap):
            rows = min(cap, n - start)
            pieces.append((start, rows, self._bucket_for(rows)))
        return pieces

    def _stage(self, rows_arr: np.ndarray, bucket: int, size: int) -> np.ndarray:
        """Bucket-shaped host array for a piece's rows: the rows themselves
        when they fill the bucket, else the (bucket, size) staging buffer with
        the rows copied in and only the pad rows zeroed."""
        n = rows_arr.shape[0]
        if n == bucket:
            return np.ascontiguousarray(rows_arr)
        key = (bucket, size)
        with self._cache_lock:
            buf = self._staging.get(key)
            if buf is None:
                buf = self._staging[key] = np.zeros((bucket, size, size, 3), np.float32)
            if size not in self.image_sizes:
                self._offladder[key] = None
                self._offladder.move_to_end(key)
                while len(self._offladder) > self._offladder_cap:
                    old, _ = self._offladder.popitem(last=False)
                    self._staging.pop(old, None)
                    self._reg.counter("serve.evicted_executables").inc()
        buf[:n] = rows_arr
        buf[n:] = 0
        self._reg.counter("serve.padded_rows").inc(bucket - n)
        return buf

    def _dispatch_piece(self, images: np.ndarray, piece: tuple[int, int, int], size: int, ctxs=()):
        """Stage + copy + dispatch ONE piece; returns (device_logits,
        real_rows) without synchronizing."""
        start, rows, bucket = piece
        tracer = obs_trace.get_tracer()
        t0 = time.perf_counter()
        with tracer.span("serve/stage", "serve", bucket=bucket, rows=rows, k=1):
            staged = self._stage(images[start: start + rows], bucket, size)
            t_h2d = time.perf_counter()
            with tracer.span("serve/h2d", "serve", bucket=bucket, k=1, overlap=False):
                # synchronous copy from pageable memory: the staging buffer is
                # reusable the moment this returns (on the CPU device the
                # copy is explicit, so the buffer is never aliased either)
                x = torch.from_numpy(staged).to(self.device, copy=True)
            self._reg.histogram("serve.h2d_seconds").observe(time.perf_counter() - t_h2d)
        span_args = dict(bucket=bucket, image_size=size, rows=rows, k=1, model=DEFAULT_MODEL)
        if ctxs:
            span_args["rids"] = [c.rid for c in ctxs[:16]]
        with tracer.span("serve/dispatch", "serve", **span_args):
            logits = self._forward(x)
            for c in ctxs:
                c.advance("dispatched")
                tracer.flow_step("serve/req", c.rid)
        self._reg.histogram("serve.dispatch_seconds").observe(time.perf_counter() - t0)
        self._reg.counter(f"serve.bucket_hits.{bucket}").inc()
        self._reg.counter("serve.h2d_bytes").inc(staged.nbytes)
        return logits, rows

    def predict_async(self, images: np.ndarray, ctxs=None, model: str | None = None) -> PendingPrediction:
        """Dispatch without syncing: (N, S, S, 3) float32 normalized pixels
        -> handle whose ``result()`` yields (N, num_classes) float32 logits.
        Every piece is dispatched before the caller can sync."""
        if model not in (None, DEFAULT_MODEL):
            raise ValueError(f"model {model!r}: this engine serves one model (ROADMAP queue 1b, S5: the model zoo)")
        images = quant.coerce_wire(images, np.float32)
        if images.ndim != 4 or images.shape[1] != images.shape[2] or images.shape[3] != 3:
            raise ValueError(f"predict expects (N, S, S, 3), got shape {images.shape}")
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        ctxs = tuple(ctxs or ())
        size = int(images.shape[1])
        self._reg.counter("serve.infer_images").inc(n)
        t_start = time.perf_counter()
        per_row = len(ctxs) == n
        with self._dispatch_lock:
            parts = [
                self._dispatch_piece(images, piece, size,
                                     ctxs=ctxs[piece[0]: piece[0] + piece[1]] if per_row else ctxs)
                for piece in self._plan(n)
            ]
        return PendingPrediction(self, parts, t_start, time.perf_counter(), ctxs=ctxs)

    def predict(self, images: np.ndarray, ctxs=None, model: str | None = None) -> np.ndarray:
        """(N, S, S, 3) normalized pixels -> (N, num_classes) float32 logits."""
        return self.predict_async(images, ctxs=ctxs, model=model).result()

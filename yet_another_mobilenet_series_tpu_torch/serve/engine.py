"""Bucketed inference engine: the torch twin of ``yet_another_mobilenet_series_tpu/serve/engine.py``.

The engine fixes a small ladder of batch **buckets** (e.g. 1/8/32) and an
**image-size ladder**, and dispatches every batch to the smallest bucket
that fits, zero-padding the tail rows and slicing them back off the logits.
Padding is sound because the folded forward is row-independent (the fold
removed BN), so the real rows' logits are bitwise identical to an unpadded
run of the same bucket.

**Executables are CUDA graphs.** Where the JAX engine AOT-compiles one
executable per key, this one captures one ``torch.cuda.CUDAGraph`` per key
at warmup: ``(model, bucket, size, K)`` for the per-chunk (K = 1) and fused
forwards, ``(model, bucket, size, R)`` for the request ring. A graph owns a static
input in the wire dtype (``(bucket, S, S, 3)``, or ``(K, bucket, S, S, 3)``
stacked), the denorm prelude of the uint8 wire, K (or R) captured runs of
the same folded forward, and a static output. A dispatch copies its input
into the static one, replays the graph (one launch for about 190 kernels
per forward) and copies the static output into a pinned host tensor of its
own right after the replay, on the same stream, so a later replay of the
key cannot overwrite a result still waiting for ``result()``. Before its
capture each key runs once eagerly on a side stream: it loads the kernels
lazily, lets cuDNN pick its algorithms, and counts the fused-depthwise
launches that the capture then records. Captures use
``capture_error_mode="thread_local"`` on a stream of their own, so a key
captured lazily on one thread coexists with warm replays on another. All
graphs of an engine share one memory pool: their replays are serialized
on the engine's compute stream and every static output is copied off
before the next replay. On ``cpu`` the same structure runs eagerly with no
graph (the device the caller asked for). On ``cuda`` a failed capture or
replay raises; there is no eager path on a card.

**Several models** (``models={name: bundle}``, ``serve/zoo.py``): each
tenant has its own net, folded params on the device, weight mode (an int8
tenant beside an f32 one), cost tag (``_m<name>``; the single-bundle
engine's implicit tenant ``default`` adds none, so its keys are the
pre-zoo ones) and image-size ladder (``model_image_sizes``). Graphs are
keyed by the tenant; staging slot pools stay keyed by geometry and are
shared, since a slot's buffers know no tenant and its fence already
orders any consumer's replay before the rewrite. Every tenant's graphs
share the one pool and the one compute stream, so the fence lifecycle of
the fused and ring keys covers them unchanged: each replay's static
output is copied off before the next replay of any key. Each tenant has
its own off-ladder LRU budget, so a size-scanning client of one tenant
never evicts another's graphs; a shared staging pool goes only when no
tenant holds a graph of its geometry. A request names its tenant with
``model=`` (``X-Model`` at the front door); None is the default tenant,
and a name the engine does not serve raises the typed
:class:`~.admission.UnknownModel`.

**Fused multi-chunk dispatch** (``fuse_ladder``): a request larger than the
biggest bucket stages its K chunks into one ``(K, bucket, S, S, 3)`` buffer
and replays one graph of K forwards: one dispatch, one transfer and one
sync for the whole request. Off-ladder chunk counts decompose greedily
(7 chunks = 4+2+1 with ladder {2, 4}); the tail joins a fused piece only
when it pads to the biggest bucket anyway. The captured body is the same
forward at the same ``(bucket, size)``, so fused logits are bitwise the
per-chunk path's.

**Overlapped staging** (``overlap_staging=True``): each key gets a
round-robin pool of ``staging_slots`` slots. A slot is a pinned host buffer
(a numpy view of a ``pin_memory`` tensor) and a device buffer of the same
shape. The H2D copy is ``non_blocking`` on a copy stream; the compute stream
waits on the copy's event, copies the device buffer into the graph's static
input (a device-to-device copy of 19 MB for a batch-32 f32 input at 224,
a quarter of that on the u8 wire; chip_smoke.py times it) and replays.
That extra copy keeps the copy of dispatch N+1 off the static input that
replay N may still read, with one static input per key (a graph per slot
would multiply the graphs). The slot's **fence** is a CUDA event recorded after the consuming
replay; ``_SlotPool.acquire`` waits on it (``serve.slot_wait_seconds``)
before the host buffer or the device buffer is rewritten. A dispatch that
fails between the copy and fence arming orphans the slot's buffers: fresh
storage replaces them, and the in-flight copy keeps the old memory
(PyTorch's caching allocators hold a block until its recorded streams pass
it). With ``overlap_staging=False`` the copy from pageable memory into the
static input is synchronous, on the compute stream, as before.

**Uint8 wire** (``wire="uint8"``): clients submit raw pixels; staging slots,
ring slots and the H2D copy are uint8 (``serve.h2d_bytes`` reads a quarter
of the f32 wire's bytes), and every graph begins with the denorm prelude
(``serve/quant.py``). int8-weight bundles need no engine plumbing: the
forward dequantizes them (``serve/export.py``).

**Request ring** (``ring_slots`` = R > 0, ``serve/ring.py``): a graph per
``(bucket, size, R)`` runs R forwards over R device slots with an
active-slot mask applied as an output select (``torch.where(mask[i], y,
0)``): the mask is data, not shape, so a partly filled window replays the
same graph. Host threads feed slots with :meth:`InferenceEngine.ring_stage`
(an H2D copy into a ring slot's device buffer, no dispatch) and
:meth:`InferenceEngine.ring_dispatch` consumes a window in one replay;
padded slots are zeroed on the device, with no H2D.

**Capture never blocks warm traffic**: a cold key is captured under a
compile lock with a double-checked insert, outside the dispatch lock.
Off-ladder keys live in a bounded LRU (``offladder_cache``); eviction drops
the graph, its staging pool and their memory (a graph still replaying is
freed by CUDA when it completes).

Instrumentation: ``serve.dispatch_seconds`` (host stage+dispatch per
piece; one per ring window), ``serve.dispatch_to_complete_seconds``,
``serve.run_seconds``, ``serve.h2d_seconds``, ``serve.slot_wait_seconds``,
``serve.compile_seconds`` (per captured key, and ``obs.compile_seconds`` /
``obs.compiles``), ``serve.graph_replays``, ``serve.fused_dispatches`` /
``serve.fused_chunks``, ``serve.ring_dispatches`` /
``serve.ring_slots_per_dispatch`` / ``serve.ring_fill``,
``serve.evicted_executables``, ``serve.infer_images`` /
``serve.padded_rows`` / ``serve.bucket_hits.<b>`` / ``serve.h2d_bytes``,
and ``serve/compile``, ``serve/stage``, ``serve/h2d``, ``serve/dispatch``,
``serve/dispatch_fused``, ``serve/ring`` and ``serve/complete`` spans.

Costs: each captured key records ``obs.cost_flops.<key>`` /
``obs.cost_bytes.<key>`` (``obs/device.py`` :func:`forward_cost`, counted
from shapes at the bucket's rows), keyed as the JAX engine keys them:
``serve_b<bucket>_s<size>_k<K>`` and ``serve_b<bucket>_s<size>_ring<R>``,
tagged ``_u8`` (uint8 wire), ``_w8`` (int8 weights) and ``_bf16`` (bf16
compute). Each dispatch adds its key's cost to ``serve.dispatched_flops``
and ``serve.dispatched_bytes``: a fused K dispatch counts K x the
per-chunk cost, a ring window its filled slots (the JAX engine counts all
R, which the device computes; here the fill waste stays out of the
numerator and shows as ``serve.ring_fill`` < 1). ``serve.achieved_flops_per_s``
divides the dispatched FLOPs by the measured ``serve.run_seconds``.

**Data-parallel serving** (``mesh=``, a ``parallel/mesh.py``
:class:`~..parallel.mesh.ServingMesh`): as the JAX engine splits every
bucket over its mesh's local devices with the parameters replicated, this
one keeps a copy of each tenant's folded parameters on every device of the
mesh (a *lane*: the device, its own compute and capture streams and graph
memory pool, its denorm constants) and captures each bucket's graph once
per lane at ``bucket // size`` rows. A dispatch splits the staged bucket
into equal row slices in order, copies slice i into lane i's static input
synchronously (so the staging buffer is free when the copy returns: a
pool-owned slot is never fenced, the twin of the JAX engine's synchronous
snapshot), replays every lane's graph, and gathers the logits in row order
into one pinned host tensor; the dispatch's fence waits on every lane. A
device may appear twice in the mesh: two lanes on one card each have their
own streams, graphs and pool. Every bucket must be a multiple of the mesh's
size. Under a mesh the fused ladder falls back to the per-chunk path and
the request ring is refused, as in the JAX engine. A ``cuda`` mesh without
a card raises; a CPU mesh runs each lane's slice eagerly.
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
from ..ops.fused_depthwise import fused_depthwise
from ..parallel.mesh import ServingMesh
from ..utils.device import resolve_device, set_tf32
from . import quant
from .admission import UnknownModel
from .export import InferenceBundle, apply_folded, prepare_folded
from .ring import RingEntry

# the implicit model name of a single-bundle engine (the JAX engine's): its
# cost keys carry no model suffix, so the pre-zoo keys stay valid
DEFAULT_MODEL = "default"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cost_key(bucket: int, size: int, k: int, tag: str = "") -> str:
    """Registry-safe key of a per-chunk (K = 1) or fused executable's cost
    gauges (``obs.cost_flops.serve_b8_s224_k1``), the JAX engine's scheme."""
    return f"serve_b{bucket}_s{size}_k{k}{tag}"


def _ring_cost_key(bucket: int, size: int, r: int, tag: str = "") -> str:
    """Cost key of a ring executable: ``ring<R>``, so that it never collides
    with the fused K = R key of the same geometry."""
    return f"serve_b{bucket}_s{size}_ring{r}{tag}"


class _Done:
    """The fence of work that has already completed: a CPU dispatch, whose
    eager forward returned before the dispatch did."""

    __slots__ = ()

    def synchronize(self) -> None:
        pass


_DONE = _Done()


class _AllDone:
    """The fence of a mesh dispatch: every lane's event."""

    __slots__ = ("events",)

    def __init__(self, events):
        self.events = tuple(events)

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class _Lane:
    """One device of the engine: the device, and on a card the compute
    stream its replays run on, the capture stream its warm runs and
    captures run on, its graph memory pool and its denorm constants. A
    single-device engine has one lane; a mesh engine one per mesh entry."""

    __slots__ = ("device", "compute", "capture", "pool", "dn_scale", "dn_shift")

    def __init__(self, device: torch.device, scale: np.ndarray, shift: np.ndarray | None):
        self.device = device
        self.dn_scale = torch.from_numpy(scale).to(device)
        self.dn_shift = None if shift is None else torch.from_numpy(shift).to(device)
        self.compute = self.capture = self.pool = None
        if device.type == "cuda":
            self.compute = torch.cuda.Stream(device)
            self.capture = torch.cuda.Stream(device)
            with torch.cuda.device(device):
                self.pool = torch.cuda.graph_pool_handle()


class _StagingSlot:
    """One staging slot: a host buffer (``buf``, numpy; on the card in
    overlap mode a view of the pinned tensor ``host``), on the card a device
    buffer ``dev`` of the same shape, and the ``fence`` guarding their reuse
    (the event recorded after the replay that consumed them). ``ready`` is
    the event of the slot's last H2D copy on the copy stream."""

    __slots__ = ("buf", "host", "dev", "fence", "ready", "_shape", "_np_dtype", "_device", "_pinned", "_streams")

    def __init__(self, shape, np_dtype, device, pinned: bool, streams):
        self._shape, self._np_dtype, self._device, self._pinned, self._streams = (
            shape, np_dtype, device, pinned, streams)
        self.renew()

    def renew(self) -> None:
        """Fresh storage for both buffers and no fence: the old buffers stay
        with whatever copy may still read them (an orphan after a failed
        dispatch)."""
        if self._pinned:
            self.host = torch.zeros(self._shape, dtype=_torch_dtype(self._np_dtype), pin_memory=True)
            self.buf = self.host.numpy()
        else:
            self.host, self.buf = None, np.zeros(self._shape, self._np_dtype)
        self.dev = None
        if self._device is not None:
            compute, copy = self._streams
            with torch.cuda.stream(compute):
                self.dev = torch.zeros(self._shape, dtype=_torch_dtype(self._np_dtype), device=self._device)
            # the copy stream writes it: the allocator must not hand the
            # block out again before that stream has passed it
            self.dev.record_stream(copy)
        self.fence = None
        self.ready = None


class _SlotPool:
    """Round-robin pool of staging slots for one key.

    Dispatches are serialized by the engine's dispatch lock, so the pool
    needs no lock of its own. With N slots, acquire() only blocks when the
    slot's consumer is still among the last N dispatches in flight — sized
    at (pipeline max_inflight), the fence wait is normally a no-op and
    ``serve.slot_wait_seconds`` stays ~0."""

    __slots__ = ("slots", "_next")

    def __init__(self, shape, n: int, np_dtype=np.float32, device=None, pinned: bool = False, streams=None):
        # the buffer dtype IS the wire dtype (serve.quant.wire): uint8 slots
        # hold, and transfer, a quarter of the f32 bytes
        self.slots = [_StagingSlot(shape, np_dtype, device, pinned, streams) for _ in range(n)]
        self._next = 0

    def acquire(self, reg) -> _StagingSlot:
        """Next slot, its buffers safe to rewrite: waits for the slot's last
        armed fence (usually already passed) before handing it out."""
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        if slot.fence is not None:
            t0 = time.perf_counter()
            slot.fence.synchronize()
            reg.histogram("serve.slot_wait_seconds").observe(time.perf_counter() - t0)
            slot.fence = None
        return slot


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.uint8 if np.dtype(np_dtype) == np.uint8 else torch.float32


class _Executable:
    """The counterpart of one JAX AOT executable. On the card: the captured
    graph, its static input ``x`` (and, for a ring, its static ``mask`` and
    the R masks a window can have, ``masks[fill - 1]``), its static output
    ``y``, the fused-depthwise launches the capture recorded
    (``k1_launches``) and the eager warm run made (``warm_k1``), and the
    replays so far. On the CPU: ``fn``, the eager body. Under a mesh:
    ``parts``, one executable per lane at the lane's rows, with the lanes'
    launches summed here (one replay of the key replays every part)."""

    __slots__ = ("graph", "x", "y", "mask", "masks", "fn", "parts", "k1_launches", "warm_k1", "replays")

    def __init__(self, *, graph=None, x=None, y=None, mask=None, masks=None, fn=None, parts=None, k1_launches=0,
                 warm_k1=0):
        self.graph, self.x, self.y, self.mask, self.masks, self.fn = graph, x, y, mask, masks, fn
        self.parts = parts
        if parts:
            k1_launches, warm_k1 = sum(p.k1_launches for p in parts), sum(p.warm_k1 for p in parts)
        self.k1_launches, self.warm_k1, self.replays = k1_launches, warm_k1, 0


class _ModelState:
    """One tenant of the engine: its network, its folded params on each
    lane's device (``prepare_folded``, one entry a lane), weight mode, cost
    tag and image-size ladder (the JAX engine's ``_ModelState``)."""

    __slots__ = ("name", "net", "params", "weights", "cost_tag", "image_size", "image_sizes")

    def __init__(self, name: str, net: Network, params: list, weights: str, cost_tag: str, image_size: int,
                 image_sizes: tuple[int, ...]):
        self.name, self.net, self.params, self.weights = name, net, tuple(params), weights
        self.cost_tag, self.image_size, self.image_sizes = cost_tag, image_size, image_sizes


class PendingPrediction:
    """Device-side handle returned by :meth:`InferenceEngine.predict_async`.

    Holds every piece's logits as they will land on the host (a pinned
    tensor the dispatch's stream is still filling, and the event that says
    when it is done); ``result()`` is the ONE host<->device sync (wait,
    slice off pad rows, concat) and caches its value. A once-latch
    serializes concurrent callers: exactly one performs the sync and
    everyone gets the same cached array. ``dispatches`` counts the engine
    pieces behind the handle.
    """

    __slots__ = ("_engine", "_parts", "_t_start", "_t_dispatched", "_out", "_lock", "_ctxs",
                 "dispatches")

    def __init__(self, engine: "InferenceEngine", parts, t_start: float, t_dispatched: float, ctxs=()):
        self._engine = engine
        self._parts = parts  # [(host logits, real_rows, done fence), ...]
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
                    outs = []
                    for host, rows, done in self._parts:
                        done.synchronize()
                        arr = host.numpy()
                        # fused and ring pieces come back (K, bucket, classes):
                        # flatten the chunk axis before slicing off the pad
                        # rows; the copy frees the pinned buffer
                        outs.append(np.array(arr.reshape(-1, arr.shape[-1])[:rows]))
                    for c in self._ctxs:
                        c.advance("completed")
                now = time.perf_counter()
                reg.histogram("serve.dispatch_to_complete_seconds").observe(now - self._t_dispatched)
                reg.histogram("serve.run_seconds").observe(now - self._t_start)
                self._out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
                self._parts = ()  # drop the host buffers as soon as synced
            return self._out


class InferenceEngine:
    """Serving wrapper around one loaded :class:`InferenceBundle`, or several
    named ones (``models=``), on one device.

    ``predict(images)`` accepts any batch size: requests larger than the
    biggest bucket are served by the fused graphs (one dispatch per ladder
    piece) or in chunks of that bucket, everything else is padded up to the
    smallest fitting bucket. ``predict_async`` is the no-sync variant the
    pipelined batcher drives. A size off the ``image_sizes`` ladder is
    captured lazily (once, without blocking warm traffic) and kept in a
    bounded LRU (``offladder_cache``).
    """

    def __init__(
        self,
        bundle: InferenceBundle | None = None,
        *,
        models: dict[str, InferenceBundle] | None = None,
        default_model: str | None = None,
        model_image_sizes: dict[str, Sequence[int]] | None = None,
        buckets: Sequence[int] = (1, 8, 32),
        compute_dtype: str = "float32",
        device: str | torch.device = "cuda",
        mesh=None,
        image_size: int | None = None,
        image_sizes: Sequence[int] | None = None,
        fuse_ladder: Sequence[int] = (),
        offladder_cache: int = 8,
        overlap_staging: bool = False,
        staging_slots: int = 2,
        wire: str = "float32",
        wire_mean: Sequence[float] | None = None,
        wire_std: Sequence[float] | None = None,
        ring_slots: int = 0,
    ):
        if mesh is not None and not isinstance(mesh, ServingMesh):
            raise ValueError(f"mesh must be a ServingMesh (parallel/mesh.py make_serving_mesh), got {type(mesh)!r}")
        # tenant resolution: a single bundle is a one-model zoo under the
        # reserved DEFAULT_MODEL name
        if models:
            if bundle is not None:
                raise ValueError("pass either bundle= or models=, not both")
            bundles = dict(models)
        else:
            if bundle is None:
                raise ValueError("engine needs a bundle or a models= dict")
            bundles = {DEFAULT_MODEL: bundle}
        for name in bundles:
            if not name or not name.replace("-", "").replace("_", "").isalnum():
                raise ValueError(f"model name {name!r} must be non-empty [A-Za-z0-9_-] "
                                 "(it becomes a metric-family and cost-key component)")
        self._default = default_model or next(iter(bundles))
        if self._default not in bundles:
            raise ValueError(f"default_model {self._default!r} not among loaded models {tuple(bundles)}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {tuple(_DTYPES)}, got {compute_dtype!r}")
        if not buckets:
            raise ValueError("engine needs at least one batch bucket")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"batch buckets must be >= 1, got {self.buckets}")
        if offladder_cache < 1:
            raise ValueError(f"offladder_cache must be >= 1, got {offladder_cache}")
        if staging_slots < 1:
            raise ValueError(f"staging_slots must be >= 1, got {staging_slots}")
        if ring_slots and ring_slots < 2:
            raise ValueError(f"ring_slots must be 0 (off) or >= 2, got {ring_slots}")
        if ring_slots and mesh is not None:
            raise ValueError("the request ring requires mesh=None (data-parallel serving rides the per-chunk path)")
        if mesh is not None:
            bad = [b for b in self.buckets if b % mesh.size]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the {mesh.size}-device mesh; "
                                 "data-parallel serving pads to whole per-device shards")
        self._mesh = mesh
        # chunk-count ladder for fused dispatch; K=1 (the per-chunk path) is
        # implicit, so only K >= 2 entries are meaningful. () disables fusion.
        self.fuse_ladder = tuple(sorted(set(int(k) for k in (fuse_ladder or ()) if int(k) >= 2)))
        self._offladder_cap = int(offladder_cache)
        self._overlap = bool(overlap_staging)
        self._staging_slots = int(staging_slots) if self._overlap else 1
        self._ring_slots = int(ring_slots)
        # the WIRE dtype (serve.quant.wire): what clients submit, what the
        # staging slots hold and what crosses H2D
        self._wire = wire
        self._wire_np = quant.wire_np_dtype(wire)  # validates the name too
        scale, shift = quant.denorm_constants(wire_mean, wire_std)
        self._shift_free = quant.shift_free(shift)
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"a {mesh.devices[0].type} mesh on a {self.device.type} engine")
            self.device = mesh.devices[0]
        self._cuda = self.device.type == "cuda"
        self._compute_dtype = _DTYPES[compute_dtype]
        self._itemsize = torch.empty((), dtype=self._compute_dtype).element_size()
        if self._cuda and self._compute_dtype == torch.float32:
            # cuDNN runs float32 convolutions in TF32 by default (about three
            # decimal digits), which would break the float32 parity with the
            # JAX reference and the CPU forward: turn TF32 off for cuDNN and
            # for matmul, before any capture. These flags are process-wide.
            set_tf32("float32")
        # per tenant: the folded tree as the forward reads it, on the device,
        # made once here and never per call (int8 pairs stay int8); cost-gauge
        # keys of quantized, bf16 and named tenants must not collide in one
        # process. image_size / image_sizes apply to the default tenant.
        sizes_by_model = dict(model_image_sizes or {})
        for name in sizes_by_model:
            if name not in bundles:
                raise ValueError(f"model_image_sizes names unknown model {name!r}")
        self._model_states: dict[str, _ModelState] = {}
        for name, b in bundles.items():
            m_size = int(image_size) if (image_size and name == self._default) else int(b.net.image_size)
            extra = sizes_by_model.get(name)
            if extra is None and name == self._default:
                extra = image_sizes
            m_sizes = tuple(sorted(set(int(s) for s in (extra or ())) | {m_size}))
            if m_sizes[0] < 1:
                raise ValueError(f"image sizes must be >= 1, got {m_sizes} for {name!r}")
            cost_tag = (("_u8" if wire == "uint8" else "") + ("_w8" if b.weights == "int8" else "")
                        + ("_bf16" if self._compute_dtype == torch.bfloat16 else "")
                        + (f"_m{name}" if name != DEFAULT_MODEL else ""))
            params = [prepare_folded(b.net, b.params, device=d, compute_dtype=self._compute_dtype)
                      for d in (mesh.devices if mesh is not None else (self.device,))]
            self._model_states[name] = _ModelState(name, b.net, params, b.weights, cost_tag, m_size, m_sizes)
        # the default tenant's identity is the engine's (the sync batcher,
        # the CLI and the tests read these)
        st = self._model_states[self._default]
        self.net: Network = st.net
        self.image_size, self.image_sizes = st.image_size, st.image_sizes
        self._params, self._weights = st.params[0], st.weights
        # replays and their copies run on a lane's compute stream; warm runs
        # and captures on its capture stream (serialized by the compile
        # lock); overlapped H2D copies on the copy stream (no mesh)
        self._lanes = [_Lane(d, scale, None if self._shift_free else shift)
                       for d in (mesh.devices if mesh is not None else (self.device,))]
        if self._cuda:
            self._compute = self._lanes[0].compute
            self._copy = torch.cuda.Stream(self.device)
        # executables keyed (model, bucket, size, K) as the JAX engine's, and
        # ring executables (model, bucket, size, R, "ring"); each key's
        # staging pool under the same key without the model, shared by the
        # tenants; off-ladder keys in a bounded LRU per tenant
        self._compiled: dict[tuple, _Executable] = {}
        self._staging: dict[tuple, _SlotPool] = {}
        self._offladder: dict[str, OrderedDict[tuple, None]] = {name: OrderedDict() for name in self._model_states}
        # one dispatcher at a time: staging slots and static inputs are reused
        self._dispatch_lock = threading.Lock()
        # captures serialize with each other but NOT with dispatch
        self._compile_lock = threading.Lock()
        # guards the caches' mutation + LRU bookkeeping
        self._cache_lock = threading.Lock()
        self._reg = get_registry()
        obs_device.install_memory_gauges(self._reg)
        obs_device.install_dispatch_efficiency_gauge(self._reg)

    # -- the zoo surface ----------------------------------------------------

    @property
    def models(self) -> tuple[str, ...]:
        """Names of the loaded tenants (a single-bundle engine reports
        ``("default",)``): the set the lease advertises and admission checks
        ``X-Model`` against."""
        return tuple(self._model_states)

    @property
    def default_model(self) -> str:
        """The tenant that requests naming no model go to."""
        return self._default

    def model_weights(self, model: str) -> str:
        """Weight storage of one tenant's bundle ("float32" | "int8")."""
        return self._model_state(model).weights

    def model_image_ladder(self, model: str) -> tuple[int, ...]:
        """One tenant's warmed image-size ladder."""
        return self._model_state(model).image_sizes

    def _model_state(self, model: str | None) -> _ModelState:
        st = self._model_states.get(model or self._default)
        if st is None:
            raise UnknownModel(model, self._model_states)
        return st

    # -- the surface the batchers and the CLI read --------------------------

    @property
    def mesh(self) -> ServingMesh | None:
        """The serving mesh the buckets are split over (None: one device)."""
        return self._mesh

    @property
    def ring_slots(self) -> int:
        """Ring depth R (0 = ring mode off) — the pipeline's engagement
        signal and the window's slot budget."""
        return self._ring_slots

    @property
    def wire_np_dtype(self):
        """numpy dtype the batchers coerce client images to."""
        return self._wire_np

    @property
    def weights(self) -> str:
        """Weight storage of the loaded bundle ("float32" | "int8")."""
        return self._weights

    @property
    def quant_mode(self) -> str:
        """The ``serve.quant_mode`` build-info label (docs/OBSERVABILITY.md)."""
        return f"wire={self._wire},weights={self._weights}"

    @property
    def wire_parity_exact(self) -> bool:
        """True when the u8 wire's denorm is a single per-channel multiply
        (zero mean): logits are BITWISE identical to the f32 wire fed
        :func:`serve.quant.normalize_reference` pixels."""
        return self._shift_free

    def graph_report(self) -> list[dict]:
        """Per captured key: its tenant, kind (``k`` or ``ring``), key
        ``(bucket, size, K or R)``, the fused-depthwise launches one replay
        runs, those of its eager warm run, and its replays so far
        (chip_smoke.py counts the kernel's launches on the card from
        these)."""
        with self._cache_lock:
            items = list(self._compiled.items())
        return [{"model": key[0], "kind": "ring" if key[-1] == "ring" else "k", "key": key[1:4],
                 "k1_launches": e.k1_launches, "warm_k1": e.warm_k1, "replays": e.replays,
                 "lanes": len(e.parts) if e.parts else 1} for key, e in items]

    # -- forward ------------------------------------------------------------

    def _forward(self, x: torch.Tensor, st: _ModelState | None = None, lane: int = 0) -> torch.Tensor:
        """One eager folded forward of tenant ``st`` (the default one when
        None) with lane ``lane``'s params on a (b, S, S, 3) wire-dtype batch
        on the current stream, denorm prelude included."""
        st = st or self._model_states[self._default]
        with torch.inference_mode():
            if self._wire == "uint8":
                ln = self._lanes[lane]
                x = quant.denormalize_device(x, ln.dn_scale, ln.dn_shift)
            return apply_folded(st.net, st.params[lane], x, compute_dtype=self._compute_dtype)

    def _body(self, st: _ModelState, x: torch.Tensor, mask: torch.Tensor | None = None, lane: int = 0) -> torch.Tensor:
        """What a key's graph runs: one forward of a (b, S, S, 3) input, or
        one per chunk of a stacked (K, b, S, S, 3) one, each chunk's output
        selected by ``mask[i]`` for a ring."""
        if x.dim() == 4:
            return self._forward(x, st, lane)
        ys = []
        for i in range(x.shape[0]):
            y = self._forward(x[i], st, lane)
            if mask is not None:
                with torch.inference_mode():
                    y = torch.where(mask[i], y, torch.zeros_like(y))
            ys.append(y)
        with torch.inference_mode():
            return torch.stack(ys)

    # -- capture ------------------------------------------------------------

    def _capture(self, st: _ModelState, shape: tuple[int, ...], ring: bool, lane: int = 0) -> _Executable:
        """Capture the graph of one key on lane ``lane``'s card: allocate its
        static input, run the body once eagerly on the lane's capture stream
        (lazy kernel loading, cuDNN's choice, the launches counted), then
        capture it in thread-local mode into the lane's memory pool. Raises
        on any failure."""
        ln = self._lanes[lane]
        with torch.cuda.device(ln.device), torch.cuda.stream(ln.compute):
            x = torch.zeros(shape, dtype=_torch_dtype(self._wire_np), device=ln.device)
            mask = masks = None
            if ring:
                r = shape[0]
                fills = torch.arange(1, r + 1, device=ln.device)
                masks = torch.arange(r, device=ln.device)[None, :] < fills[:, None]  # row f-1: fill f
                mask = masks[-1].clone()
        side = ln.capture
        side.wait_stream(ln.compute)
        with torch.cuda.device(ln.device), torch.cuda.stream(side):
            n0 = fused_depthwise.launches
            self._body(st, x, mask, lane)
            n1 = fused_depthwise.launches
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=ln.pool, capture_error_mode="thread_local")
            try:
                y = self._body(st, x, mask, lane)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated; the body's error is the one to raise
                raise
            graph.capture_end()
            n2 = fused_depthwise.launches
        side.synchronize()
        return _Executable(graph=graph, x=x, y=y, mask=mask, masks=masks, k1_launches=n2 - n1, warm_k1=n1 - n0)

    def _build(self, model: str, bucket: int, size: int, k: int, ring: bool = False) -> _Executable:
        """The executable of one key: a captured graph on the card, the
        eager body on the CPU. Its wall time goes to
        ``serve.compile_seconds`` and ``obs.compile_seconds``."""
        st = self._model_states[model]
        shape = (bucket, size, size, 3) if k == 1 and not ring else (k, bucket, size, size, 3)
        t0 = time.perf_counter()
        span_args = dict(bucket=bucket, image_size=size, model=model, **({"ring": k} if ring else {"k": k}))
        with obs_trace.get_tracer().span("serve/compile", "serve", **span_args):
            if self._mesh is not None:
                # one graph per lane at the lane's share of the bucket's rows
                rows = (bucket // self._mesh.size, size, size, 3)
                exe = _Executable(parts=[
                    self._capture(st, rows, False, i) if self._cuda
                    else _Executable(fn=lambda x, i=i: self._body(st, x, lane=i))
                    for i in range(self._mesh.size)])
            elif self._cuda:
                exe = self._capture(st, shape, ring)
            else:
                exe = _Executable(fn=lambda x, mask=None: self._body(st, x, mask))
        dt = time.perf_counter() - t0
        self._reg.histogram("serve.compile_seconds").observe(dt)
        obs_device.record_compile(dt, self._reg)
        cost = obs_device.forward_cost(st.net, size, k * bucket, self._itemsize)
        key = (_ring_cost_key if ring else _cost_key)(bucket, size, k, st.cost_tag)
        obs_device.record_cost(key, cost, compile_seconds=dt, registry=self._reg)
        return exe

    def _count_cost(self, key: str, fraction: float = 1.0) -> None:
        """Add ``fraction`` of executable ``key``'s recorded cost to
        ``serve.dispatched_flops`` and ``serve.dispatched_bytes``."""
        for counter, lookup in (("serve.dispatched_flops", obs_device.flops_for),
                                ("serve.dispatched_bytes", obs_device.bytes_for)):
            cost = lookup(key) * fraction
            if cost:
                self._reg.counter(counter).inc(cost)

    def _on_ladder(self, model: str, key: tuple) -> bool:
        bucket, size, k = key[:3]
        sizes = self._model_states[model].image_sizes
        if key[-1] == "ring":
            return bucket == self.buckets[-1] and size in sizes and k == self._ring_slots
        return bucket in self.buckets and size in sizes and (k == 1 or k in self.fuse_ladder)

    def _ensure_compiled(self, model: str, key: tuple[int, int, int], ring: bool = False) -> _Executable:
        """Executable for ``(model, *key)`` (a ring's for ``ring``, ``key``
        then ``(bucket, size, R)``), captured on miss WITHOUT holding the
        dispatch lock (double-checked insert): warm traffic keeps flowing
        while a cold size pays its capture. Off-ladder keys live in the
        tenant's own LRU; eviction drops the graph, and the shared staging
        pool of its geometry once no tenant holds a graph of it."""
        key = key + ("ring",) if ring else key
        full = (model,) + key
        with self._cache_lock:
            exe = self._compiled.get(full)
            if exe is not None:
                lru = self._offladder[model]
                if key in lru:
                    lru.move_to_end(key)
                return exe
        with self._compile_lock:
            with self._cache_lock:
                exe = self._compiled.get(full)
            if exe is not None:
                return exe
            exe = self._build(model, *key[:3], ring=ring)
            with self._cache_lock:
                self._compiled[full] = exe
                if not self._on_ladder(model, key):
                    lru = self._offladder[model]
                    lru[key] = None
                    lru.move_to_end(key)
                    while len(lru) > self._offladder_cap:
                        old, _ = lru.popitem(last=False)
                        self._compiled.pop((model,) + old, None)
                        if not any((m,) + old in self._compiled for m in self._model_states):
                            self._staging.pop(old, None)
                        self._reg.counter("serve.evicted_executables").inc()
            return exe

    def warmup(self) -> None:
        """Capture every ladder key of every tenant up front so no request
        pays a capture: each (bucket, image_size) pair of the tenant's
        ladder, the fused (max bucket, size, K) key for every K on the fuse
        ladder, and the ring key; on the card with overlapped staging, their
        staging pools too (pinned memory is slow to allocate)."""
        cap = self.buckets[-1]
        fused = self.fuse_ladder if self._mesh is None else ()  # a mesh rides the per-chunk path
        for model, st in self._model_states.items():
            for s in st.image_sizes:
                keys = [(b, s, 1) for b in self.buckets] + [(cap, s, k) for k in fused]
                for key in keys:
                    self._ensure_compiled(model, key)
                    if self._cuda and self._overlap:
                        self._pool_for(key)
                if self._ring_slots:
                    key = (cap, s, self._ring_slots)
                    self._ensure_compiled(model, key, ring=True)
                    if self._cuda:
                        self._pool_for(key, ring=True)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- staging ------------------------------------------------------------

    def _new_pool(self, shape, n: int, device_buffers: bool) -> _SlotPool:
        # a mesh copies each lane's slice synchronously: its slots are host
        # buffers alone
        pinned = self._cuda and self._overlap and self._mesh is None
        device = self.device if (self._cuda and device_buffers and self._mesh is None) else None
        streams = (self._compute, self._copy) if self._cuda else None
        return _SlotPool(shape, n, self._wire_np, device=device, pinned=pinned, streams=streams)

    def _pool_for(self, key: tuple[int, int, int], ring: bool = False) -> _SlotPool:
        bucket, size, k = key
        key = key + ("ring",) if ring else key
        with self._cache_lock:
            pool = self._staging.get(key)
            if pool is None:
                if ring:
                    # one slot per ring slot, 2R of them: R possibly consumed
                    # by the in-flight window + R being fed for the next one —
                    # the fence wait stays ~0
                    pool = self._new_pool((bucket, size, size, 3), 2 * k, True)
                else:
                    shape = (bucket, size, size, 3) if k == 1 else (k, bucket, size, size, 3)
                    # device buffers only where the H2D copy runs on the copy
                    # stream: the synchronous copy goes straight into the graph
                    pool = self._new_pool(shape, self._staging_slots, self._overlap)
                self._staging[key] = pool
            return pool

    def _stage(self, rows_arr: np.ndarray, key: tuple[int, int, int]):
        """Executable-shaped host array for a piece's rows, as ``(array,
        slot)``: the rows themselves (reshaped, no copy) when they fill the
        piece exactly, else a slot's buffer with the rows copied in and only
        the pad rows zeroed. On the card with overlap an exact fill takes a
        slot too, for its device buffer. Acquire waits on the slot's fence,
        so an in-flight copy is never torn by the rewrite."""
        bucket, size, k = key
        total = k * bucket
        n = rows_arr.shape[0]
        shape = (bucket, size, size, 3) if k == 1 else (k, bucket, size, size, 3)
        if n == total:
            arr = np.ascontiguousarray(rows_arr).reshape(shape)
            if not (self._cuda and self._overlap) or self._mesh is not None:
                return arr, None
            return arr, self._pool_for(key).acquire(self._reg)
        slot = self._pool_for(key).acquire(self._reg)
        flat = slot.buf.reshape(total, size, size, 3)
        flat[:n] = rows_arr
        flat[n:] = 0
        self._reg.counter("serve.padded_rows").inc(total - n)
        return slot.buf, slot

    def _h2d(self, staged: np.ndarray, slot: _StagingSlot | None, dst: torch.Tensor | None):
        """Put a staged host array on the device. CPU: an explicit copy (the
        staging buffer is never aliased). Card, overlap: a non-blocking copy
        into the slot's device buffer on the copy stream, its event in
        ``slot.ready``; returns that buffer. Card, no overlap: a synchronous
        copy from pageable memory into ``dst`` on the compute stream (the
        buffer is reusable the moment it returns); returns None."""
        src = slot.host if (slot is not None and slot.host is not None and staged is slot.buf) \
            else torch.from_numpy(staged)
        if not self._cuda:
            return src.clone()
        if slot is not None and slot.dev is not None and self._overlap:
            ready = torch.cuda.Event()
            with torch.cuda.stream(self._copy):
                slot.dev.copy_(src, non_blocking=True)
                ready.record(self._copy)
            slot.ready = ready
            return slot.dev
        with torch.cuda.stream(self._compute):
            dst.copy_(src)
        return None

    # -- replay -------------------------------------------------------------

    def _launch(self, exe: _Executable):
        """On the compute stream, with the static input filled: replay the
        graph and copy its static output into a pinned host tensor of this
        dispatch's own; returns it and the event recorded after the copy
        (the dispatch's done fence)."""
        exe.graph.replay()
        host = torch.empty(exe.y.shape, dtype=exe.y.dtype, pin_memory=True)
        host.copy_(exe.y, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._compute)
        exe.replays += 1
        self._reg.counter("serve.graph_replays").inc()
        return host, done

    def _run_piece(self, exe: _Executable, x, slot: _StagingSlot | None):
        """Run one piece's executable; returns ``(host logits, done fence)``.
        CPU: the eager body on ``x``. Card: ``x`` is None when the input
        was copied into the static one already (the synchronous path), else
        the slot's device buffer, copied in after its H2D event."""
        if not self._cuda:
            return exe.fn(x), _DONE
        with torch.cuda.stream(self._compute):
            if x is not None:
                self._compute.wait_event(slot.ready)
                exe.x.copy_(x)
            return self._launch(exe)

    def _run_mesh(self, exe: _Executable, staged: np.ndarray):
        """Run one piece over the mesh; returns ``(host logits, done fence,
        H2D seconds)``. Lane i takes rows ``[i * r, (i + 1) * r)`` of the
        staged bucket: on the card a synchronous copy into its graph's
        static input on its compute stream (the staged buffer is free when
        it returns, so no slot fence is armed), its replay, and a copy of
        its logits into its rows of one pinned host tensor; the fence waits
        on every lane's event. On the CPU each lane's eager body runs on a
        copy of its rows."""
        r = staged.shape[0] // len(exe.parts)
        if not self._cuda:
            outs = [p.fn(torch.from_numpy(staged[i * r:(i + 1) * r]).clone()) for i, p in enumerate(exe.parts)]
            return torch.cat(outs), _DONE, 0.0
        host, events, h2d = None, [], 0.0
        for i, (part, ln) in enumerate(zip(exe.parts, self._lanes)):
            with torch.cuda.device(ln.device), torch.cuda.stream(ln.compute):
                t0 = time.perf_counter()
                part.x.copy_(torch.from_numpy(staged[i * r:(i + 1) * r]))
                h2d += time.perf_counter() - t0
                part.graph.replay()
                if host is None:
                    host = torch.empty((staged.shape[0],) + tuple(part.y.shape[1:]), dtype=part.y.dtype,
                                       pin_memory=True)
                host[i * r:(i + 1) * r].copy_(part.y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(ln.compute)
            events.append(done)
            part.replays += 1
        exe.replays += 1
        self._reg.counter("serve.graph_replays").inc(len(exe.parts))
        return host, _AllDone(events), h2d

    def _run_ring(self, exe: _Executable, entries: list[RingEntry]):
        """Run a ring window; returns ``(host logits, done fence)``. The
        staged slots fill the first static slots, the rest are zeroed on the
        device, and the mask of this fill is selected."""
        fill, r = len(entries), self._ring_slots
        if not self._cuda:
            x = torch.stack([e.x for e in entries] + [torch.zeros_like(entries[0].x)] * (r - fill))
            return exe.fn(x, torch.arange(r) < fill), _DONE
        with torch.cuda.stream(self._compute):
            for i, e in enumerate(entries):
                if e.slot.ready is not None:
                    self._compute.wait_event(e.slot.ready)
                exe.x[i].copy_(e.x)
            exe.x[fill:].zero_()
            exe.mask.copy_(exe.masks[fill - 1])
            return self._launch(exe)

    # -- dispatch -----------------------------------------------------------

    def _plan(self, n: int, size: int) -> list[tuple[int, int, int, int]]:
        """Split an N-row request into dispatch pieces ``(start, rows,
        bucket, k)``, in row order. Full max-bucket chunks fuse greedily
        into the largest ladder K first (7 chunks with ladder {2, 4} ->
        4+2+1 -> 3 dispatches); the tail chunk joins a fused piece only when
        it would pad up to the max bucket anyway (same bucket => same
        forward => parity with the per-chunk path is preserved); otherwise
        it dispatches per-chunk into its own smaller bucket. K=1 pieces are
        the per-chunk path."""
        cap = self.buckets[-1]
        m = -(-n // cap)  # chunk count, ceil
        tail = n - (m - 1) * cap
        fusable = 0
        if self.fuse_ladder and self._mesh is None and m >= 2:
            fusable = m if self._bucket_for(tail) == cap else m - 1
        pieces: list[tuple[int, int, int, int]] = []
        chunk = 0
        rem = fusable
        for k in sorted(self.fuse_ladder, reverse=True):
            while rem >= k:
                start = chunk * cap
                rows = min(n, (chunk + k) * cap) - start
                pieces.append((start, rows, cap, k))
                chunk += k
                rem -= k
        while chunk < m:
            start = chunk * cap
            rows = min(n, start + cap) - start
            pieces.append((start, rows, self._bucket_for(rows), 1))
            chunk += 1
        return pieces

    def _dispatch_piece(self, st: _ModelState, images: np.ndarray, piece: tuple[int, int, int, int], size: int,
                        ctxs=()):
        """Stage + copy + replay ONE piece (a chunk, or K fused chunks) of
        tenant ``st``; returns (host logits, real_rows, done fence) without
        synchronizing."""
        start, rows, bucket, k = piece
        key = (bucket, size, k)
        exe = self._ensure_compiled(st.name, key)  # warmed by predict_async; a hit
        tracer = obs_trace.get_tracer()
        t0 = time.perf_counter()
        slot = None
        try:
            with tracer.span("serve/stage", "serve", bucket=bucket, rows=rows, k=k):
                staged, slot = self._stage(images[start: start + rows], key)
                if self._mesh is None:
                    t_h2d = time.perf_counter()
                    with tracer.span("serve/h2d", "serve", bucket=bucket, k=k, overlap=self._overlap):
                        x = self._h2d(staged, slot, exe.x)
                    self._reg.histogram("serve.h2d_seconds").observe(time.perf_counter() - t_h2d)
            span = "serve/dispatch" if k == 1 else "serve/dispatch_fused"
            span_args = dict(bucket=bucket, image_size=size, rows=rows, k=k, model=st.name)
            if self._mesh is not None:
                span_args["lanes"] = self._mesh.size
            if ctxs:
                span_args["rids"] = [c.rid for c in ctxs[:16]]
            with tracer.span(span, "serve", **span_args):
                if self._mesh is None:
                    host, done = self._run_piece(exe, x, slot)
                else:
                    host, done, h2d_s = self._run_mesh(exe, staged)
                    self._reg.histogram("serve.h2d_seconds").observe(h2d_s)
                for c in ctxs:
                    c.advance("dispatched")
                    tracer.flow_step("serve/req", c.rid)
            if slot is not None and self._overlap and self._mesh is None:
                # the event after the consuming replay: the slot's buffers
                # are rewritable once it has passed
                slot.fence = done
        except BaseException:
            if slot is not None and self._overlap and self._mesh is None:
                # A failure between the copy and fence arming would return the
                # slot to rotation with no fence while its copy may still be
                # reading the buffers: orphan them instead, and keep serving
                slot.renew()
            raise
        self._reg.histogram("serve.dispatch_seconds").observe(time.perf_counter() - t0)
        if k > 1:
            self._reg.counter("serve.fused_dispatches").inc()
            self._reg.counter("serve.fused_chunks").inc(k)
        self._reg.counter(f"serve.bucket_hits.{bucket}").inc(k)
        # the exact bytes this dispatch put on the H2D wire (wire-dtype
        # sized, so the uint8 wire shows its 4x drop precisely)
        self._reg.counter("serve.h2d_bytes").inc(staged.nbytes)
        # the fused key's cost is K x the per-chunk one (forward_cost at K x bucket rows)
        self._count_cost(_cost_key(bucket, size, k, st.cost_tag))
        return host, rows, done

    def predict_async(self, images: np.ndarray, ctxs=None, model: str | None = None) -> PendingPrediction:
        """Dispatch without syncing: (N, S, S, 3) in the WIRE dtype -> handle
        whose ``result()`` yields (N, num_classes) float32 logits. On the
        float32 wire inputs are already-normalized pixels; on the uint8 wire
        they are RAW pixels 0..255 (float arrays are rounded-and-clipped,
        serve/quant.py) and the graph denormalizes on the device. Every
        piece is dispatched before the caller can sync.

        ``model`` names the tenant (None: the default one); a name the
        engine does not serve raises :class:`~.admission.UnknownModel`
        before any work. One batch goes to one tenant.

        Caller contract: ``images`` is not written until this returns (an
        exact-fill piece is copied from it directly)."""
        st = self._model_state(model)
        images = quant.coerce_wire(images, self._wire_np)
        if images.ndim != 4 or images.shape[1] != images.shape[2] or images.shape[3] != 3:
            raise ValueError(f"predict expects (N, S, S, 3), got shape {images.shape}")
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        ctxs = tuple(ctxs or ())
        size = int(images.shape[1])
        self._reg.counter("serve.infer_images").inc(n)
        if st.name != DEFAULT_MODEL:
            self._reg.counter(f"serve.infer_images.{st.name}").inc(n)
        t_start = time.perf_counter()
        pieces = self._plan(n, size)
        # capture anything cold BEFORE taking the dispatch lock: a cold size
        # must not stall concurrent warm-size dispatches
        for key in {(bucket, size, k) for _, _, bucket, k in pieces}:
            self._ensure_compiled(st.name, key)
        per_row = len(ctxs) == n
        with self._dispatch_lock:
            parts = [
                self._dispatch_piece(st, images, piece, size,
                                     ctxs=ctxs[piece[0]: piece[0] + piece[1]] if per_row else ctxs)
                for piece in pieces
            ]
        return PendingPrediction(self, parts, t_start, time.perf_counter(), ctxs=ctxs)

    def predict(self, images: np.ndarray, ctxs=None, model: str | None = None) -> np.ndarray:
        """(N, S, S, 3) in the wire dtype -> (N, num_classes) float32 logits."""
        return self.predict_async(images, ctxs=ctxs, model=model).result()

    # -- device-resident request ring (serve/ring.py) -----------------------

    def ring_ready(self, model: str | None, size: int) -> bool:
        """Whether a ring window may form for ``(model, size)`` traffic: ring
        mode on, and ``size`` on the tenant's warmed ladder (an off-ladder
        size rides the per-batch path)."""
        st = self._model_states.get(model or self._default)
        return bool(self._ring_slots) and st is not None and int(size) in st.image_sizes

    def ring_stage(self, images: np.ndarray) -> RingEntry:
        """Feed ONE ring slot: stage up to max-bucket rows into a ring slot
        and copy them to its device buffer, WITHOUT dispatching (on the copy
        stream with overlap, so the device keeps computing the previous
        window). Returns the :class:`~.ring.RingEntry` that
        :meth:`ring_dispatch` consumes.

        Single-feeder contract: the ring pools are as lock-free as the
        dispatch-path pools, so slots are fed from ONE thread — the
        pipeline's collect thread — and at most R entries wait for a
        dispatch at a time."""
        if not self._ring_slots:
            raise RuntimeError("ring mode is off (ring_slots=0)")
        images = quant.coerce_wire(images, self._wire_np)
        if images.ndim != 4 or images.shape[1] != images.shape[2]:
            raise ValueError(f"ring_stage expects (N, S, S, 3), got shape {images.shape}")
        bucket = self.buckets[-1]
        n = images.shape[0]
        if not 0 < n <= bucket:
            raise ValueError(f"a ring slot holds 1..{bucket} rows, got {n}")
        size = int(images.shape[1])
        tracer = obs_trace.get_tracer()
        with tracer.span("serve/stage", "serve", bucket=bucket, rows=n, ring=True):
            slot = self._pool_for((bucket, size, self._ring_slots), ring=True).acquire(self._reg)
            if n == bucket:
                staged = np.ascontiguousarray(images)
            else:
                slot.buf[:n] = images
                slot.buf[n:] = 0
                self._reg.counter("serve.padded_rows").inc(bucket - n)
                staged = slot.buf
            t_h2d = time.perf_counter()
            with tracer.span("serve/h2d", "serve", bucket=bucket, ring=True, overlap=self._overlap):
                x = self._h2d(staged, slot, slot.dev)
            self._reg.histogram("serve.h2d_seconds").observe(time.perf_counter() - t_h2d)
        self._reg.counter("serve.h2d_bytes").inc(staged.nbytes)
        return RingEntry(slot.dev if self._cuda else x, n, slot)

    def ring_dispatch(self, entries: Sequence[RingEntry], ctxs=(), model: str | None = None) -> PendingPrediction:
        """Consume a window of staged slots in ONE replay: the ring graph
        runs every staged slot (and R - staged device-side zero pads)
        through the forward, and the returned handle drains all per-slot
        logits with a single sync. Every slot but the last must be FULL —
        the drain flattens ``(R, bucket, classes)`` and slices the first
        ``rows``. Observes ``serve.dispatch_seconds`` exactly once: a
        window is one engine piece (``handle.dispatches`` == 1). The
        staged slots are tenant-free; ``model`` picks the forward."""
        st = self._model_state(model)
        r = self._ring_slots
        if not r:
            raise RuntimeError("ring mode is off (ring_slots=0)")
        entries = list(entries)
        if not 0 < len(entries) <= r:
            raise ValueError(f"a ring window holds 1..{r} slots, got {len(entries)}")
        bucket = self.buckets[-1]
        if any(e.rows != bucket for e in entries[:-1]):
            raise ValueError("only the LAST ring slot may be partial "
                             "(the drain relies on contiguous valid rows)")
        size = int(entries[0].x.shape[1])
        rows = (len(entries) - 1) * bucket + entries[-1].rows
        ctxs = tuple(ctxs)
        exe = self._ensure_compiled(st.name, (bucket, size, r), ring=True)  # a warmup hit
        self._reg.counter("serve.infer_images").inc(rows)
        if st.name != DEFAULT_MODEL:
            self._reg.counter(f"serve.infer_images.{st.name}").inc(rows)
        t_start = time.perf_counter()
        tracer = obs_trace.get_tracer()
        with self._dispatch_lock:
            t0 = time.perf_counter()
            try:
                span_args = dict(bucket=bucket, image_size=size, rows=rows, slots=len(entries), r=r,
                                 model=st.name)
                if ctxs:
                    span_args["rids"] = [c.rid for c in ctxs[:16]]
                with tracer.span("serve/ring", "serve", **span_args):
                    host, done = self._run_ring(exe, entries)
                    for c in ctxs:
                        c.advance("dispatched")
                        tracer.flow_step("serve/req", c.rid)
                for e in entries:
                    # one fence for the whole window: the replay consumed
                    # every slot's buffers
                    e.slot.fence = done
            except BaseException:
                # same orphan discipline as _dispatch_piece
                for e in entries:
                    e.slot.renew()
                raise
        self._reg.histogram("serve.dispatch_seconds").observe(time.perf_counter() - t0)
        self._reg.counter("serve.ring_dispatches").inc()
        if st.name != DEFAULT_MODEL:
            self._reg.counter(f"serve.ring_dispatches.{st.name}").inc()
        self._reg.histogram("serve.ring_slots_per_dispatch").observe(len(entries))
        self._reg.gauge("serve.ring_fill").set(len(entries) / r)
        self._reg.counter(f"serve.bucket_hits.{bucket}").inc(len(entries))
        # the filled slots' share of the R-slot graph's cost
        self._count_cost(_ring_cost_key(bucket, size, r, st.cost_tag), len(entries) / r)
        return PendingPrediction(self, [(host, rows, done)], t_start, time.perf_counter(), ctxs=ctxs)

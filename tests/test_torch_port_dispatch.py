"""The port's compiled dispatch (serve/engine.py): the fused-K ladder, overlapped
staging, the request ring and the executable cache, on the CPU.

On the CPU the engine runs each key's body eagerly (the device the caller
asked for); on a card the same keys are CUDA graphs. The invariants of the
JAX package's tests are mirrored within the port, bitwise, on tiny nets
(tests/test_serve.py's fused tests, the cold key and the off-ladder LRU;
tests/test_overlap.py; tests/test_ring.py), and the port's engine is held
against the JAX engine in every mode on one bundle and one input, within
FOLD_ATOL. The graphs themselves are held on the card by
tests/test_torch_port_kernels.py's card tests and by chip_smoke.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

from yet_another_mobilenet_series_tpu.serve import engine as jax_engine
from yet_another_mobilenet_series_tpu.serve.engine import BF16_PARITY_ATOL
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, RingConfig
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs import trace as obs_trace
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export, quant
from yet_another_mobilenet_series_tpu_torch.serve.batcher import MicroBatcher
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine, _Executable
from yet_another_mobilenet_series_tpu_torch.serve.pipeline import PipelinedBatcher
from yet_another_mobilenet_series_tpu_torch.serve.ring import RingEntry, min_slots, window_chunks

from test_torch_port_serve import FOLD_ATOL

SPECS = [{"t": 2, "c": 8, "n": 1, "s": 2}, {"t": 3, "c": 16, "n": 2, "s": 2}]
ATOM_SPECS = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25}, {"t": 3, "c": 16, "n": 2, "s": 2}]

def _net(specs=SPECS, num_classes=10):
    return get_model(ModelConfig(arch="mobilenet_v2", num_classes=num_classes, block_specs=specs, dropout=0.0),
                     image_size=24)


def _bundle(seed=0, specs=SPECS, int8=False):
    """An in-memory bundle of seeded weights with non-trivial BN statistics;
    ``int8`` quantizes its JAX-layout fold as an int8 export does."""
    net = _net(specs)
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    folded = export.fold_network(net, params, random_bn_state(net, gen))
    if int8:
        q, _ = quant.quantize_folded(convert.unflatten_tree(convert.to_jax(folded)))
        folded = convert.from_jax(convert.flatten_tree(q))
    return export.InferenceBundle(net=net, params=folded, meta={})


@pytest.fixture(scope="module")
def bundle():
    return _bundle()


def _x(rs, n, size=24):
    return rs.normal(0, 1, (n, size, size, 3)).astype(np.float32)


def _eng(bundle, **kw):
    kw = {"buckets": (2, 4), "image_size": 24, **kw}
    return InferenceEngine(bundle, device="cpu", **kw)


def _dispatch_delta(reg, before):
    return reg.snapshot().get("serve.dispatch_seconds.count", 0) - before.get("serve.dispatch_seconds.count", 0)


# ---------------------------------------------------------------------------
# executables: one per ladder key, captured at warmup
# ---------------------------------------------------------------------------


def test_engine_constructs_with_every_dispatch_option(bundle):
    eng = _eng(bundle, fuse_ladder=(2, 4), overlap_staging=True, ring_slots=4, wire="uint8")
    assert eng.fuse_ladder == (2, 4) and eng.ring_slots == 4 and eng.wire_np_dtype == np.uint8
    assert eng.quant_mode == "wire=uint8,weights=float32"


def test_warmup_builds_every_ladder_key(bundle):
    reg = get_registry()
    before = reg.snapshot()
    eng = _eng(bundle, image_sizes=(24, 32), fuse_ladder=(2, 4), ring_slots=3)
    eng.warmup()
    snap = reg.snapshot()
    assert sorted(k for k in eng._compiled if k[-1] != "ring") == sorted(
        ("default", b, s, k) for s in (24, 32) for b, k in ((2, 1), (4, 1), (4, 2), (4, 4)))
    assert sorted(k for k in eng._compiled if k[-1] == "ring") == [("default", 4, 24, 3, "ring"),
                                                                  ("default", 4, 32, 3, "ring")]
    for key in ("serve.compile_seconds.count", "obs.compiles", "obs.compile_seconds.count"):
        assert snap[key] - before.get(key, 0) == 10, key
    eng.warmup()  # every key is a hit now
    assert reg.snapshot()["obs.compiles"] == snap["obs.compiles"]
    report = eng.graph_report()
    assert len(report) == 10 and {r["kind"] for r in report} == {"k", "ring"}


# ---------------------------------------------------------------------------
# the fused-K ladder (tests/test_serve.py's fused tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,want", [(1, 4, 1), (2, 8, 1), (4, 16, 1), (3, 12, 2)])
def test_fused_bitwise_parity_across_k(bundle, k, n, want):
    """Fused logits == per-chunk logits BITWISE for K in {1, 2, 4} and an
    off-ladder K (3 -> one 2-piece + one chunk); on-ladder K is ONE
    dispatch."""
    chained = _eng(bundle)
    fused = _eng(bundle, fuse_ladder=(2, 4))
    fused.warmup()
    reg = get_registry()
    x = _x(np.random.RandomState(21 + k), n)
    ref = chained.predict(x)
    before = reg.snapshot()
    np.testing.assert_array_equal(fused.predict(x), ref)
    assert _dispatch_delta(reg, before) == want
    assert reg.snapshot().get("serve.fused_dispatches", 0) - before.get("serve.fused_dispatches", 0) == (k > 1)


@pytest.mark.parametrize("n,want", [(15, 1), (10, 2)])
def test_fused_tail_handling_bitwise(bundle, n, want):
    """n=15: 4 chunks, a tail of 3 pads to bucket 4 -> ONE fused K=4
    dispatch; n=10: 3 chunks, a tail of 2 fits bucket 2 -> a K=2 piece + a
    per-chunk tail. Both bitwise-equal to chained."""
    chained, fused = _eng(bundle), _eng(bundle, fuse_ladder=(2, 4))
    x = _x(np.random.RandomState(29), n)
    ref = chained.predict(x)
    reg = get_registry()
    before = reg.snapshot()
    np.testing.assert_array_equal(fused.predict(x), ref)
    assert _dispatch_delta(reg, before) == want


def test_fused_bf16_bitwise_vs_chained_bf16():
    b = _bundle(specs=ATOM_SPECS)
    chained = _eng(b, buckets=(4,), compute_dtype="bfloat16")
    fused = _eng(b, buckets=(4,), compute_dtype="bfloat16", fuse_ladder=(2,))
    fp32 = _eng(b, buckets=(4,), fuse_ladder=(2,))
    x = _x(np.random.RandomState(31), 8)
    got = fused.predict(x)
    np.testing.assert_array_equal(got, chained.predict(x))
    assert 0 < float(np.max(np.abs(fp32.predict(x) - got))) <= BF16_PARITY_ATOL


def test_fused_async_and_staging_reuse(bundle):
    """Fused predict_async == fused predict bitwise with handles pending
    concurrently, and padded fused dispatches reuse one (K, bucket, size)
    staging pool."""
    eng = _eng(bundle, fuse_ladder=(2,))
    eng.warmup()
    rs = np.random.RandomState(33)
    x, y = _x(rs, 7), _x(rs, 8)  # K=2 with a pad row; K=2 exact
    sync_x, sync_y = eng.predict(x.copy()), eng.predict(y.copy())
    hx, hy = eng.predict_async(x), eng.predict_async(y)
    np.testing.assert_array_equal(hy.result(), sync_y)
    np.testing.assert_array_equal(hx.result(), sync_x)
    pool = eng._staging[(4, 24, 2)]
    buf = pool.slots[0].buf
    np.testing.assert_array_equal(eng.predict(x), sync_x)
    assert eng._staging[(4, 24, 2)] is pool and pool.slots[0].buf is buf


@pytest.mark.parametrize("kind", ["micro", "pipelined"])
def test_batchers_route_oversized_coalesced_batch_to_fused(bundle, kind):
    """A coalesced batch over the biggest bucket reaches the engine whole
    and is ONE fused dispatch."""
    eng = _eng(bundle, buckets=(1, 4), fuse_ladder=(2,))
    eng.warmup()
    reg = get_registry()
    imgs = _x(np.random.RandomState(17), 8)
    ref = eng.predict(imgs)
    b = (MicroBatcher(eng.predict, max_batch=8, max_wait_ms=500.0) if kind == "micro"
         else PipelinedBatcher(eng, max_inflight=2, max_batch=8, max_wait_ms=500.0)).start()
    try:
        before = reg.snapshot()
        futs = [b.submit(imgs[i]) for i in range(8)]
        rows = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    assert _dispatch_delta(reg, before) == 1
    assert reg.snapshot()["serve.fused_dispatches"] - before.get("serve.fused_dispatches", 0) == 1
    np.testing.assert_array_equal(np.stack(rows), ref)


def test_cold_capture_does_not_block_warm_dispatch(bundle):
    """A warm-size dispatch completes while a cold-size capture is still in
    progress on another thread (the capture runs outside the dispatch
    lock)."""
    eng = _eng(bundle, buckets=(2,))
    eng.warmup()
    gate, entered = threading.Event(), threading.Event()
    real_build = eng._build

    def slow_build(model, bucket, size, k, ring=False):
        if size == 16:
            entered.set()
            assert gate.wait(10)
        return real_build(model, bucket, size, k, ring=ring)

    eng._build = slow_build
    cold_out = []
    t = threading.Thread(target=lambda: cold_out.append(eng.predict(np.zeros((2, 16, 16, 3), np.float32))),
                         daemon=True)
    try:
        t.start()
        assert entered.wait(10)
        warm = eng.predict(_x(np.random.RandomState(1), 2))
        assert warm.shape == (2, 10)
        assert t.is_alive()  # the cold capture was still blocked: no stall
    finally:
        gate.set()
    t.join(30)
    assert not t.is_alive() and cold_out[0].shape == (2, 10)


def test_offladder_lru_bounds_caches(bundle):
    """Off-ladder executables and staging live in a small LRU (on-ladder
    keys pinned), evictions counted; a hit refreshes recency."""
    eng = _eng(bundle, buckets=(2,), offladder_cache=2)
    eng.warmup()
    reg = get_registry()
    base = reg.snapshot().get("serve.evicted_executables", 0)
    for s in (8, 12, 16, 20):
        assert eng.predict(np.zeros((1, s, s, 3), np.float32)).shape == (1, 10)  # padded: staging too
    assert ("default", 2, 24, 1) in eng._compiled
    assert sorted(k[2] for k in eng._compiled if k[2] != 24) == [16, 20]
    assert reg.snapshot()["serve.evicted_executables"] - base == 2
    assert all(k[1] in (24, 16, 20) for k in eng._staging)
    eng.predict(np.zeros((1, 16, 16, 3), np.float32))
    eng.predict(np.zeros((1, 28, 28, 3), np.float32))
    assert sorted(k[2] for k in eng._compiled if k[2] != 24) == [16, 28]
    with pytest.raises(ValueError, match="offladder_cache"):
        _eng(bundle, offladder_cache=0)


# ---------------------------------------------------------------------------
# overlapped staging (tests/test_overlap.py)
# ---------------------------------------------------------------------------


def _pair(bundle, *, dtype="float32", fuse=(), slots=2, **kw):
    """(sync, overlapped) engine pair sharing one bundle and config."""
    common = dict(compute_dtype=dtype, fuse_ladder=fuse, **kw)
    return _eng(bundle, **common), _eng(bundle, overlap_staging=True, staging_slots=slots, **common)


@pytest.mark.parametrize("size", [24, 32])
def test_overlap_parity_across_buckets_and_sizes(bundle, size):
    sync, ov = _pair(bundle, image_sizes=(24, 32))
    rng = np.random.RandomState(size)
    for n in (1, 2, 3, 4, 5, 7, 9):
        x = _x(rng, n, size)
        assert np.array_equal(sync.predict(x), ov.predict(x)), n


def test_overlap_parity_fused(bundle):
    sync, ov = _pair(bundle, fuse=(2, 4))
    rng = np.random.RandomState(1)
    for k in (1, 2, 3, 4):
        x = _x(rng, 4 * k)
        assert np.array_equal(sync.predict(x), ov.predict(x)), k
    x = _x(rng, 9)  # a fused piece with a padded tail
    assert np.array_equal(sync.predict(x), ov.predict(x))


def test_overlap_parity_bf16(bundle):
    sync, ov = _pair(bundle, dtype="bfloat16")
    rng = np.random.RandomState(2)
    for n in (3, 4, 6):
        x = _x(rng, n)
        assert np.array_equal(sync.predict(x), ov.predict(x)), n


def test_overlap_parity_slot_reuse_single_slot(bundle):
    """staging_slots=1: every padded dispatch goes through the SAME slot,
    so the fence wait is on every call; alternating batches dispatched
    before any sync stay bitwise."""
    sync, ov = _pair(bundle, slots=1)
    rng = np.random.RandomState(3)
    batches = [_x(rng, 3) for _ in range(6)]
    refs = [sync.predict(x) for x in batches]
    handles = [ov.predict_async(x) for x in batches]
    for ref, h in zip(refs, handles):
        assert np.array_equal(h.result(), ref)


def test_overlap_parity_mixed_size_coalesced(bundle):
    sync, ov = _pair(bundle, image_sizes=(24, 32), fuse=(2,))
    ov.warmup()
    rng = np.random.RandomState(4)
    images = [rng.normal(0, 1, (s, s, 3)).astype(np.float32) for s in (24, 32) for _ in range(3)]
    refs = [sync.predict(img[None])[0] for img in images]
    b = PipelinedBatcher(ov, max_inflight=2, run_max=4, max_batch=4, max_wait_ms=5.0).start()
    try:
        rows = [f.result(timeout=60) for f in [b.submit(img) for img in images * 4]]
    finally:
        b.stop()
    for i, row in enumerate(rows):
        assert np.array_equal(row, refs[i % len(refs)]), i


def test_slot_reuse_stress_40_clients(bundle):
    """40 concurrent clients through max_inflight=2 with a 2-slot pool: no
    torn rows, no hangs, a clean drain."""
    sync, ov = _pair(bundle, slots=2)
    ov.warmup()
    rng = np.random.RandomState(5)
    distinct = [rng.normal(0, 1, (24, 24, 3)).astype(np.float32) for _ in range(8)]
    refs = [sync.predict(img[None])[0] for img in distinct]
    b = PipelinedBatcher(ov, max_inflight=2, run_max=4, max_batch=4, max_wait_ms=1.0, queue_depth=1024).start()
    errors: list = []
    lock = threading.Lock()

    def client(cid: int):
        try:
            for j in range(6):
                idx = (cid + j) % len(distinct)
                if not np.array_equal(b.submit(distinct[idx]).result(timeout=120), refs[idx]):
                    raise AssertionError(f"torn row for client {cid} req {j}")
        except Exception as e:  # noqa: BLE001 — surfaced below; the test must not hang
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(40)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), "a client hung"
    b.stop(drain=True)
    assert errors == [], errors[:3]


def test_dispatch_failure_orphans_slot_buffer(bundle):
    """A replay failing between the copy and fence arming orphans the slot's
    buffer (fresh storage, no fence) and the engine keeps serving
    bitwise-correct answers."""
    sync, ov = _pair(bundle)
    x = _x(np.random.RandomState(10), 3)
    ref = sync.predict(x)
    assert np.array_equal(ov.predict(x), ref)
    pool = ov._staging[(4, 24, 1)]
    bufs_before = [s.buf for s in pool.slots]
    ckey = ("default", 4, 24, 1)
    exe = ov._compiled[ckey]

    class _Boom(RuntimeError):
        pass

    def failing(x, mask=None):
        raise _Boom("injected dispatch failure")

    ov._compiled[ckey] = _Executable(fn=failing)
    with pytest.raises(_Boom):
        ov.predict(x)
    ov._compiled[ckey] = exe
    replaced = [i for i, s in enumerate(pool.slots) if s.buf is not bufs_before[i]]
    assert len(replaced) == 1 and pool.slots[replaced[0]].fence is None
    for _ in range(len(pool.slots) + 1):
        assert np.array_equal(ov.predict(x), ref)


class _SlowDispatchEngine:
    """Delays dispatch slightly so the submit loop can outrun the collect
    thread: a deterministic way to saturate the queue."""

    def __init__(self, engine, delay_s=0.003):
        self._engine = engine
        self._delay_s = delay_s
        self.buckets = engine.buckets

    def predict(self, images, ctxs=None):
        return self._engine.predict(images, ctxs=ctxs)

    def predict_async(self, images, ctxs=None):
        time.sleep(self._delay_s)
        return self._engine.predict_async(images, ctxs=ctxs)


def test_back_to_back_runs_on_saturated_bucket(bundle):
    sync, ov = _pair(bundle)
    ov.warmup()
    h = get_registry().histogram("serve.dispatches_per_wakeup")
    count0, sum0 = h.count, h.total
    img = _x(np.random.RandomState(7), 1)[0]
    ref = sync.predict(img[None])[0]
    b = PipelinedBatcher(_SlowDispatchEngine(ov), max_inflight=2, run_max=4, max_batch=4, max_wait_ms=1.0,
                         queue_depth=256).start()
    try:
        rows = [f.result(timeout=120) for f in [b.submit(img) for _ in range(64)]]
    finally:
        b.stop()
    assert all(np.array_equal(r, ref) for r in rows)
    wakeups, dispatches = h.count - count0, h.total - sum0
    assert dispatches >= 16 and dispatches / wakeups > 1.0, (dispatches, wakeups)
    assert h.vmax <= 2


def test_run_max_1_is_per_batch(bundle):
    _, ov = _pair(bundle)
    ov.warmup()
    h = get_registry().histogram("serve.dispatches_per_wakeup")
    count0, sum0 = h.count, h.total
    img = _x(np.random.RandomState(8), 1)[0]
    b = PipelinedBatcher(_SlowDispatchEngine(ov), max_inflight=2, run_max=1, max_batch=4, max_wait_ms=1.0,
                         queue_depth=256).start()
    try:
        for f in [b.submit(img) for _ in range(32)]:
            f.result(timeout=120)
    finally:
        b.stop()
    assert h.total - sum0 == h.count - count0


@pytest.mark.parametrize("ring", [False, True])
def test_dispatches_per_wakeup_counts_engine_pieces(bundle, ring):
    """The histogram's observed sum equals the serve.dispatch_seconds.count
    delta: an oversized batch on a non-fused engine is several pieces; a
    ring window, however many slots, is ONE."""
    eng = _eng(bundle, overlap_staging=True, ring_slots=4 if ring else 0)
    eng.warmup()
    reg = get_registry()
    h = reg.histogram("serve.dispatches_per_wakeup")
    sum0 = h.total
    d0 = reg.snapshot().get("serve.dispatch_seconds.count", 0)
    r0 = reg.snapshot().get("serve.ring_dispatches", 0)
    img = _x(np.random.RandomState(11), 1)[0]
    b = PipelinedBatcher(eng, max_inflight=2, max_batch=8, max_wait_ms=20.0).start()
    try:
        for f in [b.submit(img) for _ in range(48 if ring else 24)]:
            f.result(timeout=120)
    finally:
        b.stop()
    snap = reg.snapshot()
    pieces = snap["serve.dispatch_seconds.count"] - d0
    assert pieces >= (1 if ring else 3)
    assert h.total - sum0 == pieces
    if ring:
        assert snap.get("serve.ring_dispatches", 0) - r0 >= 1


def test_overlap_telemetry_counters(bundle, monkeypatch):
    """Every staging copy is one serve/h2d span under a profiler session,
    and a padded dispatch through the pool leaves its fence armed until the
    next acquire."""
    _, ov = _pair(bundle)
    ov.warmup()
    tracer = obs_trace.SpanTracer(ring_size=obs_trace.SESSION_RING, enabled=False)
    monkeypatch.setattr(obs_trace, "_TRACER", tracer)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        h = ov.predict_async(_x(np.random.RandomState(9), 3))
    assert any(s.fence is not None for s in ov._staging[(4, 24, 1)].slots)
    h.result()
    assert [r.name for r in tracer.records() if r.name == "serve/h2d"] == ["serve/h2d"]


# ---------------------------------------------------------------------------
# the request ring (tests/test_ring.py)
# ---------------------------------------------------------------------------


def _ring_vs_per_batch(eng, counts, size, *, wire="float32", seed=0):
    """Stage one window of ``counts`` slots, dispatch it, and hold the
    drained logits bitwise against the per-batch path, slot by slot."""
    rng = np.random.RandomState(seed)
    parts = [rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8) if wire == "uint8" else _x(rng, n, size)
             for n in counts]
    entries = [eng.ring_stage(p.copy()) for p in parts]
    out = eng.ring_dispatch(entries).result()
    assert out.shape[0] == sum(counts)
    at = 0
    for p in parts:
        np.testing.assert_array_equal(out[at: at + len(p)], eng.predict(p.copy()))
        at += len(p)
    return out


def test_ring_min_slots_and_window_chunks():
    assert min_slots(4, 0.5) == 2 and min_slots(4, 1.0) == 4 and min_slots(4, 0.01) == 1
    assert min_slots(3, 1 / 3) == 1
    chunks, leftover = window_chunks(list(range(10)), 4, 4)
    assert [len(c) for c in chunks] == [4, 4, 2] and leftover == []
    chunks, leftover = window_chunks(list(range(20)), 4, 4)
    assert [len(c) for c in chunks] == [4, 4, 4, 4] and leftover == [16, 17, 18, 19]
    assert window_chunks([], 4, 4) == ([], [])
    for cap, slots in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            window_chunks([1], cap, slots)


def test_ring_config_validation():
    assert RingConfig(enable=True, slots=6, min_fill=0.25).slots == 6
    for kw in (dict(slots=1), dict(min_fill=0.0), dict(min_fill=1.5)):
        with pytest.raises(ValueError):
            RingConfig(**kw)


def test_ring_engine_ctor_validation(bundle):
    with pytest.raises(ValueError, match="ring_slots"):
        _eng(bundle, buckets=(2,), ring_slots=1)
    eng = _eng(bundle, buckets=(2,))
    assert eng.ring_slots == 0 and not eng.ring_ready(None, 24)
    with pytest.raises(RuntimeError):
        eng.ring_stage(np.zeros((1, 24, 24, 3), np.float32))
    with pytest.raises(RuntimeError):
        eng.ring_dispatch([RingEntry(None, 1)])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_ring_parity_across_window_fills(bundle, wire):
    """Every fill a 4-deep ring admits over bucket 4 — saturated, partial
    last slot, one full slot, one partial slot — bitwise, f32 and u8 wire."""
    eng = _eng(bundle, wire=wire, ring_slots=4)
    eng.warmup()
    for seed, counts in enumerate([(4, 4, 4, 4), (4, 4, 2), (4,), (3,)]):
        _ring_vs_per_batch(eng, counts, 24, wire=wire, seed=seed)


def test_ring_parity_on_second_ladder_size(bundle):
    eng = _eng(bundle, image_sizes=(24, 32), ring_slots=4)
    eng.warmup()
    for size in (24, 32):
        assert eng.ring_ready(None, size)
        _ring_vs_per_batch(eng, (4, 3), size, seed=size)
    assert not eng.ring_ready(None, 48)


def test_ring_parity_int8_weights():
    eng = _eng(_bundle(seed=3, int8=True), ring_slots=4)
    assert eng.weights == "int8"
    eng.warmup()
    _ring_vs_per_batch(eng, (4, 4, 1), 24, seed=11)


def test_ring_parity_with_overlapped_staging(bundle):
    eng = _eng(bundle, ring_slots=4, overlap_staging=True, fuse_ladder=(2, 4))
    eng.warmup()
    for seed, counts in enumerate([(4, 4, 4, 4), (4, 1)]):
        _ring_vs_per_batch(eng, counts, 24, seed=40 + seed)


def test_ring_window_is_one_dispatch(bundle):
    """A saturated window of R full slots is exactly ONE
    serve.dispatch_seconds observation and one ring dispatch, fill 1.0."""
    eng = _eng(bundle, ring_slots=4)
    eng.warmup()
    reg = get_registry()
    snap0 = reg.snapshot()
    rng = np.random.RandomState(5)
    out = eng.ring_dispatch([eng.ring_stage(_x(rng, 4)) for _ in range(4)]).result()
    assert out.shape == (16, 10)
    snap = reg.snapshot()

    def delta(key):
        return snap.get(key, 0) - snap0.get(key, 0)

    assert delta("serve.dispatch_seconds.count") == 1 and delta("serve.ring_dispatches") == 1
    assert delta("serve.ring_slots_per_dispatch.count") == 1 and delta("serve.ring_slots_per_dispatch.sum") == 4
    assert snap["serve.ring_fill"] == 1.0
    assert delta("serve.infer_images") == 16 and delta("serve.bucket_hits.4") == 4
    _ring_vs_per_batch(eng, (4, 4), 24, seed=6)
    assert reg.snapshot()["serve.ring_fill"] == 0.5


def test_ring_dispatch_typed_window_errors(bundle):
    eng = _eng(bundle, ring_slots=4)
    eng.warmup()
    with pytest.raises(ValueError, match="ring slot holds"):
        eng.ring_stage(np.zeros((5, 24, 24, 3), np.float32))
    with pytest.raises(ValueError, match="ring_stage expects"):
        eng.ring_stage(np.zeros((2, 24, 32, 3), np.float32))
    partial = eng.ring_stage(np.zeros((2, 24, 24, 3), np.float32))
    full = eng.ring_stage(np.zeros((4, 24, 24, 3), np.float32))
    with pytest.raises(ValueError, match="LAST ring slot"):
        eng.ring_dispatch([partial, full])
    with pytest.raises(ValueError, match="ring window holds"):
        eng.ring_dispatch([])
    assert eng.ring_dispatch([full, partial]).result().shape == (6, 10)


def test_ring_pipeline_burst_rides_ring_trickle_does_not(bundle):
    eng = _eng(bundle, ring_slots=4)
    eng.warmup()
    reg = get_registry()
    r0 = reg.snapshot().get("serve.ring_dispatches", 0)
    b = PipelinedBatcher(eng, max_inflight=2, max_batch=8, max_wait_ms=20.0, queue_depth=64,
                         ring_min_fill=0.5).start()
    try:
        rng = np.random.RandomState(0)
        imgs = [rng.normal(0, 1, (24, 24, 3)).astype(np.float32) for _ in range(32)]
        results = {}
        lock = threading.Lock()

        def client(i):
            val = b.submit(imgs[i].copy()).result(timeout=30)
            with lock:
                results[i] = val

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst = reg.snapshot().get("serve.ring_dispatches", 0)
        assert burst - r0 >= 1, "a 32-deep burst never engaged the ring"
        for i in range(32):
            np.testing.assert_array_equal(results[i], eng.predict(imgs[i][None].copy())[0])
        for i in range(3):
            np.testing.assert_array_equal(b.submit(imgs[i].copy()).result(timeout=30),
                                          eng.predict(imgs[i][None].copy())[0])
        assert reg.snapshot().get("serve.ring_dispatches", 0) == burst
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# across packages: the port's engine against the JAX engine, per mode
# ---------------------------------------------------------------------------

MODES = {
    "per_chunk": dict(),
    "fused": dict(fuse_ladder=(2, 4)),
    "overlap": dict(fuse_ladder=(2,), overlap_staging=True, staging_slots=2),
    "ring": dict(ring_slots=4),
    "uint8": dict(wire="uint8", fuse_ladder=(2, 4)),
    "int8": dict(int8=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_engine_matches_jax_engine_per_mode(tmp_path, mode):
    """One bundle on disk, one input: the JAX engine and the port's engine in
    the same mode agree within FOLD_ATOL (the uint8 wire with ImageNet's
    mean and std, raw pixels on both sides)."""
    kw = dict(MODES[mode])
    int8 = kw.pop("int8", False)
    net = _net(ATOM_SPECS)
    gen = torch.Generator().manual_seed(4)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    rng = np.random.RandomState(12)
    calib = quant.normalize_reference(rng.randint(0, 256, (8, 24, 24, 3)).astype(np.uint8))
    out = export.export_bundle(net, params, state, str(tmp_path / "b"), quant_weights="int8" if int8 else "float32",
                               calib_images=calib, int8_top1_min=0.5, device="cpu")
    if kw.get("wire") == "uint8":
        kw.update(wire_mean=(0.485, 0.456, 0.406), wire_std=(0.229, 0.224, 0.225))
        x = rng.randint(0, 256, (11, 24, 24, 3)).astype(np.uint8)
    else:
        x = _x(rng, 11)
    ring = kw.pop("ring_slots", 0)
    jeng = jax_engine.InferenceEngine(jax_export.load_bundle(out), buckets=(2, 4), image_size=24,
                                      **{"fuse_ladder": (), **kw}, ring_slots=ring)
    peng = InferenceEngine(export.load_bundle(out), device="cpu", buckets=(2, 4), image_size=24, ring_slots=ring,
                           **kw)
    if ring:
        want = jeng.ring_dispatch([jeng.ring_stage(x[:4]), jeng.ring_stage(x[4:8]), jeng.ring_stage(x[8:])]).result()
        got = peng.ring_dispatch([peng.ring_stage(x[:4]), peng.ring_stage(x[4:8]), peng.ring_stage(x[8:])]).result()
    else:
        want, got = jeng.predict(x), peng.predict(x)
    assert got.shape == (11, 10) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=FOLD_ATOL, rtol=0)

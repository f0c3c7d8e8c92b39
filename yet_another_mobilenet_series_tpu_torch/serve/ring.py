# Copy of yet_another_mobilenet_series_tpu/serve/ring.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Device-resident request ring: one dispatch per steady-state window.

Back-to-back runs removed the completion WAKE-UP between batches on
a saturated bucket, but every batch is still its own XLA dispatch — the
host↔device boundary is paid once per batch forever. PAPERS.md "Kernel
Looping" (arXiv 2410.23668) names the end state: inter-call
synchronization, not compute, caps steady-state inference throughput, so a
saturated window should be ONE device program. The ring is that program.

**Shape.** A ring of R pre-staged batch slots per hot ``(model, bucket,
image_size)`` key — R is ``serve.ring.slots``, the bucket is always the
engine's biggest (a saturated window has no reason to ride a smaller one).
Host threads only FEED slots: each slot is a ``(bucket, S, S, 3)`` host
buffer in the wire dtype (u8 or f32), transferred with async
``jax.device_put`` through the same fence-tracked slot-pool idiom as
overlapped staging (serve/engine.py ``_SlotPool``), so the H2D copy of slot
k+1 overlaps the staging of slot k+2 and the compute of window N-1. One
AOT-compiled executable then consumes ALL currently-staged slots in a
single dispatch: a ``lax.scan`` over the stacked slot axis runs the same
per-chunk folded forward the K=1 executables compile — R iterations, one
host→device boundary, one ``serve.dispatch_seconds`` observation.

**The mask.** The scan carries an active-slot mask so a partially-filled
window (staged < R) runs the SAME executable — no per-fill recompile, no
shape cliff. Padded slots enter as device-side zero buffers (no H2D) and
their outputs are selected away by the mask; active slots' logits pass
through a scalar-bool ``where`` untouched, so ring logits are **bitwise
identical** to the per-batch path by construction — the same discipline as
the fused-K scan, pinned by tests/test_ring.py across buckets, sizes, the
u8 wire, int8 weights, and multi-model zoos.

**Feed/drain lifecycle.** The pipeline (serve/pipeline.py) engages the ring
only when the queue holds at least ``min_slots(R, serve.ring.min_fill)``
slots' worth of same-(model, shape) traffic — a saturated window — and
falls back to the existing per-batch dispatch otherwise (sync / pipelined /
fused / overlapped modes are intact and A/B-able). Within a window every
slot but the LAST is full, so the valid rows of the scan's ``(R, bucket,
classes)`` output are contiguous after flattening and the standard
:class:`~.engine.PendingPrediction` drains the whole window with one
device_get. Slot host buffers are rewritable only after the consuming ring
dispatch's OUTPUT logits exist (the fence; donation deletes the inputs), so
feeds for window N+1 can never tear a transfer still in flight for N.

This module holds the host-side window bookkeeping; the executables, the
staging pools, and the dispatch itself live on the engine
(:meth:`~.engine.InferenceEngine.ring_stage` /
:meth:`~.engine.InferenceEngine.ring_dispatch`).
"""

from __future__ import annotations

import math


class RingEntry:
    """One staged (fed) ring slot, pending its window's dispatch.

    ``x`` is the device array the async ``device_put`` returned (possibly
    still in transfer — only the compiled program may consume it, and it is
    donated there), ``rows`` the real rows staged into it (the rest is
    zero pad), ``slot`` the engine staging-pool slot backing the host
    buffer (None for an exact-fill zero-copy feed) whose fence the ring
    dispatch arms."""

    __slots__ = ("x", "rows", "slot")

    def __init__(self, x, rows: int, slot=None):
        self.x = x
        self.rows = int(rows)
        self.slot = slot


def min_slots(ring_slots: int, min_fill: float) -> int:
    """Staged slots a window must reach before a ring dispatch commits.

    ``serve.ring.min_fill`` is a fraction of the ring depth; below it the
    mask would discard more compute than the saved dispatch boundaries are
    worth, so the pipeline rides the per-batch path instead. Always at
    least 1 (an enabled ring with a tiny min_fill still needs one slot)."""
    return max(1, math.ceil(ring_slots * min_fill - 1e-9))


def window_chunks(items, cap: int, max_slots: int):
    """Split ``items`` into at most ``max_slots`` contiguous chunks of at
    most ``cap`` each — the window's slot plan. Returns ``(chunks,
    leftover)``: only the last chunk may be partial (the contiguity the
    drain's single flatten-and-slice relies on), and ``leftover`` holds
    whatever did not fit this window (it rides the next one, or the
    per-batch path)."""
    if cap < 1 or max_slots < 1:
        raise ValueError(f"window needs cap >= 1 and max_slots >= 1, got {cap}, {max_slots}")
    chunks = []
    start = 0
    while start < len(items) and len(chunks) < max_slots:
        chunks.append(items[start : start + cap])
        start += cap
    return chunks, items[start:]

"""Checkpoints of the port: the torch twin of
``yet_another_mobilenet_series_tpu/ckpt/manager.py`` (Orbax there).

The public surface is the JAX package's: ``save``, ``latest_step``,
``all_steps`` (newest first), ``tree_keys``, the two-phase restore
(``restore_spec``: the network from the JSON sidecar before any weights;
``restore_tree``: the weights), ``wait``, ``close`` and
:class:`CheckpointCorrupt`. On AtomNAS resume the spec comes first, so the
caller rebuilds the network at its pruned shape before a weight loads
(SURVEY.md §3.5).

On disk, one directory per step, written with ``torch.save`` and read back
with ``torch.load(weights_only=True)``::

    <dir>/digests.json          per-item sha256 of every step, outside the step dirs
    <dir>/<step>/meta.json      {"network": network_to_dict(net), "extra": {...}}
    <dir>/<step>/tree/items.json  the saved items, None-valued ones too
    <dir>/<step>/tree/<item>.pt   one nested dict of tensors (or one tensor) per item

The trees are stored as the port holds them (OIHW convs, ``models/convert.py``).
Beside the TrainState's fields a save takes ``items``: the training CLI
passes the state of the step's ``torch.Generator`` (the port's generator is
stateful, where JAX folds its key from the step).

What Orbax gave for free is done here:

- **The async save.** ``save`` snapshots the tree to host memory before it
  returns: each device tensor is copied into a pinned host buffer with a
  non-blocking copy on the current stream, fenced by one CUDA event, so the
  copies run before any later step's kernels on that stream, and the steps
  are functional (they never write a tensor they were given). A writer thread
  waits on the event and writes; the next ``save``, ``wait`` or ``close``
  joins it and raises what it raised.
- **Crash consistency.** Each step is written under a temporary name and
  ``os.replace``\\ d into place, so a kill mid-save leaves the previous steps
  whole; leftovers of a killed save are removed when a manager opens the
  directory, which is made at the first save. ``max_to_keep`` prunes the
  oldest steps after each write.
- **Integrity.** The per-item digests (:func:`_item_digests`, over each
  leaf's dtype, shape and bytes in flatten order) are computed from the host
  snapshot, recorded in ``digests.json`` before the step dir appears, pruned
  of collected steps, and verified by every targeted restore (the resume
  path): a mismatch counts ``ckpt.integrity_failures`` and raises
  :class:`CheckpointCorrupt`. An as-saved restore (the export path) is not
  verified, as in the JAX package.

In a data-parallel world (``group``) every rank holds the same state and
calls ``save``; only the coordinator (rank 0) snapshots and writes, and the
ranks meet at a barrier after each save and in ``wait``, so none runs on
(or reads the directory) before the coordinator has enqueued, or written,
the step. Every rank restores from the directory. The caller hands ``save``
the checkpoint form of its state: the ZeRO optimizer state gathered
(``parallel/zero.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import torch
import torch.distributed

from ..models.convert import flatten_tree
from ..models.serialize import network_from_dict, network_to_dict
from ..models.specs import Network
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.logging import emit

DIGEST_NAME = "digests.json"
META_NAME = "meta.json"
TREE_DIR = "tree"
ITEMS_NAME = "items.json"
_TMP = ".tmp-"  # a step dir being written: "<step>.tmp-<pid>"


class CheckpointCorrupt(RuntimeError):
    """Restored checkpoint bytes do not match the per-item digests recorded
    at save time: a half-written or corrupted item. The resume path treats
    this like a read error: fall back to an older step."""


def _leaves(value) -> list[torch.Tensor]:
    """The tensors of an item in flatten order (sorted key paths, as JAX
    flattens a dict); none for a None or empty item."""
    if value is None:
        return []
    if isinstance(value, torch.Tensor):
        return [value]
    flat = flatten_tree(value)
    return [flat[k] for k in sorted(flat, key=lambda p: p.split("/"))]


def _item_digests(tree: dict) -> dict[str, str]:
    """Per-item sha256 over every leaf's (dtype, shape, bytes) in flatten
    order. Items without a tensor (None fields, no masks) are omitted: there
    are no bytes to protect."""
    out: dict[str, str] = {}
    for key in sorted(tree):
        leaves = _leaves(tree[key])
        if not leaves:
            continue
        h = hashlib.sha256()
        for leaf in leaves:
            t = leaf.detach().to("cpu").contiguous()
            h.update(str(t.dtype).removeprefix("torch.").encode())
            h.update(repr(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())
        out[key] = h.hexdigest()
    return out


def _snapshot(tree: dict) -> tuple[dict, torch.cuda.Event | None]:
    """A host copy of every tensor of ``tree`` (None items stay None): a CPU
    tensor is cloned, a device tensor copied into a pinned buffer without
    waiting. Returns the copy and the event that fences the device copies
    (None when there were none)."""
    on_device = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        on_device.append(t.device)
        return out

    def walk(value):
        if value is None or isinstance(value, torch.Tensor):
            return None if value is None else copy(value)
        return {k: walk(v) for k, v in value.items()}

    host = {k: walk(v) for k, v in tree.items()}
    event = None
    if on_device:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(on_device[0]))
    return host, event


def _conform(saved, template, where: str):
    """``saved`` (CPU tensors) checked against ``template``'s structure,
    shapes and dtypes, each leaf moved to its template's device."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape or saved.dtype != template.dtype:
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise ValueError(f"{where}: saved {got} != expected {(tuple(template.shape), template.dtype)}")
        return saved.to(template.device)
    if not isinstance(saved, dict) or set(saved) != set(template):
        got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
        raise ValueError(f"{where}: saved keys {got} != expected {sorted(template)}")
    return {k: _conform(saved[k], template[k], f"{where}/{k}") for k in template}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = 3, async_save: bool = True, group=None):
        """``group``: the data-parallel process group (None: one process).
        The JAX package's manager also takes ``barrier_prefix``, which
        namespaces Orbax's cross-host barriers (the port's barriers are the
        group's own), and ``integrity``, which can turn the digests off; the
        port always records and verifies the digests."""
        self._group = group
        self._writer = group is None or torch.distributed.get_rank(group) == 0
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._name = f"ckpt-writer-{os.path.basename(os.path.normpath(directory))}"
        self._digest_warned = False
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        if self._writer and os.path.isdir(directory):  # the leftovers of a save killed mid-write go
            for name in os.listdir(directory):
                if _TMP in name:
                    shutil.rmtree(os.path.join(directory, name), ignore_errors=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, net: Network, train_state, extra: dict[str, Any] | None = None,
             items: dict[str, Any] | None = None) -> None:
        """Save the TrainState (and ``items``, trees of tensors such as the
        generator state) with the live network spec and the JSON-able
        ``extra``. Returns once the host snapshot is enqueued; the write runs
        on a thread when ``async_save``."""
        from ..train.steps import train_state_to_dict

        if not self._writer:
            self._barrier()
            return
        self._join()
        step = int(step)
        tree = {**train_state_to_dict(train_state), **(items or {})}
        meta = {"network": network_to_dict(net), "extra": extra or {}}
        # the span covers the snapshot's enqueue; the write shows in ckpt/wait
        with obs_trace.get_tracer().span("ckpt/save", "ckpt", step=step):
            host, event = _snapshot(tree)
            if self._async:
                self._thread = threading.Thread(target=self._write_guarded, args=(step, host, meta, event),
                                                name=self._name, daemon=True)
                self._thread.start()
        if not self._async:
            self._write(step, host, meta, event)
        get_registry().counter("ckpt.saves").inc()
        self._barrier()

    def _barrier(self) -> None:
        if self._group is not None:
            torch.distributed.barrier(group=self._group)

    def _write_guarded(self, step, host, meta, event) -> None:
        try:
            self._write(step, host, meta, event)
        except BaseException as e:  # noqa: BLE001 — handed to the caller's next join
            self._error = e

    def _write(self, step: int, host: dict, meta: dict, event) -> None:
        if event is not None:
            event.synchronize()
        tmp = os.path.join(self._dir, f"{step}{_TMP}{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, TREE_DIR))
        for key, value in host.items():
            if value is not None:
                torch.save(value, os.path.join(tmp, TREE_DIR, f"{key}.pt"))
        with open(os.path.join(tmp, TREE_DIR, ITEMS_NAME), "w") as f:
            json.dump({k: v is not None for k, v in host.items()}, f, indent=0, sort_keys=True)
        with open(os.path.join(tmp, META_NAME), "w") as f:
            json.dump(meta, f, default=str)
        # recorded before the step dir appears: a step on disk always has its
        # digests
        self._record_digests(step, _item_digests(host))
        final = os.path.join(self._dir, str(step))
        old = None
        if os.path.exists(final):  # the same step saved again: the new one wins
            old = f"{final}{_TMP}old{os.getpid()}"
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        if self._max_to_keep and self._max_to_keep > 0:
            for stale in self.all_steps()[self._max_to_keep:]:
                shutil.rmtree(os.path.join(self._dir, str(stale)), ignore_errors=True)

    # -- digest sidecar ------------------------------------------------------

    def _load_digests(self) -> dict:
        try:
            with open(os.path.join(self._dir, DIGEST_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _record_digests(self, step: int, digests: dict[str, str]) -> None:
        index = self._load_digests()
        index[str(step)] = digests
        # entries of steps already pruned go; the new step is not on disk yet
        live = {str(s) for s in self.all_steps()} | {str(step)}
        keep = {k: v for k, v in index.items() if k in live}
        tmp = os.path.join(self._dir, f"{DIGEST_NAME}{_TMP}{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(keep, f, indent=0, sort_keys=True)
            os.replace(tmp, os.path.join(self._dir, DIGEST_NAME))
        except OSError as e:
            # a read-only or full checkpoint dir degrades integrity
            # bookkeeping, not the save itself, but say so, once
            if not self._digest_warned:
                self._digest_warned = True
                emit(f"[ckpt] WARNING: could not write {DIGEST_NAME} ({type(e).__name__}: {e}); restore "
                     "integrity verification is disabled for this run")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _verify(self, step: int, tree: dict) -> None:
        expected = self._load_digests().get(str(step))
        if not expected:
            return  # no digests recorded for this step: nothing to judge
        actual = _item_digests(tree)
        bad = sorted(k for k, v in actual.items() if k in expected and expected[k] != v)
        if bad:
            get_registry().counter("ckpt.integrity_failures").inc()
            raise CheckpointCorrupt(f"step {step}: restored item(s) {bad} do not match the digests recorded at "
                                    "save time (half-written or corrupted checkpoint)")

    # -- queries -------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """The steps on disk, NEWEST FIRST: the fallback-restore candidate
        order (cli/train.py ``_restore``)."""
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted((int(n) for n in names if n.isdigit() and os.path.isdir(os.path.join(self._dir, n))),
                      reverse=True)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[0] if steps else None

    def _items(self, step: int) -> dict[str, bool]:
        with open(os.path.join(self._dir, str(step), TREE_DIR, ITEMS_NAME)) as f:
            return json.load(f)

    def tree_keys(self, step: int) -> set[str] | None:
        """The names of the saved items (None-valued ones too), from the
        step's item list alone. None when it is unreadable: what lets the
        resume path tell a legacy layout (a field absent from the save) from
        corruption of a field that is on disk."""
        try:
            return set(self._items(step))
        except (OSError, ValueError) as e:
            emit(f"[ckpt] step {step}: tree metadata unreadable ({type(e).__name__}: {e})")
            return None

    # -- restore -------------------------------------------------------------

    def restore_spec(self, step: int | None = None):
        """Phase 1 of resume: (step, net, extra) with the network rebuilt from
        the JSON sidecar before any weight is read (the pruned-shape-first
        ordering), or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with obs_trace.get_tracer().span("ckpt/restore_spec", "ckpt", step=int(step)):
            with open(os.path.join(self._dir, str(step), META_NAME)) as f:
                meta = json.load(f)
        return step, network_from_dict(meta["network"]), meta["extra"]

    def restore_tree(self, step: int, target: dict | None = None) -> dict:
        """Phase 2: the saved items as a dict. With ``target`` (a dict of
        trees of tensors, e.g. ``train_state_to_dict`` of a TrainState built
        at the restored network's shape: the RESUME path) every item of the
        target must be on disk with its structure, shapes and dtypes, is
        digest-verified, and lands on its template's device; items on disk
        that the target lacks (the generator state) come back on the CPU.
        Without ``target``, everything comes back as saved, on the CPU,
        unverified (the export path)."""
        with obs_trace.get_tracer().span("ckpt/restore_tree", "ckpt", step=int(step)):
            saved = self._items(step)
            if target is not None:
                missing = sorted(k for k in target if k not in saved)
                if missing:
                    raise ValueError(f"step {step}: the saved tree has no item(s) {missing}")
            tree_dir = os.path.join(self._dir, str(step), TREE_DIR)
            tree = {k: torch.load(os.path.join(tree_dir, f"{k}.pt"), map_location="cpu", weights_only=True)
                    if present else None for k, present in saved.items()}
            if target is not None:
                self._verify(int(step), tree)
                tree = {k: _conform(tree[k], target[k], f"step {step}: {k}") if k in target else v
                        for k, v in tree.items()}
        get_registry().counter("ckpt.restores").inc()
        return tree

    # -- lifetime ------------------------------------------------------------

    def _join(self) -> None:
        """Join the in-flight write, raising what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Block until the in-flight save is on disk."""
        t0 = time.perf_counter()
        with obs_trace.get_tracer().span("ckpt/wait", "ckpt"):
            self._join()
            self._barrier()
        get_registry().histogram("ckpt.wait_seconds").observe(time.perf_counter() - t0)

    def close(self) -> None:
        self._join()

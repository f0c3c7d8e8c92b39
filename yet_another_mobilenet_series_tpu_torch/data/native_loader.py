# Copy of yet_another_mobilenet_series_tpu/data/native_loader.py: the port keeps its own copy so that it never imports
# the JAX package. Its library is the port's (ops/host_build.py), built from csrc/ into build/, never native/.
"""ctypes binding for the native C++ input pipeline (native/yamt_loader.cc)
— the DALI-replacement decode+augment path (SURVEY.md §2 #6 native table).

Covers ImageFolder-style directory trees (the reference's torchvision
fallback): ``root/<class_name>/<image>.jpg``, classes sorted
lexicographically to indices — plus explicit (path, label) lists. Yields the
same {'image','label'} numpy batches as the tf.data pipeline, so the trainer
is agnostic to which pipeline feeds it (cfg.data.loader == 'native').
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Sequence

import numpy as np

from ..config import DataConfig
from ..obs.registry import get_registry
from ..ops import host_build

_lib = None

# live loaders, so the train loop can log aggregate decode failures without
# holding a reference to the loader behind its iterator wrappers
import weakref

_live_loaders: "weakref.WeakSet[NativeLoader]" = weakref.WeakSet()


def total_decode_failures() -> int:
    """Sum of decode failures across live loaders (0 when none exist)."""
    return sum(l.decode_failures for l in list(_live_loaders) if l._handle is not None)


def build_library(force: bool = False) -> str:
    """The port's host library (csrc/jpeg_io.cc with the copied
    csrc/yamt_loader.cc, ops/host_build.py): built at first use into build/,
    keyed by its sources, so a stale library can never be loaded against
    newer ctypes signatures."""
    host_build.load(force)
    return host_build.library_path()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.loader_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.loader_start.argtypes = [ctypes.c_void_p]
    lib.loader_start.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
    lib.loader_next_u8.restype = ctypes.c_int
    lib.loader_num_samples.argtypes = [ctypes.c_void_p]
    lib.loader_num_samples.restype = ctypes.c_int64
    lib.loader_decode_failures.argtypes = [ctypes.c_void_p]
    lib.loader_decode_failures.restype = ctypes.c_int64
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def list_image_folder(root: str) -> tuple[list[str], list[int], list[str]]:
    """(paths, labels, class_names) for a root/<class>/<img>.jpg tree."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    paths: list[str] = []
    labels: list[int] = []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpg", ".jpeg")):
                paths.append(os.path.join(cdir, f))
                labels.append(idx)
    return paths, labels, classes


class LoaderExhausted(Exception):
    """The native stream ended (loader stopped/destroyed). A dedicated type —
    NOT StopIteration, which PEP 479 turns into RuntimeError when raised
    through a generator (data/__init__.py wraps next_batch in generators)."""


class NativeLoader:
    """Iterator over decoded/augmented batches from the C++ pipeline.

    Streams epochs continuously (train semantics; eval order is file order
    with a fresh pass every num_samples//batch batches, remainder dropped).
    The ring prefetches ahead, so the first batches of the next epoch may
    already be decoding while the current one is consumed."""

    def __init__(
        self,
        paths: Sequence[str],
        labels: Sequence[int],
        cfg: DataConfig,
        batch: int,
        *,
        train: bool,
        seed: int = 0,
        num_threads: int | None = None,
        pad_batches: int = 0,
        start_batch: int = 0,
    ):
        """pad_batches > 0: every pass serves exactly that many batches,
        padding past the sample list with label=-1 (exact eval counting).
        start_batch: resume position — the stream begins at this global
        batch index, bit-identical to an uninterrupted run's (every batch
        is a pure function of (seed, global_batch) in the C++ pipeline)."""
        lib = _load()
        mean = (ctypes.c_float * 3)(*cfg.mean)
        std = (ctypes.c_float * 3)(*cfg.std)
        self._lib = lib
        self._batch = batch
        self._size = cfg.image_size
        self._uint8 = bool(cfg.transfer_uint8)
        self._handle = lib.loader_create(
            cfg.image_size, cfg.eval_resize, batch,
            num_threads or cfg.decode_threads, int(train), seed, mean, std,
            cfg.rrc_area_min, cfg.rrc_area_max, cfg.rrc_ratio_min, cfg.rrc_ratio_max,
            cfg.color_jitter if train else 0.0, pad_batches, start_batch,
            int(cfg.transfer_uint8),
        )
        for p, l in zip(paths, labels):
            lib.loader_add_file(self._handle, os.fsencode(p), int(l))
        if lib.loader_start(self._handle) != 0:
            lib.loader_destroy(self._handle)
            self._handle = None
            if pad_batches:
                raise ValueError("padded eval pass needs at least one sample")
            raise ValueError(f"need at least one full batch of samples ({batch}); got {len(paths)}")
        _live_loaders.add(self)
        # pull-gauge: the train loop no longer reaches into this module at
        # log boundaries — the registry snapshot reads the live total
        # (corrupt inputs stay visible through the one metrics path)
        get_registry().gauge("data.decode_failures").set_fn(total_decode_failures)

    @property
    def num_samples(self) -> int:
        return int(self._lib.loader_num_samples(self._handle))

    @property
    def decode_failures(self) -> int:
        return int(self._lib.loader_decode_failures(self._handle))

    def __iter__(self) -> Iterator[dict]:
        while True:
            try:
                yield self.next_batch()
            except LoaderExhausted:
                return

    def next_batch(self) -> dict:
        labels = np.empty((self._batch,), np.int32)
        if self._uint8:
            # raw pixels, 4x smaller on the wire; the train/eval step
            # normalizes on device (train/steps.py _input_normalizer)
            images = np.empty((self._batch, self._size, self._size, 3), np.uint8)
            rc = self._lib.loader_next_u8(
                self._handle,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        else:
            images = np.empty((self._batch, self._size, self._size, 3), np.float32)
            rc = self._lib.loader_next(
                self._handle,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        if rc != 0:
            raise LoaderExhausted
        return {"image": images, "label": labels}

    def close(self):
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _host_shard(paths, labels, process_index: int, process_count: int):
    """Disjoint per-host slice (the tf.data path's ds.shard equivalent —
    without it every host would decode the identical stream and global
    batches would hold process_count duplicates of each sample)."""
    return paths[process_index::process_count], labels[process_index::process_count]


def make_native_train_iter(
    cfg: DataConfig, local_batch: int, seed: int, process_index: int = 0, process_count: int = 1,
    start_step: int = 0,
) -> NativeLoader:
    """start_step: local batches this host already consumed (== the global
    train step on every host) — the resumed stream continues from there."""
    paths, labels, _ = list_image_folder(os.path.join(cfg.data_dir, cfg.train_split))
    paths, labels = _host_shard(paths, labels, process_index, process_count)
    # per-host seed offset decorrelates shuffle order across hosts
    return NativeLoader(paths, labels, cfg, local_batch, train=True, seed=seed + process_index,
                        start_batch=start_step)


def make_native_eval_loader(
    cfg: DataConfig, local_batch: int, process_index: int = 0, process_count: int = 1
) -> tuple[NativeLoader, int]:
    """Returns (loader, num_batches) for one EXACT eval pass over this host's
    shard: every example counts once. num_batches derives from the LARGEST
    host shard (a number all hosts agree on without communicating), so every
    host runs the same count of collective eval steps; shards smaller than
    num_batches*batch pad the tail with label=-1 rows, which the eval step
    masks out of every metric."""
    paths, labels, _ = list_image_folder(os.path.join(cfg.data_dir, cfg.val_split))
    total = len(paths)
    paths, labels = _host_shard(paths, labels, process_index, process_count)
    max_shard = -(-total // process_count)  # largest host shard size (ceil)
    n_batches = max(-(-max_shard // local_batch), 1)
    loader = NativeLoader(paths, labels, cfg, local_batch, train=False, pad_batches=n_batches)
    return loader, n_batches


if __name__ == "__main__":
    import sys

    if "--build" in sys.argv:
        print(build_library(force=True))

"""Input pipelines of the port: the one dispatch point for which pipeline
feeds the trainer, keyed on (dataset, loader) as in the JAX package's
``data/__init__.py``, with the invalid combinations refused up front.

Valid combinations:
  dataset=imagenet + loader=tfdata    -> TFRecord shards, read by the port's
                                         own reader (no TensorFlow; the
                                         loader's name is kept so the apps
                                         run unchanged)
  dataset=fake     + loader=tfdata    -> the learnable fake dataset, made on
                                         the device
  dataset=folder   + loader=native    -> an image folder through the port's
                                         copy of the native C++ loader
  dataset=fake     + loader=synthetic -> one fixed batch on the device

The fake streams are on ``device`` already; the real ones yield host
batches (CPU tensors: uint8 pixels under ``data.transfer_uint8``, else
normalized float32), which the caller moves to its device
(``parallel/mesh.py`` ``prefetch_to_device``). RandAugment runs on the
device after that move (``data/randaugment.py`` ``device_stage``).
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..config import DataConfig
from . import pipeline as _pipeline

VALID = {("imagenet", "tfdata"), ("fake", "tfdata"), ("folder", "native"), ("fake", "synthetic")}
REAL = {("imagenet", "tfdata"), ("folder", "native")}


def _check(cfg: DataConfig) -> None:
    if (cfg.dataset, cfg.loader) not in VALID:
        raise ValueError(
            f"unsupported data config: dataset={cfg.dataset!r} loader={cfg.loader!r}; valid: {sorted(VALID)}"
        )
    if cfg.transfer_uint8 and (cfg.dataset, cfg.loader) not in REAL:
        # fake templates live in normalized space: there are no [0,255]
        # pixels to quantize
        raise ValueError(
            "data.transfer_uint8 requires a real-JPEG pipeline "
            "(imagenet/tfdata or folder/native); "
            f"got dataset={cfg.dataset!r} loader={cfg.loader!r}"
        )
    if cfg.randaugment_layers < 0 or not 0 <= cfg.randaugment_magnitude <= 10:
        raise ValueError(
            f"randaugment_layers must be >= 0 and randaugment_magnitude in [0, 10]; "
            f"got {cfg.randaugment_layers}/{cfg.randaugment_magnitude}"
        )
    if cfg.randaugment_layers > 0 and (cfg.dataset, cfg.loader) != ("imagenet", "tfdata"):
        # as in the JAX package: implemented for the TFRecord pipeline only
        raise ValueError(
            "RandAugment requires the imagenet/tfdata pipeline "
            f"(data/randaugment.py); got dataset={cfg.dataset!r} loader={cfg.loader!r} "
            "(for fake-data smoke runs set data.randaugment_layers=0)"
        )


def order_note(cfg: DataConfig) -> str:
    """The startup log's line on the train stream's order: what mixes the
    records, and that the stream is a pure function of (seed, step) under
    either ``data.deterministic_input``, so a resume is exact."""
    if cfg.dataset == "imagenet":
        if cfg.deterministic_input:
            order = ("a per-epoch (seed, epoch) permutation of this host's shards, read back to back (interleave "
                     f"cycle 1, no record buffer; data.shuffle_buffer={cfg.shuffle_buffer} and "
                     f"data.decode_threads={cfg.decode_threads} do not reorder it)")
        else:
            order = ("a per-epoch (seed, epoch) permutation of this host's shards, read through an interleave of "
                     f"data.decode_threads={cfg.decode_threads} shards (block 1) and a record shuffle buffer of "
                     f"data.shuffle_buffer={cfg.shuffle_buffer} records, drawn from (seed, epoch) and drained at "
                     "each epoch's end")
    elif cfg.dataset == "folder":
        order = f"the native loader's seeded order (data.shuffle_buffer={cfg.shuffle_buffer} sizes nothing)"
    else:
        order = f"a per-epoch (seed, epoch) permutation (data.shuffle_buffer={cfg.shuffle_buffer} sizes nothing)"
    return (f"input order: {order}; data.deterministic_input={cfg.deterministic_input} holds by construction: "
            "exact resume, the stream is a pure function of (seed, step)")


def is_real(cfg: DataConfig) -> bool:
    """True for the pipelines that read JPEGs on the host."""
    return (cfg.dataset, cfg.loader) in REAL


def make_train_source(cfg: DataConfig, local_batch: int, seed: int, process_index: int = 0,
                      process_count: int = 1, start_step: int = 0, inject=None, *,
                      device: str | torch.device = "cuda", fake=None) -> Iterator[dict]:
    """Endless {'image', 'label'} batches of this host's shard (rank
    ``process_index`` of ``process_count``), from step ``start_step`` on:
    a resumed run continues the data order, bit for bit on every pipeline.

    ``inject`` wraps the RAW stream before the resilience layers (the fault
    injector, ``train/faults.py``), so injected corrupt records take the
    path real ones take: the corrupt-record skip
    (``cfg.skip_corrupt_records``, :func:`pipeline.resilient_batches`) and,
    for the real pipelines, the background prefetch thread
    (``cfg.prefetch_thread``, :class:`pipeline.PrefetchWorker`). ``fake``:
    a ``FakeImages`` already on ``device`` to draw from."""
    _check(cfg)
    if not is_real(cfg):
        return _pipeline.make_train_source(cfg, local_batch, seed, device=device, fake=fake, start_step=start_step,
                                           inject=inject, rank=process_index, world=process_count)
    if cfg.loader == "native":
        from . import native_loader

        src = iter(native_loader.make_native_train_iter(
            cfg, local_batch, seed, process_index, process_count, start_step=start_step))
    else:
        src = _pipeline.RecordTrainStream(cfg, local_batch, seed, process_index, process_count, start_step)
    src = _TorchBatches(src)
    if inject is not None:
        src = inject(src)
    if cfg.skip_corrupt_records:
        src = _pipeline.resilient_batches(src, max_consecutive=cfg.max_consecutive_failures)
    if cfg.prefetch_thread:
        src = _pipeline.PrefetchWorker(src, depth=cfg.prefetch)
    return src


class _TorchBatches:
    """The raw stream as torch batches, as an iterator that keeps serving
    after it raised (what the injector and the skip rely on; a generator
    would end at its first exception)."""

    def __init__(self, it):
        self._it = it

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        # stream positions (RandAugment's keys) stay a host array
        return {k: v if k == "pos" else torch.from_numpy(v) for k, v in next(self._it).items()}


def make_eval_source(cfg: DataConfig, local_batch: int, process_index: int = 0, process_count: int = 1, *,
                     device: str | torch.device = "cuda", fake=None) -> Iterator[dict]:
    """Finite iterator for one eval pass; the same batch count on every host
    (padded with label -1)."""
    _check(cfg)
    if not is_real(cfg):
        fake = fake or _pipeline.FakeImages(cfg, device)
        return fake.eval_batches(local_batch, process_index, process_count)
    if cfg.loader == "native":
        from . import native_loader

        loader, n_batches = native_loader.make_native_eval_loader(cfg, local_batch, process_index, process_count)

        def gen():
            try:
                for served in range(n_batches):
                    try:
                        batch = loader.next_batch()
                    except native_loader.LoaderExhausted:
                        # a padded eval pass has a KNOWN length; ending early
                        # means the loader died, and this rank would run fewer
                        # collective steps than its peers
                        raise RuntimeError(
                            f"native eval stream ended after {served}/{n_batches} batches") from None
                    yield {k: torch.from_numpy(v) for k, v in batch.items()}
            finally:
                loader.close()

        return gen()
    return ({k: torch.from_numpy(v) for k, v in b.items()}
            for b in _pipeline.record_eval_batches(cfg, local_batch, process_index, process_count))

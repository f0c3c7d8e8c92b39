"""Input data of the port: the torch twin of
``yet_another_mobilenet_series_tpu/data/pipeline.py``.

**Real JPEGs** (``data.dataset=imagenet``, ``folder``; the dispatch is
``data/__init__.py``): image folders go through the port's copy of the
native C++ loader (``native_loader.py``); ImageNet TFRecord shards are read
by the port's own reader (``tfrecord.py``, no TensorFlow) and their JPEGs
decoded and transformed by the same C++ code (``jpeg.py``), with
``data.decode_threads`` threads:

- the train stream (:class:`RecordTrainStream`) reads this host's shards
  (every ``process_count``-th file) in an order drawn from (seed, epoch),
  records running on across epochs; the record at stream position ``p``
  gets the native loader's random-resized crop, flip and colour jitter with
  draws seeded from (seed + process_index, p). So the stream is a pure
  function of (seed, step) and a run resumed at ``start_step`` sees the
  uninterrupted run's batches bit for bit. The JAX package draws its crops
  with TensorFlow's stateless ops, which cannot be reproduced without
  TensorFlow: the port's crops equal the JAX package's tf.data crops in
  distribution, not in draws (its folder batches equal the JAX native
  loader's bit for bit). A batch holding a record that does not decode
  raises :class:`CorruptRecordError` (the skip is
  :func:`resilient_batches`'s, as with tf.data);
- the eval stream (:func:`record_eval_batches`) reads every record once,
  in the JAX package's order (tf.data's interleave of the shards, cycle 4;
  record ``i`` of it on host ``i % process_count``), with the native loader's
  eval transform: the shorter side resized to ``eval_resize``, the centre
  ``image_size`` crop. Every host runs :func:`eval_batches_per_host`
  batches, the tail padded with label -1.

Batches are numpy on the host (uint8 pixels under ``data.transfer_uint8``,
normalized on the device by ``train/steps.py``); the CLI moves them with
``parallel/mesh.py`` ``prefetch_to_device``. :class:`PrefetchWorker`
(``data.prefetch_thread``) produces them on a thread of its own, with
bounded restarts.

**The fake dataset** is the JAX package's learnable classification task:
class ``c`` has a fixed template, drawn from ``np.random.RandomState(777)``
exactly as there (so the templates are equal across the packages), and a
sample of index ``i`` is ``templates[i % K] + 0.3 * noise``. The templates
live on the device, and every train batch is made there: a gather and one
``randn``, so the host never waits on it.

The fake train stream is a pure function of its position, as the JAX
package's is: epoch ``e``'s order is drawn from a generator seeded by
(seed, e), and the noise of the batch of global step ``s`` from one seeded
by (seed, s) (:func:`stream_seed`; re-seeding a generator is host-side
work). So a run resumed at step ``k`` (``make_train_source(...,
start_step=k)``) sees batch ``k`` of the uninterrupted run, bit for bit,
without drawing the ``k`` batches before it. The train streams are
``torch.Generator``\\ s on the device.

The fake eval set is one dataset on every device: its noise is made on the
device from integer hashes of (image index, element) alone
(:func:`eval_noise`), so a run on the card and one on the CPU evaluate the
same images, bit for bit, whatever the batch size, and the host draws
nothing. Neither stream is tf.data's (stateless per-index noise and its
shuffle buffer), so the port's samples differ from the JAX package's by
their noise and order, not by their templates or labels.

:func:`resilient_batches` is the JAX package's: a corrupt record
(:class:`CorruptRecordError`) costs one skipped batch, counted, and
``data.max_consecutive_failures`` in a row abort with
:class:`DataPipelineError`.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..config import DataConfig
from ..obs.registry import get_registry
from ..utils.device import resolve_device
from ..utils.logging import emit
from . import jpeg, tfrecord

# the JAX package's seeds: the class templates, and the eval noise's salt
TEMPLATE_SEED = 777
EVAL_NOISE_SEED = 987654
NOISE_SCALE = 0.3
# the salts of the train streams' seeds (stream_seed)
ORDER_SALT = 1
NOISE_SALT = 2
FILE_ORDER_SALT = 4
# the eval noise: a sum of four uniform 16-bit integers (Irwin-Hall), centred
# and scaled to unit variance by one float32 constant
_M32 = 0xFFFFFFFF
_IH_MEAN = 2 * 0xFFFF
_IH_INV_STD = float(np.float32(1.0 / np.sqrt((65536.0**2 - 1) / 3)))


def stream_seed(salt: int, seed: int, index: int, *more: int) -> int:
    """The 63-bit seed of one epoch's order (``ORDER_SALT``, the epoch) or
    one train batch's noise (``NOISE_SALT``, the global step, and in a world
    of several ranks the rank and the world's size): numpy's
    ``SeedSequence`` hash of the integers."""
    words = np.random.SeedSequence([salt, seed & (2**64 - 1), index, *more]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 32-bit words held in int64 (C. Wellons' "hash
    prospector" function [16 21f0aaad 15 735a2d97 15]). Both multipliers
    are below 2**31, so no product leaves int64, and every step is exact
    integer arithmetic: equal on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def eval_noise(first: int, rows: int, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The unit-variance noise of eval images ``first .. first + rows - 1``,
    float32 ``(rows, *shape)``. Image ``i``'s key is hashed from ``i`` and
    ``EVAL_NOISE_SEED``, each of its elements takes two 32-bit words,
    ``hash32(hash32(word index) ^ key)``, and their four 16-bit halves sum
    to an Irwin-Hall variate. Integer work, one exact conversion and one
    float32 product: the same bits on the CPU and on a card."""
    per_image = 2 * int(np.prod(shape))
    words = hash32(torch.arange(per_image, device=device, dtype=torch.int64))
    keys = hash32(hash32(torch.arange(first, first + rows, device=device, dtype=torch.int64) & _M32)
                  ^ EVAL_NOISE_SEED)
    h = hash32(words[None, :] ^ keys[:, None])
    total = ((h & 0xFFFF) + (h >> 16)).view(rows, per_image // 2, 2).sum(-1)
    return ((total - _IH_MEAN).to(torch.float32) * _IH_INV_STD).view(rows, *shape)


def check(cfg: DataConfig) -> None:
    """What the fake streams take (``FakeImages``, the synthetic loader):
    ``data.dataset=fake`` with no uint8 transfer and no RandAugment, as in the
    JAX package. Real JPEGs are ``data/__init__.py``'s."""
    if cfg.dataset != "fake":
        raise ValueError(f"the fake streams take data.dataset='fake', not {cfg.dataset!r}; real JPEGs go through "
                         "data.make_train_source / make_eval_source")
    if cfg.loader not in ("tfdata", "synthetic"):
        raise ValueError(f"unsupported data config: dataset='fake' loader={cfg.loader!r}; the fake dataset is "
                         "generated on the device (loader tfdata) or served as one fixed batch (loader synthetic)")
    if cfg.transfer_uint8:
        raise ValueError("data.transfer_uint8 requires a real-JPEG pipeline; the fake templates live in "
                         "normalized space (as in the JAX package)")
    if cfg.randaugment_layers > 0:
        raise ValueError("RandAugment requires the imagenet/tfdata pipeline (data/randaugment.py); for fake-data "
                         "runs set data.randaugment_layers=0")


def fake_templates(num_classes: int, image_size: int) -> np.ndarray:
    """The class templates (K, S, S, 3) float32, as the JAX package draws them."""
    rng = np.random.RandomState(TEMPLATE_SEED)
    return rng.normal(0, 1, (num_classes, image_size, image_size, 3)).astype(np.float32)


class FakeImages:
    """The fake dataset with its templates on ``device``; made once per run
    and shared by the train and eval streams."""

    def __init__(self, cfg: DataConfig, device: str | torch.device = "cuda"):
        check(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_classes = cfg.fake_num_classes or 1000
        self.templates = torch.from_numpy(fake_templates(self.num_classes, cfg.image_size)).to(self.device)

    def _images(self, labels: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        noise = torch.randn((labels.shape[0], *self.templates.shape[1:]), generator=gen, device=self.device)
        return self.templates[labels.long()] + NOISE_SCALE * noise

    def train_batches(self, local_batch: int, seed: int, start_step: int = 0, rank: int = 0,
                      world: int = 1) -> Iterator[dict]:
        """Endless batches of ``local_batch`` rows from global step
        ``start_step`` on: the indices of each epoch in a fresh random
        order, batches running across epochs (the JAX stream's
        shuffle().repeat().batch(drop_remainder)). Each epoch's order and
        each batch's noise depend on (seed, epoch) and (seed, step) alone.

        In a world of ``world`` ranks the global batch is ``local_batch *
        world`` indices and rank ``rank`` takes rows ``rank * local_batch``
        on of it; its noise is drawn from (seed, step, rank, world), so the
        ranks make only their own rows."""
        n = self.cfg.fake_train_size
        order_gen = torch.Generator(device=self.device)
        noise_gen = torch.Generator(device=self.device)

        def epoch_order(epoch: int) -> torch.Tensor:
            order_gen.manual_seed(stream_seed(ORDER_SALT, seed, epoch))
            return torch.argsort(torch.rand(n, generator=order_gen, device=self.device))

        step = start_step
        global_batch = local_batch * world
        epoch, pos = divmod(start_step * global_batch, n)
        order = epoch_order(epoch)
        rank_salt = (rank, world) if world > 1 else ()
        while True:
            parts, need = [], global_batch
            while need:
                if pos == n:
                    epoch, pos = epoch + 1, 0
                    order = epoch_order(epoch)
                take = min(need, n - pos)
                parts.append(order[pos: pos + take])
                pos, need = pos + take, need - take
            idx = parts[0] if len(parts) == 1 else torch.cat(parts)
            idx = idx[rank * local_batch: (rank + 1) * local_batch]
            labels = (idx % self.num_classes).to(torch.int32)
            noise_gen.manual_seed(stream_seed(NOISE_SALT, seed, step, *rank_salt))
            yield {"image": self._images(labels, noise_gen), "label": labels}
            step += 1

    def eval_batches(self, local_batch: int, rank: int = 0, world: int = 1) -> Iterator[dict]:
        """One pass over the eval set in index order, the last batch padded
        to ``local_batch`` rows with label -1 (masked out of every count).
        Image ``i``'s noise is :func:`eval_noise` of ``i``, made on the
        device: the same images on every device and at every batch size.

        In a world of ``world`` ranks rank r takes the r-th of ``world``
        contiguous blocks of ceil(n / world) images, and every rank runs the
        same number of batches (padded ones where its block runs out): the
        eval step sums over the group, and a rank that stopped early would
        leave the others waiting in the collective."""
        n = self.cfg.fake_eval_size
        per_rank = -(-n // world)
        lo, hi = min(rank * per_rank, n), min((rank + 1) * per_rank, n)
        shape = tuple(self.templates.shape[1:])
        for start in range(lo, lo + -(-per_rank // local_batch) * local_batch, local_batch):
            rows = max(min(local_batch, hi - start), 0)
            labels = (torch.arange(start, start + rows, device=self.device) % self.num_classes).to(torch.int32)
            noise = eval_noise(start, rows, shape, self.device)
            image = self.templates[labels.long()] + NOISE_SCALE * noise
            if rows < local_batch:
                pad = local_batch - rows
                image = torch.cat([image, image.new_zeros((pad, *image.shape[1:]))])
                labels = torch.cat([labels, labels.new_full((pad,), -1)])
            yield {"image": image, "label": labels}


def synthetic_device_batches(cfg: DataConfig, local_batch: int, num_classes: int, *,
                             device: str | torch.device = "cuda") -> Iterator[dict]:
    """One fixed batch on the device, forever (the JAX package's synthetic
    loader): model throughput without any input work."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.normal(0, 1, (local_batch, cfg.image_size, cfg.image_size, 3))
                                  .astype(np.float32)).to(dev),
        "label": torch.from_numpy((np.arange(local_batch) % num_classes).astype(np.int32)).to(dev),
    }
    while True:
        yield batch


class CorruptRecordError(RuntimeError):
    """A record (or the batch it landed in) could not be decoded. Raised by
    the train/faults.py injector and recognized by resilient_batches."""


class DataPipelineError(RuntimeError):
    """Too many CONSECUTIVE corrupt batches: the stream is systematically
    broken (rotten shard, wrong directory), not transiently unlucky."""


def resilient_batches(it: Iterator[dict], max_consecutive: int = 16) -> Iterator[dict]:
    """Wraps a batch iterator so a corrupt record costs one skipped batch
    (counted in ``data.corrupt_records``) instead of the run; the
    iterator must keep serving after it raised (the fault injector's does).
    ``max_consecutive`` consecutive failures abort with
    :class:`DataPipelineError`. Any other error propagates untouched:
    resilience here is for bad DATA, not bad code."""
    reg = get_registry()
    consecutive = 0
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        except CorruptRecordError as e:
            consecutive += 1
            reg.counter("data.corrupt_records").inc()
            if consecutive >= max_consecutive:
                raise DataPipelineError(
                    f"{consecutive} consecutive corrupt/undecodable batches "
                    f"(data.max_consecutive_failures={max_consecutive}); the stream is systematically broken"
                ) from e
            continue
        consecutive = 0
        yield batch


def make_train_source(cfg: DataConfig, local_batch: int, seed: int, *, device: str | torch.device = "cuda",
                      fake: FakeImages | None = None, start_step: int = 0, inject=None, rank: int = 0,
                      world: int = 1) -> Iterator[dict]:
    """Endless {'image', 'label'} batches on ``device``, from global step
    ``start_step`` on (a resumed run continues the order; the synthetic
    loader serves one batch whatever the position): rank ``rank``'s
    ``local_batch`` rows of each global batch of a world of ``world``.
    ``inject`` wraps the raw stream before :func:`resilient_batches`
    (``cfg.skip_corrupt_records``), so the fault injector's corrupt records
    take the path real ones would."""
    check(cfg)
    if cfg.loader == "synthetic":
        src = synthetic_device_batches(cfg, local_batch, cfg.fake_num_classes or 1000, device=device)
    else:
        src = (fake or FakeImages(cfg, device)).train_batches(local_batch, seed, start_step, rank, world)
    if inject is not None:
        src = inject(src)
    if cfg.skip_corrupt_records:
        src = resilient_batches(src, max_consecutive=cfg.max_consecutive_failures)
    return src


# ---------------------------------------------------------------------------
# real JPEGs: TFRecord shards, padding, the prefetch thread
# ---------------------------------------------------------------------------


def eval_batches_per_host(cfg: DataConfig, local_batch: int, process_count: int = 1) -> int:
    """Fixed number of eval batches EVERY host must run (the JAX package's):
    the eval step is a collective, so each host pads its finite stream up to
    this count, derived from the declared eval set size, the only number all
    hosts agree on without communicating."""
    n = cfg.fake_eval_size if cfg.dataset == "fake" else cfg.num_eval_examples
    per_host = -(-n // process_count)  # ceil
    return max(-(-per_host // local_batch), 1)


def _shard_indexes(files: list[str]) -> list[np.ndarray]:
    return [tfrecord.record_index(f) for f in files]


class RecordTrainStream:
    """The imagenet train stream of this host (see the module docstring):
    endless numpy batches of ``local_batch`` rows from global step
    ``start_step`` on, decoded ``cfg.prefetch`` batches ahead by a thread of
    its own. With RandAugment each batch also carries ``pos``, the stream
    position of each row (the device stage keys its draws by it). It keeps
    serving after it raised :class:`CorruptRecordError` for a batch."""

    def __init__(self, cfg: DataConfig, local_batch: int, seed: int, process_index: int = 0,
                 process_count: int = 1, start_step: int = 0):
        files = tfrecord._tfrecord_files(cfg, cfg.train_split)
        self.files = files[process_index::process_count]
        if not self.files:
            raise ValueError(f"host {process_index}/{process_count} got zero TFRecord shards ({len(files)} total); "
                             "fewer shards than hosts cannot feed training")
        self.cfg = cfg
        self.batch = local_batch
        self.seed = seed
        self.aug_seed = seed + process_index  # the native loader's per-host offset
        self._index = _shard_indexes(self.files)
        self.records_per_epoch = sum(len(i) for i in self._index)
        if self.records_per_epoch == 0:
            raise ValueError(f"no records in this host's {len(self.files)} TFRecord shards")
        self._fds = [os.open(f, os.O_RDONLY) for f in self.files]
        self._orders: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.decode_failures = 0
        self._next_step = start_step
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="yamt-records")
        self._pending: collections.deque = collections.deque()

    def _epoch(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """(file order, cumulative record counts in that order) of one epoch."""
        got = self._orders.get(epoch)
        if got is None:
            rng = np.random.default_rng(stream_seed(FILE_ORDER_SALT, self.seed, epoch))
            order = rng.permutation(len(self.files))
            got = (order, np.cumsum([len(self._index[f]) for f in order]))
            self._orders = {e: v for e, v in self._orders.items() if e >= epoch - 1}
            self._orders[epoch] = got
        return got

    def _record(self, position: int) -> bytes:
        epoch, r = divmod(position, self.records_per_epoch)
        order, cum = self._epoch(epoch)
        k = int(np.searchsorted(cum, r, side="right"))
        f = int(order[k])
        j = r - (int(cum[k - 1]) if k else 0)
        offset, length = self._index[f][j]
        return tfrecord.read_record(self._fds[f], int(offset), int(length))

    def make_batch(self, step: int) -> tuple[dict, int]:
        """Batch ``step`` of this host's stream and how many of its records
        did not decode (or did not read)."""
        positions = list(range(step * self.batch, (step + 1) * self.batch))
        payloads, labels, bad = [], [], 0
        for p in positions:
            try:
                image, label = tfrecord.parse_image_example(self._record(p))
            except tfrecord.CorruptRecord:
                image, label, bad = b"", 0, bad + 1
            payloads.append(image)
            labels.append(label)
        out, failed = jpeg.decode_batch(payloads, labels, positions, self.cfg, self.batch, train=True,
                                        seed=self.aug_seed,
                                        uint8=self.cfg.transfer_uint8 or self.cfg.randaugment_layers > 0)
        if self.cfg.randaugment_layers > 0:
            out["pos"] = np.asarray(positions, np.int64)
        return out, int(failed.sum())

    def __iter__(self) -> "RecordTrainStream":
        return self

    def __next__(self) -> dict:
        while len(self._pending) < max(1, self.cfg.prefetch):
            self._pending.append(self._pool.submit(self.make_batch, self._next_step))
            self._next_step += 1
        batch, bad = self._pending.popleft().result()
        if bad:
            self.decode_failures += bad
            get_registry().counter("data.record_decode_failures").inc(bad)
            raise CorruptRecordError(f"{bad} record(s) of a train batch did not decode")
        return batch

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        for fd in self._fds:
            os.close(fd)
        self._fds = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — best-effort release at collection
            pass


# the JAX package's eval reads its shards through tf.data's interleave of
# cycle 4, block 1 (data/pipeline.py make_eval_dataset)
EVAL_CYCLE = 4


def interleave(iterators: list, cycle: int) -> Iterator:
    """tf.data's deterministic ``interleave`` (block length 1) over
    ``iterators`` in order: up to ``cycle`` open at once, one item from each
    in turn; an exhausted one frees its slot, which takes the next iterator
    when the turn comes back to it."""
    pending = iter(iterators)
    slots: list = [None] * cycle
    index, open_, end = 0, 0, False
    while not end or open_:
        if slots[index] is not None:
            try:
                item = next(slots[index])
            except StopIteration:
                slots[index] = None
                open_ -= 1
                index = (index + 1) % cycle
                continue
            index = (index + 1) % cycle
            yield item
        elif not end:
            nxt = next(pending, None)
            if nxt is None:
                end = True
            else:
                slots[index] = nxt
                open_ += 1
        else:
            index = (index + 1) % cycle


def record_eval_batches(cfg: DataConfig, local_batch: int, process_index: int = 0,
                        process_count: int = 1) -> Iterator[dict]:
    """One eval pass over the TFRecord shards of ``cfg.val_split`` (see the
    module docstring): exactly :func:`eval_batches_per_host` numpy batches.
    A record whose JPEG does not decode is labelled -1 and counted in
    ``data.record_decode_failures``."""
    target = eval_batches_per_host(cfg, local_batch, process_count)
    files = tfrecord._tfrecord_files(cfg, cfg.val_split)

    def records():
        for i, data in enumerate(interleave([tfrecord.iter_records(f) for f in files], EVAL_CYCLE)):
            if i % process_count == process_index:
                yield tfrecord.parse_image_example(data)

    it = records()
    for _ in range(target):
        chunk = [r for _, r in zip(range(local_batch), it)]
        out, failed = jpeg.decode_batch([c[0] for c in chunk], [c[1] for c in chunk], [0] * len(chunk), cfg,
                                        local_batch, train=False, seed=0)
        if failed.any():
            get_registry().counter("data.record_decode_failures").inc(int(failed.sum()))
        yield out


class PrefetchWorker:
    """Host-side background prefetch (the JAX package's): a bounded queue fed
    by a worker thread, so batch production overlaps the train loop's
    dispatch work. An exception in production is counted
    (``data.worker_crashes``), the loop restarts in place up to
    ``max_restarts`` times (``data.worker_restarts``; the iterator survives
    its own exceptions), and then the error goes to the CONSUMER through the
    queue: the train loop dies with the real cause, never by waiting forever
    on a dead thread."""

    _END = ("end", None)

    def __init__(self, it: Iterator[dict], depth: int = 4, max_restarts: int = 3):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._max_restarts = max_restarts
        self._thread = threading.Thread(target=self._run, name="yamt-data-prefetch", daemon=True)
        self._thread.start()

    def _run(self):
        try:
            reg = get_registry()
            restarts = 0
            while not self._stop.is_set():
                try:
                    self._pump()
                    return  # stream exhausted (or stop requested) cleanly
                except Exception as e:  # noqa: BLE001 — bounded restart, then surface
                    reg.counter("data.worker_crashes").inc()
                    if restarts >= self._max_restarts:
                        self._put(("error", e))
                        return
                    restarts += 1
                    reg.counter("data.worker_restarts").inc()
                    emit(f"[data] prefetch worker crashed ({type(e).__name__}: {e}); "
                         f"restart {restarts}/{self._max_restarts}")
        except Exception as e:  # noqa: BLE001 — terminal guard: die loud
            self._put(("error", e))

    def _pump(self):
        while not self._stop.is_set():
            try:
                item = ("item", next(self._it))
            except StopIteration:
                self._put(self._END)
                return
            self._put(item)

    def _put(self, item):
        # stop-aware put: a consumer that walked away must not wedge the
        # worker (and so interpreter shutdown) on a full queue
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        kind, payload = self._q.get()
        if kind == "item":
            return payload
        if kind == "error":
            self.close()
            raise payload
        raise StopIteration

    def close(self):
        self._stop.set()
        # drain so a blocked _put observes the stop promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

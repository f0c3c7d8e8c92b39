"""Input data on the device: the torch twin of the fake dataset, the
synthetic loader and the resilience layer of
``yet_another_mobilenet_series_tpu/data/pipeline.py`` and ``data/__init__.py``.

Only these are ported. ImageNet TFRecords (``data.dataset=imagenet``),
image folders (``folder``) and the native C++ loader read JPEGs on the host
through tf.data or ``native/``; the card's machine has no TensorFlow, and
they are refused with a ``ValueError`` (ROADMAP queue 1, item 10).

The fake dataset is the JAX package's learnable classification task: class
``c`` has a fixed template, drawn from ``np.random.RandomState(777)`` exactly
as there (so the templates are equal across the packages), and a sample of
index ``i`` is ``templates[i % K] + 0.3 * noise``. The templates live on the
device, and every train batch is made there: a gather and one ``randn``, so
the host never waits on it.

The train stream is a pure function of its position, as the JAX package's
is: epoch ``e``'s order is drawn from a generator seeded by (seed, e), and
the noise of the batch of global step ``s`` from one seeded by (seed, s)
(:func:`stream_seed`; re-seeding a generator is host-side work). So a run
resumed at step ``k`` (``make_train_source(..., start_step=k)``) sees
batch ``k`` of the uninterrupted run, bit for bit, without drawing the ``k``
batches before it. The train streams are ``torch.Generator``\\ s on the
device.

The eval set is one dataset on every device: its noise is made on the
device from integer hashes of (image index, element) alone
(:func:`eval_noise`), so a run on the card and one on the CPU evaluate the
same images, bit for bit, whatever the batch size, and the host draws
nothing. Neither stream is tf.data's (stateless per-index noise and its
shuffle buffer), so the port's samples differ from the JAX package's by
their noise and order, not by their templates or labels.

:func:`resilient_batches` is the JAX package's: a corrupt record
(:class:`CorruptRecordError`, raised by ``train/faults.py``) costs one
skipped batch, counted, and ``data.max_consecutive_failures`` in a row
abort with :class:`DataPipelineError`.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..config import DataConfig
from ..obs.registry import get_registry
from ..utils.device import resolve_device

# the JAX package's seeds: the class templates, and the eval noise's salt
TEMPLATE_SEED = 777
EVAL_NOISE_SEED = 987654
NOISE_SCALE = 0.3
# the salts of the train streams' seeds (stream_seed)
ORDER_SALT = 1
NOISE_SALT = 2
# the eval noise: a sum of four uniform 16-bit integers (Irwin-Hall), centred
# and scaled to unit variance by one float32 constant
_M32 = 0xFFFFFFFF
_IH_MEAN = 2 * 0xFFFF
_IH_INV_STD = float(np.float32(1.0 / np.sqrt((65536.0**2 - 1) / 3)))


def stream_seed(salt: int, seed: int, index: int) -> int:
    """The 63-bit seed of one epoch's order (``ORDER_SALT``, the epoch) or
    one train batch's noise (``NOISE_SALT``, the global step): numpy's
    ``SeedSequence`` hash of the three integers."""
    words = np.random.SeedSequence([salt, seed & (2**64 - 1), index]).generate_state(2, np.uint32)
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
    """Refuse what the port does not generate."""
    if cfg.dataset != "fake":
        raise ValueError(f"data.dataset={cfg.dataset!r} reads JPEGs on the host (tf.data / native/), which the "
                         "port does not do yet (ROADMAP queue 1, item 10); use data.dataset=fake")
    if cfg.loader not in ("tfdata", "synthetic"):
        raise ValueError(f"data.loader={cfg.loader!r} is not ported (ROADMAP queue 1, item 10); the fake "
                         "dataset is generated on the device (loader tfdata) or served as one fixed "
                         "batch (loader synthetic)")
    if cfg.transfer_uint8:
        raise ValueError("data.transfer_uint8 requires a real-JPEG pipeline; the fake templates live in "
                         "normalized space (as in the JAX package)")
    if cfg.randaugment_layers > 0:
        raise ValueError("RandAugment requires the imagenet/tfdata pipeline (ROADMAP queue 1, item 10); "
                         "for fake-data runs set data.randaugment_layers=0")


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

    def train_batches(self, local_batch: int, seed: int, start_step: int = 0) -> Iterator[dict]:
        """Endless batches of ``local_batch`` rows from global step
        ``start_step`` on: the indices of each epoch in a fresh random
        order, batches running across epochs (the JAX stream's
        shuffle().repeat().batch(drop_remainder)). Each epoch's order and
        each batch's noise depend on (seed, epoch) and (seed, step) alone."""
        n = self.cfg.fake_train_size
        order_gen = torch.Generator(device=self.device)
        noise_gen = torch.Generator(device=self.device)

        def epoch_order(epoch: int) -> torch.Tensor:
            order_gen.manual_seed(stream_seed(ORDER_SALT, seed, epoch))
            return torch.argsort(torch.rand(n, generator=order_gen, device=self.device))

        step = start_step
        epoch, pos = divmod(start_step * local_batch, n)
        order = epoch_order(epoch)
        while True:
            parts, need = [], local_batch
            while need:
                if pos == n:
                    epoch, pos = epoch + 1, 0
                    order = epoch_order(epoch)
                take = min(need, n - pos)
                parts.append(order[pos: pos + take])
                pos, need = pos + take, need - take
            idx = parts[0] if len(parts) == 1 else torch.cat(parts)
            labels = (idx % self.num_classes).to(torch.int32)
            noise_gen.manual_seed(stream_seed(NOISE_SALT, seed, step))
            yield {"image": self._images(labels, noise_gen), "label": labels}
            step += 1

    def eval_batches(self, local_batch: int) -> Iterator[dict]:
        """One pass over the eval set in index order, the last batch padded
        to ``local_batch`` rows with label -1 (masked out of every count).
        Image ``i``'s noise is :func:`eval_noise` of ``i``, made on the
        device: the same images on every device and at every batch size."""
        n = self.cfg.fake_eval_size
        shape = tuple(self.templates.shape[1:])
        for start in range(0, n, local_batch):
            rows = min(local_batch, n - start)
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
                      fake: FakeImages | None = None, start_step: int = 0, inject=None) -> Iterator[dict]:
    """Endless {'image', 'label'} batches on ``device``, from global step
    ``start_step`` on (a resumed run continues the order; the synthetic
    loader serves one batch whatever the position). ``inject`` wraps the
    raw stream before :func:`resilient_batches` (``cfg.skip_corrupt_records``),
    so the fault injector's corrupt records take the path real ones would."""
    check(cfg)
    if cfg.loader == "synthetic":
        src = synthetic_device_batches(cfg, local_batch, cfg.fake_num_classes or 1000, device=device)
    else:
        src = (fake or FakeImages(cfg, device)).train_batches(local_batch, seed, start_step)
    if inject is not None:
        src = inject(src)
    if cfg.skip_corrupt_records:
        src = resilient_batches(src, max_consecutive=cfg.max_consecutive_failures)
    return src

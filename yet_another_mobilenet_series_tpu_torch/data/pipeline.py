"""Input data on the device: the torch twin of the fake dataset and the
synthetic loader of ``yet_another_mobilenet_series_tpu/data/pipeline.py``.

Only these two are ported. ImageNet TFRecords (``data.dataset=imagenet``),
image folders (``folder``) and the native C++ loader read JPEGs on the host
through tf.data or ``native/``; the card's machine has no TensorFlow, and
they are refused with a ``ValueError`` (ROADMAP queue 1, item 10).

The fake dataset is the JAX package's learnable classification task: class
``c`` has a fixed template, drawn from ``np.random.RandomState(777)`` exactly
as there (so the templates are equal across the packages), and a sample of
index ``i`` is ``templates[i % K] + 0.3 * noise``. The templates live on the
device, and every batch is made there: a gather and one ``randn``, so the
host never waits on it. The noise and the shuffle come from
``torch.Generator``\\ s on the device; those streams are not tf.data's
(stateless per-index noise and its shuffle buffer), so the port's samples
differ from the JAX package's by their noise and order, not by their
templates or labels.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..config import DataConfig
from ..utils.device import resolve_device

# the JAX package's seeds: the class templates, and the eval noise's salt
TEMPLATE_SEED = 777
EVAL_NOISE_SEED = 987654
NOISE_SCALE = 0.3


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

    def train_batches(self, local_batch: int, seed: int) -> Iterator[dict]:
        """Endless batches of ``local_batch`` rows: the indices of each
        epoch in a fresh random order, batches running across epochs (the
        JAX stream's shuffle().repeat().batch(drop_remainder))."""
        n = self.cfg.fake_train_size
        order_gen = torch.Generator(device=self.device).manual_seed(seed)
        noise_gen = torch.Generator(device=self.device).manual_seed(seed + 1)

        def epoch_order():
            return torch.argsort(torch.rand(n, generator=order_gen, device=self.device))

        order, pos = epoch_order(), 0
        while True:
            parts, need = [], local_batch
            while need:
                if pos == n:
                    order, pos = epoch_order(), 0
                take = min(need, n - pos)
                parts.append(order[pos: pos + take])
                pos, need = pos + take, need - take
            idx = parts[0] if len(parts) == 1 else torch.cat(parts)
            labels = (idx % self.num_classes).to(torch.int32)
            yield {"image": self._images(labels, noise_gen), "label": labels}

    def eval_batches(self, local_batch: int) -> Iterator[dict]:
        """One pass over the eval set in index order, the last batch padded
        to ``local_batch`` rows with label -1 (masked out of every count).
        The noise is drawn from a fixed seed, so every pass sees the same
        images."""
        n = self.cfg.fake_eval_size
        gen = torch.Generator(device=self.device).manual_seed(EVAL_NOISE_SEED)
        for start in range(0, n, local_batch):
            rows = min(local_batch, n - start)
            labels = (torch.arange(start, start + rows, device=self.device) % self.num_classes).to(torch.int32)
            image = self._images(labels, gen)
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


def make_train_source(cfg: DataConfig, local_batch: int, seed: int, *, device: str | torch.device = "cuda",
                      fake: FakeImages | None = None) -> Iterator[dict]:
    """Endless {'image', 'label'} batches on ``device``."""
    check(cfg)
    if cfg.loader == "synthetic":
        return synthetic_device_batches(cfg, local_batch, cfg.fake_num_classes or 1000, device=device)
    return (fake or FakeImages(cfg, device)).train_batches(local_batch, seed)

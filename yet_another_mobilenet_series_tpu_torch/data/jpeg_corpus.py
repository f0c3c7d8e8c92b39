"""Seeded JPEG datasets for tests and the card's smoke run (no dataset may be
downloaded there): an image folder ``<root>/<split>/class_<k>/<i>.jpg`` and
the same images as TFRecord shards ``<root>/<split>-<s>-of-<n>``.

Image ``i`` of class ``k`` is class ``k``'s template (an 8 x 8 RGB grid of
levels in [40, 215], bilinearly upsampled to the image's size) plus Gaussian
noise of standard deviation ``NOISE`` drawn from (seed, split, k, i), rounded
and clipped to uint8. Its size is drawn from ``SIZES`` (ImageNet-like
landscape and portrait shapes), and it is encoded by the port's own encoder
(``data/jpeg.py``) unless the caller passes another.

``python -m yet_another_mobilenet_series_tpu_torch.data.jpeg_corpus
--reference <dir>`` writes the small reference JPEGs and their decodes by
this host's JPEG library (``reference_images``), which a host that decodes
through nvJPEG is held to (``chip_smoke.py`` phase 13).
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from . import jpeg, tfrecord

SIZES = ((500, 375), (375, 500), (500, 333), (640, 480))  # (width, height)
NOISE = 20.0
TEMPLATE_GRID = 8
_SPLIT_SALT = {"train": 1, "val": 2, "validation": 2}


def class_templates(num_classes: int, seed: int) -> np.ndarray:
    """(K, 8, 8, 3) float32 levels in [40, 215]."""
    rng = np.random.default_rng([seed, 0])
    return rng.uniform(40.0, 215.0, (num_classes, TEMPLATE_GRID, TEMPLATE_GRID, 3)).astype(np.float32)


def _upsample(grid: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear (half-pixel centres, edges clamped) upsampling of a (g, g, 3) grid."""
    g = grid.shape[0]

    def axis(n):
        src = np.clip((np.arange(n) + 0.5) * g / n - 0.5, 0, g - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, g - 1)
        return lo, hi, (src - lo).astype(np.float32)

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    top = grid[y0][:, x0] * (1 - wx)[None, :, None] + grid[y0][:, x1] * wx[None, :, None]
    bot = grid[y1][:, x0] * (1 - wx)[None, :, None] + grid[y1][:, x1] * wx[None, :, None]
    return top * (1 - wy)[:, None, None] + bot * wy[:, None, None]


def render(templates: np.ndarray, label: int, index: int, seed: int, split: str,
           bases: dict | None = None) -> np.ndarray:
    """Image ``index`` of class ``label``: (H, W, 3) uint8. ``bases`` caches
    the upsampled templates by (label, width, height)."""
    rng = np.random.default_rng([seed, _SPLIT_SALT.get(split, 3), label, index])
    w, h = SIZES[int(rng.integers(len(SIZES)))]
    key = (label, w, h)
    base = None if bases is None else bases.get(key)
    if base is None:
        base = _upsample(templates[label], w, h).astype(np.float32)
        if bases is not None:
            bases[key] = base
    noise = rng.standard_normal(base.shape, dtype=np.float32)
    noise *= np.float32(NOISE)
    noise += base
    return np.clip(np.rint(noise), 0, 255).astype(np.uint8)


def write_image_folder(root: str, split: str, num_classes: int, per_class: int, seed: int = 0, quality: int = 90,
                       encode: Callable[[np.ndarray, int], bytes] | None = None,
                       workers: int | None = None) -> list[tuple[str, int]]:
    """Writes ``<root>/<split>/class_<k>/<i>.jpg`` with ``workers`` threads
    (default: one a core; numpy and the encoder release the GIL); returns
    (path, label) in the folder's sorted order (the native loader's)."""
    encode = encode or jpeg.encode
    templates = class_templates(num_classes, seed)
    bases: dict = {}
    out = []
    for k in range(num_classes):
        os.makedirs(os.path.join(root, split, f"class_{k:03d}"), exist_ok=True)
        out += [(os.path.join(root, split, f"class_{k:03d}", f"{i:05d}.jpg"), k) for i in range(per_class)]

    def write(job):
        (path, k), i = job
        data = encode(render(templates, k, i, seed, split, bases), quality)
        with open(path, "wb") as f:
            f.write(data)

    jobs = [(item, n % per_class) for n, item in enumerate(out)]
    with ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 1) as pool:
        list(pool.map(write, jobs))
    return out


def write_tfrecords(root: str, split: str, items: list[tuple[str, int]], shards: int) -> list[str]:
    """The JPEG files of ``items`` (path, label) as ``shards`` TFRecord shards
    ``<root>/<split>-<s>-of-<shards>``, dealt round-robin: item ``i`` goes to
    shard ``i % shards``. With at most 4 shards of equal size the eval
    stream's interleave reads them back as ``items`` in order."""
    paths = []
    for s in range(shards):
        path = os.path.join(root, f"{split}-{s:05d}-of-{shards:05d}")
        with tfrecord.TFRecordWriter(path) as w:
            for p, label in items[s::shards]:
                with open(p, "rb") as f:
                    w.write(tfrecord.image_example(f.read(), label))
        paths.append(path)
    return paths


# the reference set a second JPEG library is held to: (name, width, height,
# subsampling of the encode, reduced-scale target or 0)
REFERENCE = (("noise_420", 96, 72, "4:2:0", 24), ("noise_444", 80, 64, "4:4:4", 0),
             ("smooth_420", 128, 96, "4:2:0", 40), ("portrait_420", 60, 84, "4:2:0", 0))


def reference_images(seed: int = 0) -> dict[str, np.ndarray]:
    """The reference set's source pixels: a class template plus noise
    (``noise_*``, ``portrait_*``) or the template alone (``smooth_*``)."""
    templates = class_templates(4, seed)
    out = {}
    for k, (name, w, h, _, _) in enumerate(REFERENCE):
        base = _upsample(templates[k], w, h)
        if not name.startswith("smooth"):
            base = base + np.random.default_rng([seed, 9, k]).normal(0.0, NOISE, base.shape)
        out[name] = np.clip(np.rint(base), 0, 255).astype(np.uint8)
    return out


def write_reference(directory: str, seed: int = 0) -> None:
    """Writes the reference JPEGs (``<name>.jpg``, encoded by PIL at quality
    90 with the subsampling named) and this host's decodes of them
    (``<name>.npy`` at full size; ``<name>_t<target>.npy`` at the reduced
    scale the eval transform picks for that shorter side)."""
    import io

    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for (name, _, _, sub, target), pixels in zip(REFERENCE, reference_images(seed).values()):
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, format="JPEG", quality=90, subsampling=sub)
        data = buf.getvalue()
        with open(os.path.join(directory, f"{name}.jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(directory, f"{name}.npy"), jpeg.decode(data))
        if target:
            np.save(os.path.join(directory, f"{name}_t{target}.npy"), jpeg.decode(data, target))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", required=True, help="directory for the reference JPEGs and decodes")
    args = ap.parse_args(argv)
    write_reference(args.reference)
    print(f"reference set ({jpeg.codec()}) -> {args.reference}")


if __name__ == "__main__":
    main()

"""Dataset prep: an image folder to ImageNet TFRecord shards, without
TensorFlow; the torch twin of ``scripts/imagefolder_to_tfrecords.py``.

It lists ``--src`` as ``<class>/<image>.jpg`` (classes sorted by name, as
the native loader lists them), and deals the images round-robin to
``--shards`` shards ``<dst>/<split>-<i:05d>-of-<shards:05d>``: image ``i``
goes to shard ``i % shards``. Each record is an ``Example`` with the JPEG's
bytes under ``image/encoded`` and ``label + 1`` under
``image/class/label`` (0 is the background class in the ImageNet TFRecord
convention; the readers subtract 1), framed with CRC-32C by
``data/tfrecord.py``. The class names go to ``<dst>/<split>-classes.txt``.

Usage:
  python -m yet_another_mobilenet_series_tpu_torch.data.to_tfrecords --src /data/imagenet/train \\
      --dst /data/tfrecords --split train --shards 1024
"""

from __future__ import annotations

import argparse
import os

from . import tfrecord
from .native_loader import list_image_folder


def convert(src: str, dst: str, split: str = "train", shards: int = 128) -> list[str]:
    """Writes the shards and the class list; returns the shards' paths."""
    paths, labels, classes = list_image_folder(src)
    print(f"{len(paths)} images, {len(classes)} classes -> {shards} shards")
    os.makedirs(dst, exist_ok=True)
    out = [os.path.join(dst, f"{split}-{i:05d}-of-{shards:05d}") for i in range(shards)]
    writers = [tfrecord.TFRecordWriter(p) for p in out]
    try:
        for i, (p, label) in enumerate(zip(paths, labels)):
            with open(p, "rb") as f:
                writers[i % shards].write(tfrecord.image_example(f.read(), label))
            if (i + 1) % 10000 == 0:
                print(f"  {i + 1}/{len(paths)}")
    finally:
        for w in writers:
            w.close()
    with open(os.path.join(dst, f"{split}-classes.txt"), "w") as f:
        f.write("\n".join(classes))
    print("done")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="ImageFolder root (class subdirs)")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--shards", type=int, default=128)
    args = ap.parse_args(argv)
    convert(args.src, args.dst, args.split, args.shards)


if __name__ == "__main__":
    main()

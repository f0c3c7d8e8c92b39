"""Input-pipeline throughput: the torch twin of ``scripts/bench_input.py``
over the port's ``data.make_train_source``.

It measures one pipeline alone, with no training step: the images/s of
``--batches`` train batches after 3 warm-up batches, on the host's clock.

- ``fake``: the learnable fake dataset, made on the device (the card unless
  ``--device cpu``); the clock stops after a synchronize;
- ``tfrecord``: ImageNet TFRecord shards ``<data-dir>/train-*`` through the
  port's reader (no TensorFlow), ``--threads`` decode threads;
- ``native``: an image folder ``<data-dir>/train/<class>/*.jpg`` through the
  port's copy of the native C++ loader, ``--threads`` decode threads.

JPEGs decode through the host library of ``ops/host_build.py``: libjpeg
where the host has it, else nvJPEG on the card (``codec`` in the line).
``--transfer-uint8`` (tfrecord, native) keeps uint8 pixels on the wire
(normalized on the device later); ``--deterministic`` (tfrecord only) sets
``data.deterministic_input``: the shards read back to back, where the
default mixes records through an interleave of ``--threads`` shards and a
record shuffle buffer (``data.shuffle_buffer``). Both streams are
record-exact, since the order and the crops are functions of (seed,
position) either way; the flag measures what the buffer's reads by offset
cost. Argument errors are the source's.

It prints one JSON line, stamped with the card (``card_provenance``); a
failure prints a line with ``value: null`` and ``error`` and exits 1. On
the card's machine nothing may be downloaded: write a seeded corpus with
``data/jpeg_corpus.py`` (``write_image_folder``, ``write_tfrecords``).

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.input_bench
           --pipeline fake|tfrecord|native [--data-dir D] [--batch 256]
           [--batches 20] [--image-size 224] [--threads N] [--deterministic]
           [--transfer-uint8] [--device cpu] [--out f.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..config import DataConfig
from ..utils.benchkit import card_provenance, sync
from ..utils.device import resolve_device

WARMUP = 3


def measure(name: str, it, batch: int, batches: int, device: torch.device) -> dict:
    for _ in range(WARMUP):
        next(it)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    sync(device)
    dt = time.perf_counter() - t0
    return {"pipeline": name, "images_per_sec": batch * batches / dt, "batch": batch, "batches": batches}


def data_config(args) -> DataConfig:
    if args.pipeline == "fake":
        return DataConfig(dataset="fake", image_size=args.image_size, fake_num_classes=1000,
                          fake_train_size=max(args.batch * 4, 1024))
    if args.pipeline == "tfrecord":
        return DataConfig(dataset="imagenet", data_dir=args.data_dir, image_size=args.image_size,
                          decode_threads=args.threads, deterministic_input=args.deterministic,
                          transfer_uint8=args.transfer_uint8)
    return DataConfig(dataset="folder", loader="native", data_dir=args.data_dir, image_size=args.image_size,
                      decode_threads=args.threads, transfer_uint8=args.transfer_uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pipeline", choices=["fake", "tfrecord", "native"], required=True)
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--deterministic", action="store_true",
                    help="tfrecord only: data.deterministic_input=True, the shards back to back with no interleave "
                         "or record buffer (both streams are record-exact: a function of (seed, position))")
    ap.add_argument("--transfer-uint8", action="store_true",
                    help="tfrecord/native: data.transfer_uint8=True (uint8 on the wire, normalized on the device)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if args.deterministic and args.pipeline != "tfrecord":
        ap.error("--deterministic only applies to --pipeline tfrecord")
    if args.transfer_uint8 and args.pipeline == "fake":
        ap.error("--transfer-uint8 needs a real-JPEG pipeline (tfrecord or native)")

    name = args.pipeline + ("+deterministic" if args.deterministic else "") + ("+uint8" if args.transfer_uint8 else "")
    out: dict = {"metric": f"input_{name}_images_per_sec", "value": None, "unit": "images/sec"}
    rc = 0
    it = None
    try:
        from .. import data as data_sources
        from ..data import jpeg

        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu", threads=args.threads,
                   image_size=args.image_size, codec=None if args.pipeline == "fake" else jpeg.codec())
        it = data_sources.make_train_source(data_config(args), args.batch, seed=0, device=dev)
        out.update(measure(name, it, args.batch, args.batches, dev))
        out["value"] = out["images_per_sec"]
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    out["provenance"] = card_provenance(args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

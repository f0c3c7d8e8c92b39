#!/usr/bin/env python3
"""Time the port's JPEG loader of two checkouts in turns on one card.

    python3 scripts/ab_loader.py BASE_ROOT NEW_ROOT

Each root is a directory that holds ``chip_smoke.py`` and
``yet_another_mobilenet_series_tpu_torch/``: for example the parent commit
unpacked with ``git archive`` into a gitignored ``build/`` directory, and
``.``. The script writes one seeded corpus (chip_smoke.py phase 13 (b):
1280 train JPEGs of 10 classes at 500x375 to 640x480), then runs, each in
a fresh process that builds its root's host library from source, base,
new, new, base:

- ``data/jpeg.py`` ``decode`` of 64 of the corpus's JPEGs on one thread,
  ms an image;
- chip_smoke.py phase 13 (c) (``phase_real_loader``): the loader's train
  images/s at one thread and one a core, uint8 and float32, the TFRecord
  stream, and the folder beside a busy card.

Then it times NEW_ROOT's host chroma filter alone
(``csrc/nvjpeg_compat/libjpeg_upsample.cc`` built with the host library's
flags): one 500x375 4:2:0 image, fancy upsampling, ms a call. It prints the
card line and one line per run, and writes every result to
``chiprun_out/ab_loader.json``. It needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODES = 64
CHILD = r"""
import glob, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from yet_another_mobilenet_series_tpu_torch.data import jpeg
root = sys.argv[1]
blobs = [open(p, "rb").read() for p in sorted(glob.glob(os.path.join(root, "train", "*", "*.jpg")))[:int(sys.argv[2])]]
jpeg.decode(blobs[0])
t0 = time.perf_counter()
for b in blobs:
    jpeg.decode(b)
decode_ms = (time.perf_counter() - t0) / len(blobs) * 1e3
out = cs.phase_real_loader(torch.device("cuda", 0), root)
out["decode_ms"] = decode_ms
print("RESULT " + json.dumps(out), flush=True)
"""


def run_one(root: str, corpus: str) -> dict:
    """A fresh process in ``root``: its decode and loader rates."""
    proc = subprocess.run([sys.executable, "-c", CHILD, corpus, str(DECODES)], cwd=root, capture_output=True,
                          text=True, timeout=900, check=False)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"{root} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return json.loads(line[len("RESULT "):])


def time_filter(root: str) -> float:
    """ms a call of ``root``'s yamt_ycc_to_rgb on a 500x375 4:2:0 image."""
    sys.path.insert(0, root)
    from yet_another_mobilenet_series_tpu_torch.ops import host_build

    src = os.path.join(root, "yet_another_mobilenet_series_tpu_torch", "csrc", "nvjpeg_compat", "libjpeg_upsample.cc")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libfilter.so")
        subprocess.run([host_build.find_cxx(), *host_build.CXX_FLAGS, "-o", so, src], check=True, timeout=300)
        lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    w, h = 500, 375
    cw, ch = (w + 1) // 2, (h + 1) // 2
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cb, cr = (rng.integers(0, 256, (ch, cw), dtype=np.uint8) for _ in range(2))
    rgb = np.zeros((h, w, 3), np.uint8)
    args = (y.ctypes.data_as(u8p), w, cb.ctypes.data_as(u8p), cr.ctypes.data_as(u8p), cw, w, h, cw, ch, 2, 2, 1,
            rgb.ctypes.data_as(u8p))
    for _ in range(20):
        lib.yamt_ycc_to_rgb(*args)
    n = 300
    t0 = time.perf_counter()
    for _ in range(n):
        if lib.yamt_ycc_to_rgb(*args) != 0:
            raise RuntimeError("yamt_ycc_to_rgb refused its arguments")
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    base, new = (os.path.abspath(p) for p in sys.argv[1:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="ab_loader_") as tmp:
        corpus = os.path.join(tmp, "jpegs")
        subprocess.run([sys.executable, "-c", "import os, sys; sys.path.insert(0, os.getcwd()); import chip_smoke; "
                        "chip_smoke.phase_real_write(sys.argv[1])", corpus], cwd=new, check=True, timeout=900)
        for tag, root in (("base", base), ("new", new), ("new", new), ("base", base)):
            r = run_one(root, corpus)
            rates = {f"{x['source']} {'uint8' if x['uint8'] else 'f32'} {x['threads']} threads": x["images_per_s"]
                     for x in r["rows"]}
            busy = r["busy_card"]["images_per_s"] if r["busy_card"] else None
            print(f"{tag} ({root}): decode {r['decode_ms']:.3f} ms an image (1 thread); loader images/s {rates}; "
                  f"folder uint8 beside a busy card {busy}", flush=True)
            results.append({"tag": tag, "root": root, **r})
    filter_ms = time_filter(new)
    print(f"new's host chroma filter alone: {filter_ms:.4f} ms a 500x375 4:2:0 image", flush=True)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab_loader.json"), "w") as f:
        json.dump({"card": card, "runs": results, "filter_ms": filter_ms}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port-only half of the host library (``csrc/jpeg_io.cc``): one JPEG
to RGB and back, and a batch of JPEGs held in memory run through the native
loader's own train or eval transform by ``data.decode_threads`` threads.

The batch transform is the copied loader's (``csrc/yamt_loader.cc``): the
random-resized crop, flip and colour jitter for train, the shorter side
resized to ``eval_resize`` and the centre ``image_size`` crop for eval. A
row's draws are seeded from (seed, its stream position) alone, so a batch is
a pure function of its records and positions. The GIL is released for the
whole call (ctypes), so the producer thread decodes while the trainer
dispatches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..config import DataConfig
from ..ops import host_build


def codec() -> str:
    """The JPEG library the host library was built against, with its version."""
    return host_build.load().yamt_codec().decode()


def encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """An (H, W, 3) uint8 image as a JPEG, 4:2:0, at ``quality``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes an (H, W, 3) uint8 image, got {rgb.shape}")
    lib = host_build.load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_uint64()
    if lib.yamt_jpeg_encode(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rgb.shape[1], rgb.shape[0],
                            int(quality), ctypes.byref(out), ctypes.byref(size)) != 0:
        raise RuntimeError(f"JPEG encode of a {rgb.shape} image failed ({codec()})")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.yamt_free(out)


def decode(data: bytes, target_min: int = 0) -> np.ndarray:
    """A JPEG as (H, W, 3) uint8, at full size or at the reduced scale the
    eval transform decodes at for a shorter side of ``target_min``. Raises
    ``ValueError`` when it does not decode."""
    lib = host_build.load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.yamt_jpeg_decode(data, len(data), int(target_min), ctypes.byref(out), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        raise ValueError(f"not a decodable JPEG ({len(data)} bytes, {codec()})")
    try:
        return np.frombuffer(ctypes.string_at(out, w.value * h.value * 3), np.uint8).reshape(h.value, w.value, 3)
    finally:
        lib.yamt_free(out)


def decode_batch(payloads: Sequence[bytes], labels: Sequence[int], positions: Sequence[int], cfg: DataConfig,
                 batch: int, *, train: bool, seed: int, uint8: bool | None = None) -> tuple[dict, np.ndarray]:
    """({'image', 'label'}, failed) for one batch of ``batch`` rows: row i <
    len(payloads) is ``payloads[i]`` through the train or eval transform, the
    rest are padding (label -1, filled as the native loader fills its padded
    eval tail). ``failed[i]`` marks a JPEG that did not decode: its row is
    filled as the loader fills a failed sample, labelled -1 in eval and
    ``labels[i]`` in train. Images are uint8 pixels when ``uint8`` (default
    ``cfg.transfer_uint8``), else normalized float32."""
    n = len(payloads)
    if n > batch or len(labels) != n or len(positions) != n:
        raise ValueError(f"{n} payloads, {len(labels)} labels, {len(positions)} positions for a batch of {batch}")
    uint8 = cfg.transfer_uint8 if uint8 is None else uint8
    lib = host_build.load()
    size = cfg.image_size
    images = np.empty((batch, size, size, 3), np.uint8 if uint8 else np.float32)
    out_labels = np.empty((batch,), np.int32)
    failed = np.empty((batch,), np.int32)
    ptrs = (ctypes.c_void_p * max(n, 1))(*[ctypes.cast(ctypes.c_char_p(p), ctypes.c_void_p) for p in payloads])
    sizes = (ctypes.c_uint64 * max(n, 1))(*[len(p) for p in payloads])
    lab = np.ascontiguousarray(labels, dtype=np.int32) if n else np.zeros(1, np.int32)
    pos = np.ascontiguousarray(positions, dtype=np.int64) if n else np.zeros(1, np.int64)
    mean = (ctypes.c_float * 3)(*cfg.mean)
    std = (ctypes.c_float * 3)(*cfg.std)
    f32p, u8p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.yamt_decode_batch(
        ptrs, sizes, lab.ctypes.data_as(i32p), pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, batch, size,
        cfg.eval_resize, int(train), seed & (2**64 - 1), mean, std, cfg.rrc_area_min, cfg.rrc_area_max,
        cfg.rrc_ratio_min, cfg.rrc_ratio_max, cfg.color_jitter, int(uint8), max(1, cfg.decode_threads),
        None if uint8 else images.ctypes.data_as(f32p), images.ctypes.data_as(u8p) if uint8 else None,
        out_labels.ctypes.data_as(i32p), failed.ctypes.data_as(i32p))
    return {"image": images, "label": out_labels}, failed.astype(bool)

"""The wire helpers of ``yet_another_mobilenet_series_tpu/serve/quant.py``
that the batchers need, copied: the wire dtype of a mode name and the
client-side coercion. The uint8 wire and int8 weights themselves are not
ported yet (ROADMAP queue 1b, S4); the engine refuses both."""

from __future__ import annotations

import numpy as np

WIRE_DTYPES = ("float32", "uint8")


def wire_np_dtype(wire: str) -> type:
    """numpy dtype of a wire mode name (staging buffers, client coercion)."""
    if wire not in WIRE_DTYPES:
        raise ValueError(f"serve.quant.wire must be one of {WIRE_DTYPES}, got {wire!r}")
    return {"float32": np.float32, "uint8": np.uint8}[wire]


def coerce_wire(image: np.ndarray, np_dtype) -> np.ndarray:
    """Coerce a client array to the wire dtype. float32 wire: the historical
    ``np.asarray(image, np.float32)``. uint8 wire: integer inputs convert
    exactly; float inputs are rounded-and-clipped to the pixel range —
    ``astype(uint8)`` alone would TRUNCATE and wrap negatives."""
    img = np.asarray(image)
    if img.dtype == np_dtype:
        return img
    if np_dtype == np.uint8 and np.issubdtype(img.dtype, np.floating):
        return np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img.astype(np_dtype)

# Copy of yet_another_mobilenet_series_tpu/serve/quant.py: the numpy helpers are copied as they are (the port
# never imports the JAX package); denormalize_device and calibrate_and_quantize are torch twins. Keep the two
# in step by hand.
"""Quantized serving: the uint8 wire and post-training int8 weights.

**The uint8 wire** (``serve.quant.wire="uint8"``). Clients send RAW pixels
(0..255); they stage, pool and cross H2D as ``uint8``, a quarter of the f32
wire's bytes, and every captured forward of the engine starts with the
denorm prelude :func:`denormalize_device`:

    scale = 1 / (255 * std)          shift = -mean / std
    normalized = u8.float() * scale [+ shift]

:func:`normalize_reference` is the host-side definition of what a u8 wire
value stands for, computed by the same expression in the same order. With a
zero mean the prelude is one per-channel multiply, so the u8 wire is
**bitwise** the f32 wire fed :func:`normalize_reference` pixels; with a
nonzero mean the shift is one more add, and parity is the measured-delta
gate ``serve.quant.wire_atol``.

**int8 weights** (``serve.quant.weights="int8"``). :func:`quantize_folded`
quantizes every folded conv/dense pair of a JAX-layout folded tree (the
layout ``weights.npz`` holds) with per-OUTPUT-channel symmetric scales
(``scale_c = max|w[..., c]| / 127``); the bundle stores ``w_q`` (int8) +
``w_scale`` (f32) + the f32 bias, and the port's ``apply_folded``
dequantizes ``w_q.float() * w_scale`` inside the forward, so the device
tree stays int8. :func:`calibrate_and_quantize` gates the export: it runs a
calibration batch through the port's folded forward with the f32 and the
int8 tree and refuses (:class:`QuantParityError`) below ``int8_top1_min``
top-1 agreement. Squeeze-excite weights stay f32.

Module-level imports are numpy-only: the batchers import this for
:func:`coerce_wire`; torch is imported where device code runs.
"""

from __future__ import annotations

import numpy as np

WIRE_DTYPES = ("float32", "uint8")
WEIGHT_DTYPES = ("float32", "int8")

# paths (relative key names inside a folded tree) that stay f32 under int8
# weight quantization: SE gates are tiny and range-sensitive
_QUANT_SKIP_KEYS = ("se",)


class QuantParityError(RuntimeError):
    """The quantized artifact failed its parity gate (uint8-wire logit delta
    above ``wire_atol``, or int8 top-1 agreement below ``int8_top1_min``) —
    export refuses to write an artifact that serves wrong answers."""


def wire_np_dtype(wire: str) -> type:
    """numpy dtype of a wire mode name (staging buffers, client coercion)."""
    if wire not in WIRE_DTYPES:
        raise ValueError(f"serve.quant.wire must be one of {WIRE_DTYPES}, got {wire!r}")
    return {"float32": np.float32, "uint8": np.uint8}[wire]


def denorm_constants(mean, std) -> tuple[np.ndarray, np.ndarray]:
    """(scale, shift) f32 per-channel constants of the on-device
    denormalization ``u8 * scale + shift`` == ``(u8/255 - mean) / std``.
    ``mean=None``/``std=None`` mean the identity pipeline (mean 0, std 1):
    the wire then stands for plain ``u8 * (1/255)`` pixels."""
    mean = np.zeros(3, np.float32) if mean is None else np.asarray(mean, np.float32)
    std = np.ones(3, np.float32) if std is None else np.asarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean/std must be 3-channel, got {mean.shape}/{std.shape}")
    if np.any(std <= 0):
        raise ValueError(f"std must be positive, got {std}")
    scale = (np.float32(1.0) / (np.float32(255.0) * std)).astype(np.float32)
    shift = (-mean / std).astype(np.float32)
    return scale, shift


def shift_free(shift: np.ndarray) -> bool:
    """True when the denorm has no additive term — the regime where the u8
    wire is BITWISE-identical to the host-normalized f32 wire (the prelude
    is one multiply)."""
    return bool(np.all(shift == 0.0))


def normalize_reference(images: np.ndarray, mean=None, std=None) -> np.ndarray:
    """Host-side f32 pixels a u8 wire batch stands for — THE reference the
    parity gates compare against. Computes exactly the expression
    :func:`denormalize_device` runs (same constants, same op order) so the
    shift-free case is bitwise."""
    scale, shift = denorm_constants(mean, std)
    x = images.astype(np.float32) * scale
    if not shift_free(shift):
        x = x + shift
    return x


def denormalize_device(x, scale, shift):
    """The denorm prelude of every forward the engine runs on the u8 wire:
    cast to f32 + per-channel multiply, plus the shift only when it is
    nonzero, in :func:`normalize_reference`'s order. ``scale`` and
    ``shift`` are (3,) float32 tensors on x's device (``shift`` None when
    the wire is shift-free)."""
    h = x.float() * scale
    if shift is not None:
        h = h + shift
    return h


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


# ---------------------------------------------------------------------------
# int8 weights: per-output-channel symmetric post-training quantization
# ---------------------------------------------------------------------------


def quantize_array_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(w_q int8, scale f32) with per-OUTPUT-channel symmetric scales.
    Output channels are the LAST axis of every folded weight in the JAX
    layouts — HWIO conv kernels (dense, grouped, and depthwise alike) and
    (in, out) dense matrices — so one reduction axis rule covers all of
    them: ``scale_c = max|w[..., c]| / 127`` (1.0 for an all-zero channel,
    so dequantization never divides by zero)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return w_q, scale


def dequantize_array(w_q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`quantize_array_int8` (tests and the
    calibration forward; the serving engine dequantizes in its forward)."""
    return w_q.astype(np.float32) * np.asarray(scale, np.float32)


def _is_weight_pair(v) -> bool:
    """A folded conv/dense leaf dict: {'w': (..., C) float, 'b': (C,)}."""
    return (
        isinstance(v, dict)
        and set(v) == {"w", "b"}
        and getattr(v["w"], "ndim", 0) in (2, 4)
    )


def quantize_folded(folded: dict, _path: str = "") -> tuple[dict, int]:
    """Folded f32 param tree (JAX layouts, numpy) -> int8-weight tree: every
    {'w','b'} conv/dense pair becomes {'w_q' int8, 'w_scale' f32, 'b' f32};
    SE subtrees (and anything that is not a weight pair) pass through
    untouched. Returns the new tree and the number of quantized tensors.
    Deterministic: the scales are a pure function of the weights."""
    out: dict = {}
    n = 0
    for k, v in folded.items():
        path = f"{_path}/{k}" if _path else k
        if k in _QUANT_SKIP_KEYS:
            out[k] = v
        elif _is_weight_pair(v):
            w_q, scale = quantize_array_int8(v["w"])
            out[k] = {"w_q": w_q, "w_scale": scale, "b": np.asarray(v["b"], np.float32)}
            n += 1
        elif isinstance(v, dict):
            out[k], sub_n = quantize_folded(v, path)
            n += sub_n
        else:
            out[k] = v
    return out, n


def tree_nbytes(tree: dict) -> int:
    """Total array bytes of a (possibly nested) param tree — the resident-
    byte accounting the int8 export's provenance records."""
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += tree_nbytes(v)
        else:
            total += int(getattr(np.asarray(v), "nbytes", 0))
    return total


def calibrate_and_quantize(
    net,
    folded: dict,
    calib_images: np.ndarray,
    *,
    top1_min: float = 0.98,
    calib_meta: dict | None = None,
    device: str | torch.device = "cuda",
) -> tuple[dict, dict]:
    """The gated export-time int8 pass over a JAX-layout folded tree (numpy,
    what ``weights.npz`` holds): quantize the folded weights, run the
    calibration batch through the port's folded forward on ``device`` (the
    card unless the caller asks for the CPU) with both trees, and refuse (:class:`QuantParityError`) unless top-1
    agreement with the f32 tree meets ``top1_min``. Returns
    ``(quantized_tree, report)``; the report is the provenance block the
    bundle's ``meta.json["quant"]`` carries, with the JAX package's keys.
    Deterministic: same weights + same batch -> same scales, same ranges,
    same verdict."""
    import torch

    from ..models import convert
    from ..utils.device import resolve_device
    from .export import apply_folded, prepare_folded

    dev = resolve_device(device)
    calib_images = np.asarray(calib_images, np.float32)
    if calib_images.ndim != 4 or calib_images.shape[0] < 1:
        raise ValueError(f"calibration batch must be (N, S, S, 3), got {calib_images.shape}")
    quantized, n_tensors = quantize_folded(folded)
    if n_tensors == 0:
        raise ValueError("int8 export found no quantizable weight pairs in the folded tree")

    def forward(tree, collect=None):
        params = prepare_folded(net, convert.from_jax(convert.flatten_tree(tree)), device=dev)
        with torch.inference_mode():
            x = torch.from_numpy(calib_images).to(dev)
            return apply_folded(net, params, x, collect=collect).cpu().numpy()

    ranges: dict[str, tuple[float, float]] = {}
    ref = forward(folded, collect=ranges)
    got = forward(quantized)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(ref, -1)))
    delta = float(np.max(np.abs(got - ref)))
    report = {
        "weights": "int8",
        "scheme": "per_output_channel_symmetric",
        "quantized_tensors": n_tensors,
        "bytes_f32": tree_nbytes(folded),
        "bytes_int8": tree_nbytes(quantized),
        "top1_agreement": agree,
        "top1_min": float(top1_min),
        "max_abs_logit_delta": delta,
        "calib": {
            "images": int(calib_images.shape[0]),
            "image_size": int(calib_images.shape[1]),
            "activation_ranges": {k: [float(lo), float(hi)] for k, (lo, hi) in ranges.items()},
            "device": str(dev),
            **(calib_meta or {}),
        },
    }
    if agree < top1_min:
        raise QuantParityError(
            f"int8 export failed its parity gate: top-1 agreement {agree:.4f} < "
            f"{top1_min} on the {calib_images.shape[0]}-image calibration batch "
            f"(max |logit delta| {delta:.4g}); the f32 bundle stays the servable artifact"
        )
    return quantized, report

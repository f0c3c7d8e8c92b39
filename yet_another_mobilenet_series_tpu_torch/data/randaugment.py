"""RandAugment (arXiv:1909.13719) in torch, on the device, batch by batch:
the torch twin of ``yet_another_mobilenet_series_tpu/data/randaugment.py``.

The op set, magnitude mappings (``MAX_LEVEL`` 10), enhance-factor formula,
gray fill 128, ``TRANSLATE_CONST`` 100 and ``CUTOUT_CONST`` 40 are the JAX
package's (the public TF implementation's); each op computes what its TF op
computes, in the same float32 arithmetic where it has one
(``tests/test_torch_port_randaugment.py`` holds every op to TensorFlow at
magnitudes 0, 5 and 10). Each of ``layers`` layers draws, per image, one of
the 16 ops and fires it with probability ~U(0.2, 0.8), as the official
version does.

**Where it runs.** On the device, after the uint8 batch has been moved
there, grouped by the op each image drew: the draws (op, sign, firing,
cutout centre) are made on the host from the batch's stream positions
(``pos``, which stays a host array through ``prefetch_to_device``), each
group's rows are gathered, transformed by one batched call of their op and
scattered back. The host never waits on the device: the groups are known
before the batch is touched, and one pinned copy carries their indices and
parameters. Each image goes through its own op only, once a layer (plus
the gather and scatter of its row), where running every op on every image
and selecting would cost all 16; on the host it costs a few numpy draws an
image. Its time on the card is not measured yet.

**Draws.** Keyed by position from the port's own generator: a draw of image
position ``p`` at offset ``o`` is an integer hash of (seed, p, o)
(``pipeline.hash32``), so a batch's augmentation is a pure function of
(seed, its positions), whether reached by streaming or by resume. They are
not TensorFlow's stateless draws (which need TensorFlow), so the port's
augmentations equal the JAX package's in distribution, not in draws.

The input is the uint8 crop after the flip and the colour jitter (the C++
transform rounds half away from zero where the JAX package's ``tf.round``
rounds half to even); normalization follows, on the device, as in the JAX
package's order (``pipeline.py`` ``map_fn``).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from ..config import DataConfig

MAX_LEVEL = 10.0
FILL = 128
TRANSLATE_CONST = 100.0
CUTOUT_CONST = 40
LAYER_STRIDE = 8
BASE_OFFSET = 16
NUM_OPS = 16
OPS = ("autocontrast", "equalize", "invert", "rotate", "posterize", "solarize", "color", "contrast",
       "brightness", "sharpness", "shear_x", "shear_y", "translate_x", "translate_y", "cutout", "solarize_add")
_M32 = 0xFFFFFFFF
_GRAY = (0.2989, 0.5870, 0.1140)


# ---------------------------------------------------------------------------
# the ops: uint8 (N, H, W, 3) in and out; per-image parameters are (N,)
# ---------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """tf.cast(float -> uint8) of values already in [0, 255]: truncation."""
    return x.to(torch.uint8)


def blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """PIL.Image.blend: a + factor * (b - a), clipped, truncated to uint8."""
    af, bf = _f32(a), _f32(b)
    return _to_u8(torch.clamp(af + factor * (bf - af), 0.0, 255.0))


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    lo = _f32(x.amin(dim=(1, 2), keepdim=True))
    hi = _f32(x.amax(dim=(1, 2), keepdim=True))
    scale = 255.0 / torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    scaled = _to_u8(torch.clamp((_f32(x) - lo) * scale, 0.0, 255.0))
    return torch.where(hi > lo, scaled, x)


def equalize(x: torch.Tensor) -> torch.Tensor:
    n, h, w, _ = x.shape
    planes = x.permute(0, 3, 1, 2).reshape(n * 3, h * w).long()
    histo = torch.zeros((n * 3, 256), dtype=torch.int64, device=x.device)
    histo.scatter_add_(1, planes, torch.ones_like(planes))
    # the last nonzero bin: the count of the largest value present
    last_bin = 255 - torch.flip(histo > 0, dims=[1]).to(torch.int64).argmax(dim=1)
    last = histo.gather(1, last_bin[:, None])[:, 0]
    step = (h * w - last) // 255
    safe = torch.where(step == 0, torch.ones_like(step), step)
    lut = (torch.cumsum(histo, dim=1) + (safe // 2)[:, None]) // safe[:, None]
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=1).clamp(0, 255)
    out = lut.gather(1, planes)
    out = torch.where((step == 0)[:, None], planes, out)
    return out.to(torch.uint8).view(n, 3, h, w).permute(0, 2, 3, 1).contiguous()


def invert(x: torch.Tensor) -> torch.Tensor:
    return 255 - x


def posterize(x: torch.Tensor, bits: int) -> torch.Tensor:
    # bits 0 (below magnitude 2.5) keeps one bit, as in the JAX package
    shift = 8 - max(1, bits)
    return (x >> shift) << shift


def solarize(x: torch.Tensor, threshold: int) -> torch.Tensor:
    return torch.where(x.to(torch.int32) < threshold, x, 255 - x)


def solarize_add(x: torch.Tensor, addition: int, threshold: int = 128) -> torch.Tensor:
    added = torch.clamp(x.to(torch.int32) + addition, 0, 255).to(torch.uint8)
    return torch.where(x.to(torch.int32) < threshold, added, x)


def gray(x: torch.Tensor) -> torch.Tensor:
    """tf.image.rgb_to_grayscale of uint8: the float image (x * 1/255), the
    luma weights, back to uint8 (* 255.5, truncated); (N, H, W, 1)."""
    f = _f32(x) * float(np.float32(1.0 / 255.0))
    g = (f[..., 0:1] * _GRAY[0] + f[..., 1:2] * _GRAY[1]) + f[..., 2:3] * _GRAY[2]
    return _to_u8(torch.clamp(g * 255.5, 0.0, 255.0))


def color(x: torch.Tensor, factor: float) -> torch.Tensor:
    return blend(gray(x).expand_as(x), x, factor)


def contrast(x: torch.Tensor, factor: float) -> torch.Tensor:
    g = gray(x)
    # the mean of the 3-channel gray image, exactly, then rounded half to even
    mean = g.to(torch.int64).sum(dim=(1, 2, 3)).to(torch.float64) / g[0].numel()
    degenerate = torch.round(mean).to(torch.uint8)[:, None, None, None].expand_as(x)
    return blend(degenerate, x, factor)


def brightness(x: torch.Tensor, factor: float) -> torch.Tensor:
    return blend(torch.zeros_like(x), x, factor)


def sharpness(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Blend with the PIL SMOOTH filter ([[1,1,1],[1,5,1],[1,1,1]] / 13) of
    the interior (the border keeps the original). The taps are summed in row
    order with a fused multiply-add each, as TensorFlow's depthwise
    convolution sums them: in float64, where a pixel times a float32 weight
    plus a float32 sum is exact, rounded once to float32 per tap."""
    f = x.to(torch.float64)
    n, h, w, _ = x.shape
    weights = [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]
    acc = torch.zeros((n, h - 2, w - 2, 3), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            weight = float(np.float32(weights[ky][kx]) / np.float32(13.0))
            acc = (acc.to(torch.float64) + f[:, ky:h - 2 + ky, kx:w - 2 + kx] * weight).to(torch.float32)
    smoothed = _to_u8(torch.clamp(acc, 0.0, 255.0))
    degenerate = x.clone()
    degenerate[:, 1:h - 1, 1:w - 1] = smoothed
    return blend(degenerate, x, factor)


def transform(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """ImageProjectiveTransformV3, NEAREST, constant fill 128: output pixel
    (x, y) reads input (round(in_x), round(in_y)) with in = (t0 x + t1 y +
    t2, t3 x + t4 y + t5) / (t6 x + t7 y + 1), rounding half away from zero.
    ``params`` (N, 8) float32."""
    n, h, w, c = x.shape
    t = params.to(torch.float32)[:, :, None, None]
    xs = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :]
    ys = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None]
    proj = (t[:, 6] * xs + t[:, 7] * ys) + 1.0
    in_x = ((t[:, 0] * xs + t[:, 1] * ys) + t[:, 2]) / proj
    in_y = ((t[:, 3] * xs + t[:, 4] * ys) + t[:, 5]) / proj

    def rnd(v):
        return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)

    ix, iy = rnd(in_x), rnd(in_y)
    valid = (proj != 0) & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = ((torch.arange(n, device=x.device)[:, None, None] * h + iy.clamp(0, h - 1).long()) * w
            + ix.clamp(0, w - 1).long())
    out = x.reshape(n * h * w, c).index_select(0, flat.reshape(-1)).view(n, h, w, c)
    return torch.where(valid[..., None], out, torch.full_like(out, FILL))


def rotate_params(degrees: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, 8) float32 transforms of a rotation by ``degrees`` about the
    centre, in the JAX package's float32 arithmetic."""
    deg = np.asarray(degrees, np.float32)
    radians = deg * np.float32(math.pi) / np.float32(180.0)
    c, s = np.cos(radians).astype(np.float32), np.sin(radians).astype(np.float32)
    cx, cy = np.float32((w - 1.0) / 2.0), np.float32((h - 1.0) / 2.0)
    zero = np.zeros_like(c)
    return np.stack([c, -s, (cx - c * cx) + s * cy, s, c, (cy - s * cx) - c * cy, zero, zero], axis=1)


def shear_params(level: np.ndarray, axis: str) -> np.ndarray:
    lv = np.asarray(level, np.float32)
    one, zero = np.ones_like(lv), np.zeros_like(lv)
    if axis == "x":
        return np.stack([one, lv, zero, zero, one, zero, zero, zero], axis=1)
    return np.stack([one, zero, zero, lv, one, zero, zero, zero], axis=1)


def translate_params(pixels: np.ndarray, axis: str) -> np.ndarray:
    px = np.asarray(pixels, np.float32)
    one, zero = np.ones_like(px), np.zeros_like(px)
    if axis == "x":
        return np.stack([one, zero, -px, zero, one, zero, zero, zero], axis=1)
    return np.stack([one, zero, zero, zero, one, -px, zero, zero], axis=1)


def cutout(x: torch.Tensor, pad_size: int, cy: torch.Tensor, cx: torch.Tensor) -> torch.Tensor:
    """A gray (2 pad_size)^2 patch about (cy, cx), clipped to the image."""
    n, h, w, _ = x.shape
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    cy, cx = cy.long()[:, None, None], cx.long()[:, None, None]
    inside = (ys >= cy - pad_size) & (ys < cy + pad_size) & (xs >= cx - pad_size) & (xs < cx + pad_size)
    return torch.where(inside[..., None], torch.full_like(x, FILL), x)


def enhance_factor(magnitude: float) -> float:
    return (magnitude / MAX_LEVEL) * 1.8 + 0.1


# ---------------------------------------------------------------------------
# draws and the batch plan (host)
# ---------------------------------------------------------------------------


def _hash32(x: np.ndarray) -> np.ndarray:
    """``pipeline.hash32`` on numpy uint64 words (exact integer arithmetic)."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x21F0AAAD)) & np.uint64(_M32)
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x735A2D97)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(15))


def uniform(seed: int, positions: np.ndarray, offset: int) -> np.ndarray:
    """Draws in [0, 1) (24 bits), one per position: a hash of (seed,
    position, offset)."""
    pos = np.asarray(positions, np.int64).astype(np.uint64)
    key = _hash32(np.uint64(seed & _M32) ^ np.uint64(0x5BD1E995))
    h = _hash32(key ^ (pos & np.uint64(_M32)))
    h = _hash32(h ^ (pos >> np.uint64(32)))
    h = _hash32(h ^ np.uint64((offset * 0x9E3779B1) & _M32))
    return (h >> np.uint64(8)).astype(np.float64) / float(1 << 24)


def draws(seed: int, positions: np.ndarray, layer: int, h: int, w: int) -> dict:
    """One layer's per-image draws: op index, sign, whether it fires, cutout
    centre."""
    base = BASE_OFFSET + LAYER_STRIDE * layer
    pos = np.asarray(positions, np.int64)
    return {
        "op": np.minimum((uniform(seed, pos, base) * NUM_OPS).astype(np.int64), NUM_OPS - 1),
        "sign": np.where(uniform(seed, pos, base + 1) < 0.5, -1.0, 1.0).astype(np.float32),
        "fire": uniform(seed, pos, base + 3) < 0.2 + 0.6 * uniform(seed, pos, base + 2),
        "cy": np.minimum((uniform(seed, pos, base + 4) * h).astype(np.int64), h - 1),
        "cx": np.minimum((uniform(seed, pos, base + 5) * w).astype(np.int64), w - 1),
    }


def op_params(op: int, d: dict, magnitude: float, h: int, w: int) -> np.ndarray:
    """(N, 8) float32 per-image parameters of op ``op`` for the draws ``d``
    (rows of the images that drew it): a transform, or the cutout centre."""
    m = np.float32(magnitude / MAX_LEVEL)
    sign = d["sign"]
    name = OPS[op]
    if name == "rotate":
        return rotate_params(sign * m * np.float32(30.0), h, w)
    if name in ("shear_x", "shear_y"):
        return shear_params(sign * m * np.float32(0.3), name[-1])
    if name in ("translate_x", "translate_y"):
        return translate_params(sign * m * np.float32(TRANSLATE_CONST), name[-1])
    out = np.zeros((sign.shape[0], 8), np.float32)
    if name == "cutout":
        out[:, 0], out[:, 1] = d["cy"], d["cx"]
    return out


def apply_op(x: torch.Tensor, op: int, magnitude: float, params: torch.Tensor) -> torch.Tensor:
    """Op ``op`` at ``magnitude`` on every image of ``x``, with the per-image
    ``params`` of :func:`op_params`."""
    m = magnitude / MAX_LEVEL
    name = OPS[op]
    if name == "autocontrast":
        return autocontrast(x)
    if name == "equalize":
        return equalize(x)
    if name == "invert":
        return invert(x)
    if name == "posterize":
        return posterize(x, int(m * 4))
    if name == "solarize":
        return solarize(x, int(m * 256))
    if name == "solarize_add":
        return solarize_add(x, int(m * 110))
    if name in ("color", "contrast", "brightness", "sharpness"):
        return {"color": color, "contrast": contrast, "brightness": brightness,
                "sharpness": sharpness}[name](x, enhance_factor(magnitude))
    if name == "cutout":
        return cutout(x, CUTOUT_CONST, params[:, 0], params[:, 1])
    return transform(x, params)


def plan(seed: int, positions: np.ndarray, layers: int, magnitude: float, h: int, w: int):
    """The groups of one batch: [(layer, op, start, stop)] over one index
    array (the rows, grouped) and one (M, 8) parameter array."""
    groups, rows, params = [], [], []
    start = 0
    for layer in range(layers):
        d = draws(seed, positions, layer, h, w)
        for op in range(NUM_OPS):
            idx = np.flatnonzero(d["fire"] & (d["op"] == op))
            if idx.size == 0:
                continue
            groups.append((layer, op, start, start + idx.size))
            rows.append(idx)
            params.append(op_params(op, {k: v[idx] for k, v in d.items()}, magnitude, h, w))
            start += idx.size
    if not groups:
        return [], np.zeros((0,), np.int64), np.zeros((0, 8), np.float32)
    return groups, np.concatenate(rows).astype(np.int64), np.concatenate(params).astype(np.float32)


def rand_augment(images: torch.Tensor, positions: np.ndarray, seed: int, layers: int,
                 magnitude: float) -> torch.Tensor:
    """RandAugment of a uint8 (N, H, W, 3) batch whose rows sit at stream
    ``positions``: each layer's groups in turn, gathered, transformed and
    scattered back. Waits on nothing."""
    n, h, w, _ = images.shape
    groups, rows, params = plan(seed, positions, layers, magnitude, h, w)
    if not groups:
        return images
    dev = images.device
    if dev.type == "cuda":
        rows_d = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        params_d = torch.from_numpy(params).pin_memory().to(dev, non_blocking=True)
    else:
        rows_d, params_d = torch.from_numpy(rows), torch.from_numpy(params)
    x = images.clone()
    for _, op, a, b in groups:
        idx = rows_d[a:b]
        x.index_copy_(0, idx, apply_op(x.index_select(0, idx), op, magnitude, params_d[a:b]))
    return x


def device_stage(batches, cfg: DataConfig, seed: int) -> Iterator[dict]:
    """RandAugment of every batch of a device stream whose uint8 images came
    with their stream positions (``pos``, a host array), then, unless
    ``data.transfer_uint8`` leaves it to the step, the host path's
    normalize expression. Yields {'image', 'label'}."""
    mean = std = None
    for batch in batches:
        image = rand_augment(batch["image"], np.asarray(batch["pos"]), seed, cfg.randaugment_layers,
                             float(cfg.randaugment_magnitude))
        if not cfg.transfer_uint8:
            if mean is None:
                mean = torch.tensor(cfg.mean, dtype=torch.float32).to(image.device)
                std = torch.tensor(cfg.std, dtype=torch.float32).to(image.device)
            image = (image.to(torch.float32) / 255.0 - mean) / std
        yield {"image": image, "label": batch["label"]}

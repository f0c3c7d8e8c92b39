"""The cell's inputs, made from ``--seed`` on the device in a few large calls: the weights, the BN
running statistics, the images and the labels. Both the program and the reference get these
same tensors.

Weights (float32, as both sides hold them): conv weights N(0, 2 / fan_in); the SE FCs and the
classifier N(0, 1 / fan_in); MobileNetV3's 1280-wide feature FC N(0, 2 / fan_in); BN gamma
N(1, 0.2^2), beta and every bias N(0, 0.1^2). Running statistics: each BN's variance 2 U(0.5, 1.5)
(a conv under that init doubles its input's second moment) and its mean N(0, 0.1^2) times the
square root of that variance, so the eval forward's fold is exercised and activations stay of
order one through the depth. The EMA of the weights starts apart from them, as a run's shadow
lags its weights: each leaf plus N(0, (s / 10)^2) noise, s the leaf's own scale above. Images are
N(0, 1) normalized pixels, labels uniform over the classes.
"""

from __future__ import annotations

import hashlib
import math

import torch

from .reference import nets


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any whole number)."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{purpose}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def _scale_offset(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "gamma":
        return 0.2, 1.0
    if leaf in ("beta", "b"):
        return 0.1, 0.0
    if len(shape) == 4:  # conv (out, in/groups, k, k)
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3])), 0.0
    gain = 2.0 if name.startswith("feature/") else 1.0
    return math.sqrt(gain / shape[0]), 0.0


def _split(flat: torch.Tensor, names, shapes) -> dict[str, torch.Tensor]:
    sizes = [math.prod(s) for s in shapes]
    return {n: t.reshape(s).clone() for n, t, s in zip(names, torch.split(flat, sizes), shapes)}


def weights(arch: nets.Arch, seed: int, device) -> tuple[dict, dict]:
    """(params, running statistics) as flat dicts of float32 tensors on ``device``."""
    shapes = nets.param_shapes(arch)
    names = list(shapes)
    sizes = torch.tensor([math.prod(shapes[n]) for n in names], device=device)
    so = [_scale_offset(n, shapes[n]) for n in names]
    gen = generator(seed, "weights", device)
    draw = torch.randn(int(sizes.sum()), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor([a for a, _ in so], device=device), sizes)
    offset = torch.repeat_interleave(torch.tensor([b for _, b in so], device=device), sizes)
    params = _split(torch.addcmul(offset, draw, scale), names, [shapes[n] for n in names])

    bns = nets.bn_names(arch)
    widths = [shapes[f"{b}/gamma"][0] for b in bns]
    total = sum(widths)
    var = 2.0 * (0.5 + torch.rand(total, generator=gen, device=device))
    mean = 0.1 * torch.randn(total, generator=gen, device=device) * var.sqrt()
    state = {}
    for b, v, m in zip(bns, torch.split(var, widths), torch.split(mean, widths)):
        state[f"{b}/mean"], state[f"{b}/var"] = m.clone(), v.clone()
    return params, state


def ema_weights(params: dict, seed: int, device) -> dict:
    """The weights' EMA shadow at the run's start step: ``params`` plus seeded noise a tenth of
    each leaf's drawn scale, so its change over a step, ``(1 - a) (w - shadow)``, lies far above
    float32's rounding."""
    names = list(params)
    sizes = torch.tensor([params[n].numel() for n in names], device=device)
    scale = torch.tensor([_scale_offset(n, tuple(params[n].shape))[0] / 10.0 for n in names], device=device)
    draw = torch.randn(int(sizes.sum()), generator=generator(seed, "ema", device), device=device)
    noise = _split(draw * torch.repeat_interleave(scale, sizes), names, [tuple(params[n].shape) for n in names])
    return {n: params[n] + noise[n].to(params[n].device) for n in names}


def images(seed: int, purpose: str, rows: int, size: int, device, dtype=torch.float32) -> torch.Tensor:
    """(rows, size, size, 3) N(0, 1) pixels in ``dtype``."""
    gen = generator(seed, purpose, device)
    return torch.randn((rows, size, size, 3), generator=gen, device=device).to(dtype)


def labels(seed: int, purpose: str, rows: int, classes: int, device) -> torch.Tensor:
    return torch.randint(0, classes, (rows,), generator=generator(seed, purpose, device), device=device)


def nest(flat: dict) -> dict:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}}: the tree form the program's state takes."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out

"""Compile-check entry point of the port: the torch twin of ``entry()`` in
the repository's ``__graft_entry__.py``.

:func:`entry` returns ``(fn, example_args)`` for the bf16 eval forward of
MobileNetV3-Large 1.0, ``Network.apply(train=False,
compute_dtype=torch.bfloat16)``, with the weights and BN state of
``net.init`` from seed 0 and a zero batch of
``batch`` images at ``image_size``, on ``device`` (the card unless the
caller asks for the CPU). ``fn(*example_args)`` gives (batch, 1000) float32
logits. The JAX package's data-parallel dry run (``dryrun_multichip``)
has no twin yet (ROADMAP queue 1, item 8: what it left).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .models import get_model
from .utils.device import resolve_device


def entry(device: str | torch.device = "cuda", batch: int = 32, image_size: int = 224):
    """``(fn, (params, state, x))``: the bf16 eval forward of
    MobileNetV3-Large and its example arguments on ``device``."""
    dev = resolve_device(device)
    net = get_model(ModelConfig(arch="mobilenet_v3_large"), image_size=image_size)
    params, state = net.init(torch.Generator().manual_seed(0))

    def put(tree):
        return {k: put(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    def fwd(params, state, x):
        with torch.inference_mode():
            return net.apply(params, state, x, train=False, compute_dtype=torch.bfloat16)

    x = torch.zeros((batch, image_size, image_size, 3), dtype=torch.float32, device=dev)
    return fwd, (put(params), put(state), x)

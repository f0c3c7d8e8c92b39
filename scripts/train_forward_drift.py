#!/usr/bin/env python3
"""How far a whole net's float32 training forward (batch statistics) drifts
in each package, on the CPU: the JAX package's and the PyTorch port's
logits from the same numpy-made weights and images, each against the
port's forward in float64.

    JAX_PLATFORMS=cpu python3 scripts/train_forward_drift.py [--size 64] [--batch 2] [ARCH ...]

The nets are tests/test_torch_port_families.py's (each family at its
published width, from its shipped config), with dropout and drop_connect
off. It prints, per net, the largest |logit| and the largest difference of
the JAX package's logits from the port's (float32), and of each from the
port's float64 forward.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("arch", nargs="*")
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_port_families import FAMILIES, family_nets, images
    from test_torch_port_models import _jax_tree, _jax_weights_with_seeded_stats
    from yet_another_mobilenet_series_tpu_torch.models import convert

    for arch in args.arch or list(FAMILIES):
        jnet, pnet = family_nets(arch, image_size=args.size, dropout=0.0, drop_connect=0.0)
        params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=31)
        x = images(32, n=args.batch, size=args.size)
        want, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=True, bn_mode="exact"))(
            _jax_tree(params), _jax_tree(state), jnp.asarray(x))
        want = np.asarray(want, np.float64)

        def port(dtype):
            p = convert.from_jax({k: v.astype(dtype) for k, v in params.items()})
            s = convert.from_jax({k: v.astype(dtype) for k, v in state.items()})
            kw = {} if dtype == np.float32 else {"compute_dtype": torch.float64}
            with torch.no_grad():
                out, _ = pnet.apply(p, s, torch.from_numpy(x.astype(dtype)), train=True, bn_mode="exact", **kw)
            return out.double().numpy()

        p32, p64 = port(np.float32), port(np.float64)
        print(f"{arch} at {args.size} px, batch {args.batch}: max |logit| {np.abs(p64).max():.3e}; JAX - port (float32) "
              f"{np.abs(want - p32).max():.3e}; JAX - port float64 {np.abs(want - p64).max():.3e}; port float32 - "
              f"port float64 {np.abs(p32 - p64).max():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

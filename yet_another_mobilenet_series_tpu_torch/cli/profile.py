# Copy of yet_another_mobilenet_series_tpu/cli/profile.py: the port keeps its own copy so that it never imports the
# JAX package; its parse_cli, get_model and profile_network are the port's.
"""Model profiling CLI (reference: utils/model_profiling.py's printed
summary, SURVEY.md §2 #10):

  python -m yet_another_mobilenet_series_tpu.cli.profile app:apps/<x>.yml
  python -m yet_another_mobilenet_series_tpu.cli.profile model.arch=mnasnet_a1

Prints the per-layer MACs/params table, totals, and (for supernets) the
per-block atom-cost distribution that weights the AtomNAS penalty.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import parse_cli
from ..models import get_model
from ..utils.profiling import profile_network


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    net = get_model(cfg.model, cfg.data.image_size)
    prof = profile_network(net)
    name = cfg.model.network_spec or f"{cfg.model.arch} x{cfg.model.width_mult}"
    print(f"# {name} @ {cfg.data.image_size}x{cfg.data.image_size}")
    print(prof.summary())
    print(f"\ntotal: {prof.total_macs/1e6:.1f}M MACs, {prof.total_params/1e6:.3f}M params")
    multi_kernel = [i for i, b in enumerate(net.blocks) if len(b.kernel_sizes) > 1]
    if multi_kernel:
        print("\natom cost table (per-block min/mean/max MACs per atom):")
        for i in multi_kernel:
            c = prof.atom_costs[i]
            print(f"  block{i:<3} atoms={c.size:<5} cost {c.min():>10.0f} / {np.mean(c):>10.0f} / {c.max():>10.0f}")


if __name__ == "__main__":
    main()

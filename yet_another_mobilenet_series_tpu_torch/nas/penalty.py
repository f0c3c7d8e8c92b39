"""Cost-weighted BN-gamma L1 penalty, the AtomNAS search objective: the
torch twin of ``yet_another_mobilenet_series_tpu/nas/penalty.py``.

    loss = CE + rho * sum_atoms( cost[atom] * |gamma[atom]| )

Each atom is one expanded channel of an InvertedResidual block; its gamma is
the entry of the block's post-depthwise BN scale (``ops/blocks.py`` keeps one
concatenated BN across the kernel branches). Dead atoms (mask 0) are left
out, so the pressure concentrates on the living network.

``prune.cost`` picks the cost: ``"flops"`` (the analytic per-atom MACs of
``utils/profiling.py``) or ``"latency_table"`` (per-atom latency slopes of a
measured table, ``nas/latency.py``). Either way only the constants baked in
at build time differ.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PruneConfig
from ..models.specs import Network
from ..utils.device import resolve_device
from ..utils.profiling import profile_network


def atom_cost_table(net: Network, cfg: PruneConfig) -> dict[str, np.ndarray]:
    """Per-block float32 cost vectors, keyed by block index as str (the
    params/masks key convention). Normalized by the network's total cost
    (MACs, or measured latency in table mode) when ``cfg.normalize_cost``,
    so rho does not depend on resolution or width, nor on the cost mode."""
    from .masking import prunable_blocks

    keep = set(prunable_blocks(net))
    if cfg.cost == "latency_table":
        from .latency import LatencyTable

        if not cfg.latency_table:
            raise ValueError(
                "prune.cost='latency_table' needs prune.latency_table "
                "(a scripts/latency_table.py LATENCY_TABLE_*.json artifact)"
            )
        table = LatencyTable.load(cfg.latency_table)
        costs, total = table.atom_cost_table(net, keep)
        scale = 1.0 / total if cfg.normalize_cost else 1.0
        return {str(i): (c * scale).astype(np.float32) for i, c in costs.items()}
    if cfg.cost != "flops":
        raise ValueError(f"unknown prune.cost {cfg.cost!r} (expected 'flops' or 'latency_table')")
    prof = profile_network(net)
    scale = 1.0 / float(prof.total_macs) if cfg.normalize_cost else 1.0
    return {str(i): (c * scale).astype(np.float32) for i, c in prof.atom_costs.items() if i in keep}


def make_penalty_fn(net: Network, cfg: PruneConfig, steps_per_epoch: int | None = None,
                    device: str | torch.device = "cuda", costs: dict[str, np.ndarray] | None = None):
    """Returns penalty_fn(params, masks, rho_mult=None, step=None) -> a
    0-dim float32 tensor for the train step.

    The weight is ``rho * ramp(step) * rho_mult``: ``ramp`` is the linear
    warmup over ``cfg.rho_ramp_epochs`` (identity for the constant
    schedule), and ``rho_mult`` the adaptive multiplier the TrainState
    carries on the device. gamma is read in float32 whatever the compute
    dtype. The cost vectors (``costs``, else :func:`atom_cost_table`'s) go
    to ``device`` here, once, so the penalty copies nothing from the host
    inside a step."""
    if cfg.rho_schedule not in ("constant", "ramp", "adaptive"):
        raise ValueError(f"unknown rho_schedule {cfg.rho_schedule!r}")
    if cfg.rho_schedule == "adaptive" and not cfg.target_flops:
        raise ValueError("rho_schedule='adaptive' needs prune.target_flops (the controller feeds on the FLOPs gap)")
    dev = resolve_device(device)
    costs = {k: torch.from_numpy(v).to(dev) for k, v in (atom_cost_table(net, cfg) if costs is None
                                                         else costs).items()}
    rho = float(cfg.rho)
    ramp_steps = 0
    if cfg.rho_schedule in ("ramp", "adaptive") and cfg.rho_ramp_epochs > 0:
        if steps_per_epoch is None:
            raise ValueError("rho_ramp_epochs needs steps_per_epoch")
        ramp_steps = max(int(cfg.rho_ramp_epochs * steps_per_epoch), 1)

    def penalty_fn(params, masks, rho_mult=None, step=None):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for k, cost in costs.items():
            term = cost * params["blocks"][k]["dw_bn"]["gamma"].float().abs()
            if masks and k in masks:
                term = term * masks[k].float()
            total = total + torch.sum(term)
        r = torch.full((), rho, dtype=torch.float32, device=dev)
        if ramp_steps and step is not None:
            r = r * torch.clamp(step.float() / ramp_steps, 0.0, 1.0)
        if rho_mult is not None:
            r = r * rho_mult.float()
        return r * total

    return penalty_fn

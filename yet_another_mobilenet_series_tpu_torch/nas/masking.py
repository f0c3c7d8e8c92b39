"""Channel masks of the AtomNAS search: the torch twin of
``yet_another_mobilenet_series_tpu/nas/masking.py``.

Shrinkage is a monotonic 0/1 float32 mask over each prunable block's
expanded channels ("atoms"), kept on the run's device and updated there at
a fixed cadence; the masked forward equals the physically shrunk forward
(``nas/rematerialize.py``), which reclaims the FLOPs at a coarser cadence.

The prune event (:func:`make_prune_event`) never waits on the host: its
cadence gate, the reached-target check, the adaptive-rho feedback and the
conditional update are ``torch.where`` selects on 0-dim device tensors, so
the CLI dispatches it between steps like a step. :func:`mask_summary` reads
the masks to the host, so the CLI calls it only at log points.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PruneConfig
from ..models.specs import Network
from ..utils.device import resolve_device
from ..utils.profiling import masked_macs, profile_network


def prunable_blocks(net: Network) -> list[int]:
    """Blocks whose expanded channels are atoms. Blocks without an expand
    conv (t=1 / depthwise-separable) are excluded: their depthwise channels
    are the block's input itself, so removing one cannot be rematerialized
    into a smaller dense block."""
    return [i for i, b in enumerate(net.blocks) if b.has_expand]


def init_masks(net: Network, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """All-alive float32 masks for every prunable block, on ``device``
    (string block-index keys, as the params tree has them)."""
    dev = resolve_device(device)
    return {str(i): torch.ones(net.blocks[i].expanded_channels, dtype=torch.float32, device=dev)
            for i in prunable_blocks(net)}


def masks_to_host(masks) -> dict[str, np.ndarray]:
    """{block key as str: float32 numpy mask}, read from the device in one
    copy (the masks laid end to end); numpy masks pass through."""
    keys = list(masks)
    if not keys:
        return {}
    if not isinstance(masks[keys[0]], torch.Tensor):
        return {str(k): np.asarray(masks[k], np.float32) for k in keys}
    flat = torch.cat([masks[k].reshape(-1).float() for k in keys]).cpu().numpy()
    return dict(zip(map(str, keys), np.split(flat, np.cumsum([masks[k].numel() for k in keys])[:-1])))


def make_mask_update(net: Network, cfg: PruneConfig):
    """Returns update(params, masks) -> new_masks, all on the device.

    An atom dies when |gamma| < threshold; death is irreversible (the mask
    is multiplied in). A block without a residual is the only path through
    the chain: if all its atoms fell below the threshold, the strongest
    previously alive one is revived (``torch.argmax`` takes the first of
    equal maxima, as ``jnp.argmax`` does)."""
    threshold = float(cfg.gamma_threshold)
    residual = {str(i): b.has_residual for i, b in enumerate(net.blocks)}

    def update(params, masks):
        new = {}
        for k, m in masks.items():
            gamma = params["blocks"][k]["dw_bn"]["gamma"]
            alive = m * (gamma.abs() >= threshold).float()
            if not residual[k]:
                best = torch.argmax(gamma.abs() * m)
                revive = (torch.arange(m.shape[0], device=m.device) == best).float() * m
                alive = torch.where(alive.sum() == 0, revive, alive)
            new[k] = alive
        return new

    return update


def make_prune_event(net: Network, cfg: PruneConfig, stop_step: int, device: str | torch.device = "cuda"):
    """The complete per-cadence prune event, (params, masks, rho_mult, step)
    -> (masks, rho_mult), on the device: the reached-target check, the
    adaptive-rho feedback and the conditional mask update.

    The reached check uses the linear form of ``utils/profiling.masked_macs``
    (exact: every atom's expand/dw/SE/project MACs scale per channel):
    effective = total - sum_b cost_b . (1 - m_b), in float32. ``step`` is
    the 0-dim device counter of the just-completed step; the event changes
    nothing unless ``step % mask_interval == 0 and step <= stop_step``. The
    cost vectors go to ``device`` here, once, so the event copies nothing
    from the host."""
    update = make_mask_update(net, cfg)
    prof = profile_network(net)
    dev = resolve_device(device)
    total = float(prof.total_macs)
    costs = {str(i): torch.from_numpy(np.asarray(c, np.float32)).to(dev) for i, c in prof.atom_costs.items()}
    interval = int(cfg.mask_interval)
    target = float(cfg.target_flops)
    adaptive = cfg.rho_schedule == "adaptive" and target > 0
    up, down = 1.0 + cfg.rho_adapt_rate, 1.0 - cfg.rho_adapt_rate

    def event(params, masks, rho_mult, step):
        do = (step % interval == 0) & (step <= stop_step)
        if target > 0:
            eff = torch.full((), total, dtype=torch.float32, device=step.device)
            for k, m in masks.items():
                eff = eff - torch.sum(costs[k] * (1.0 - m))
            reached = eff <= target
        else:
            reached = torch.zeros((), dtype=torch.bool, device=step.device)
        if adaptive and rho_mult is not None:
            new_rho = torch.clamp(rho_mult * torch.where(reached, down, up), cfg.rho_adapt_min, cfg.rho_adapt_max)
            rho_mult = torch.where(do, new_rho, rho_mult)
        new_masks = update(params, masks)
        apply_update = do & ~reached
        masks = {k: torch.where(apply_update, new_masks[k], m) for k, m in masks.items()}
        return masks, rho_mult

    return event


def mask_summary(net: Network, masks) -> dict:
    """Host-side logging payload: alive atom counts and effective MACs (one
    read of the masks from the device)."""
    np_masks = {int(k): v for k, v in masks_to_host(masks).items()}
    return {
        "alive_atoms": int(sum(m.sum() for m in np_masks.values())),
        "total_atoms": int(sum(m.size for m in np_masks.values())),
        "effective_macs": masked_macs(net, np_masks),
    }

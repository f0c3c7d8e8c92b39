"""Physical shape rematerialization, masks -> a smaller Network: the torch
twin of ``yet_another_mobilenet_series_tpu/nas/rematerialize.py``.

The search masks atoms on the device at the mask cadence; here, at the
coarser ``prune.remat_epochs`` cadence, the surviving channels become a
smaller network and the tensors are sliced to it, so the masked FLOPs turn
into real ones. ``serve/export.py`` reuses the same surgery to hard-apply a
checkpoint's masks before folding BN.

Surgery per block, given its keep-set of expanded channels, in the port's
layouts (OIHW convs, (in, out) SE matrices):
- expand conv rows (dim 0), expand/dw BN entries, each depthwise branch's
  rows, SE reduce rows and SE expand columns and bias, project conv
  columns (dim 1); the project BN is untouched;
- a kernel branch whose atoms all died is dropped and the ``dw{i}_k{k}``
  keys are renumbered to stay contiguous;
- a block whose atoms all died is dropped when it has a residual (it is
  the identity then); without one no equivalent network exists and the
  call refuses (``nas/masking.py`` revives an atom so this never happens
  in a search);
- the optimizer's params-shaped buffers and the EMA trees are sliced the
  same way (``count`` passes through), so RMSProp and EMA history survive
  the rebuild.

Every slice is an ``index_select`` with index tensors on the sliced
tensor's own device; the masks are read to the host once per call. The
masked and the rebuilt forward are equal (``tests/test_torch_port_nas.py``),
so no BN statistic needs recalibration.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..models.specs import Network
from ..ops.blocks import InvertedResidual
from ..utils.treeutil import map_params_shaped, tree_structure
from .masking import init_masks, masks_to_host


@dataclass
class RematReport:
    dropped_blocks: list[int]
    dropped_branches: dict[int, list[int]]  # old block idx -> dropped kernel sizes
    atoms_before: int
    atoms_after: int
    index_map: dict[int, int]  # old block idx -> new block idx


class _Index:
    """One keep-set as a numpy array and, made on first use, as an int64
    index tensor on each device that asks for it."""

    def __init__(self, keep: np.ndarray):
        self.keep = keep
        self._on: dict = {}

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        idx = self._on.get(t.device)
        if idx is None:
            idx = self._on[t.device] = torch.from_numpy(self.keep.astype(np.int64)).to(t.device)
        return t.index_select(dim, idx)


@dataclass
class _BlockCut:
    block: InvertedResidual
    keep: _Index
    branches: list[_Index]  # per kernel branch, its kept channels (empty = dropped)

    def params(self, pb: dict) -> dict:
        """The block's params-shaped subtree (params, optimizer buffers, EMA
        params) cut to the kept atoms, keys in ``InvertedResidual.init``'s
        order with the surviving branches renumbered."""
        keep = self.keep
        out = {}
        if "expand" in pb:
            out["expand"] = {"w": keep.take(pb["expand"]["w"], 0)}
            out["expand_bn"] = {k: keep.take(v, 0) for k, v in pb["expand_bn"].items()}
        new_i = 0
        for i, (k, bk) in enumerate(zip(self.block.kernel_sizes, self.branches)):
            if bk.keep.size:
                out[f"dw{new_i}_k{k}"] = {"w": bk.take(pb[f"dw{i}_k{k}"]["w"], 0)}
                new_i += 1
        out["dw_bn"] = {k: keep.take(v, 0) for k, v in pb["dw_bn"].items()}
        if "se" in pb:
            se = pb["se"]
            out["se"] = {"reduce": {"w": keep.take(se["reduce"]["w"], 0), "b": se["reduce"]["b"]},
                         "expand": {"w": keep.take(se["expand"]["w"], 1), "b": keep.take(se["expand"]["b"], 0)}}
        out["project"] = {"w": keep.take(pb["project"]["w"], 1)}
        out["project_bn"] = dict(pb["project_bn"])
        return out

    def state(self, sb: dict) -> dict:
        """The block's BN state: expand/dw BN statistics cut, project BN kept."""
        return {bn: dict(s) if bn == "project_bn" else {k: self.keep.take(v, 0) for k, v in s.items()}
                for bn, s in sb.items()}


def rematerialize(net: Network, params: dict, state: dict, masks, *, opt_state=None, ema_params=None,
                  ema_state=None):
    """Returns (new_net, new_params, new_state, new_masks, extras, report)
    where extras = {'opt_state', 'ema_params', 'ema_state'} holds whichever
    optional trees were passed, sliced to the new shapes. ``masks`` are
    device tensors or numpy arrays; the new all-alive masks lie on the
    params' device."""
    np_masks = masks_to_host(masks)
    new_blocks: list[InvertedResidual] = []
    cuts: dict[int, _BlockCut | None] = {}  # old index -> cut (None: passes through)
    dropped_blocks: list[int] = []
    dropped_branches: dict[int, list[int]] = {}
    index_map: dict[int, int] = {}
    atoms_before = atoms_after = 0

    for i, block in enumerate(net.blocks):
        m = np_masks.get(str(i))
        if m is None:  # non-prunable block: passes through
            index_map[i] = len(new_blocks)
            new_blocks.append(block)
            cuts[i] = None
            continue
        atoms_before += m.size
        keep = np.flatnonzero(m > 0)
        if keep.size == 0:
            if block.has_residual:
                dropped_blocks.append(i)
                continue
            raise ValueError(
                f"block {i} (no residual) has an all-dead mask; no equivalent "
                "rematerialization exists — masks must keep >=1 atom alive here"
            )
        atoms_after += keep.size
        offsets = np.cumsum([0] + list(block.group_channels))
        branches, kept_kernels, kept_groups, dropped_k = [], [], [], []
        for j, k in enumerate(block.kernel_sizes):
            bk = keep[(keep >= offsets[j]) & (keep < offsets[j + 1])] - offsets[j]
            branches.append(_Index(bk))
            if bk.size:
                kept_kernels.append(k)
                kept_groups.append(int(bk.size))
            else:
                dropped_k.append(k)
        if dropped_k:
            dropped_branches[i] = dropped_k
        index_map[i] = len(new_blocks)
        new_blocks.append(replace(block, expanded_channels=int(keep.size), kernel_sizes=tuple(kept_kernels),
                                  group_channels=tuple(kept_groups),
                                  # the expand conv exists and must survive even
                                  # if keep.size happens to equal in_channels
                                  force_expand=block.has_expand))
        cuts[i] = _BlockCut(block, _Index(keep), branches)

    new_net = replace(net, blocks=tuple(new_blocks))

    def slice_tree(tree: dict, cut_of) -> dict:
        out = dict(tree)
        out["blocks"] = {str(new_i): (tree["blocks"][str(old_i)] if cuts[old_i] is None
                                      else cut_of(cuts[old_i], tree["blocks"][str(old_i)]))
                         for old_i, new_i in index_map.items()}
        return out

    def slice_params(p):
        return slice_tree(p, _BlockCut.params)

    def slice_state(s):
        return slice_tree(s, _BlockCut.state)

    extras: dict = {}
    if opt_state is not None:
        extras["opt_state"] = map_params_shaped(opt_state, tree_structure(params), slice_params)
    if ema_params is not None:
        extras["ema_params"] = slice_params(ema_params)
    if ema_state is not None:
        extras["ema_state"] = slice_state(ema_state)
    device = next(iter(params["blocks"].values()))["project"]["w"].device
    report = RematReport(dropped_blocks, dropped_branches, atoms_before, atoms_after, index_map)
    return new_net, slice_params(params), slice_state(state), init_masks(new_net, device), extras, report

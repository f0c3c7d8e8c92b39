"""Collectives over lists of tensors, for the data-parallel path
(``parallel/``, the SyncBN of ``ops/layers.py`` and the group-aware steps of
``train/steps.py``).

A list goes over the wire as ONE flat buffer (a bucket): each tensor starts
at a multiple of ``ALIGN`` elements, so the views handed back are aligned
like fresh allocations and the ``_foreach`` kernels that read them take the
same vectorized path, with the same reduction order, as on the tensors they
replace. A sum over one rank followed by a division by 1 is then exact, bit
for bit. ``group=None`` is one process: every helper returns its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ALIGN = 16  # elements: 64 bytes of float32


def group_size(group) -> int:
    """The number of ranks of ``group``; 1 for None (one process)."""
    return 1 if group is None else dist.get_world_size(group)


def first_rank(group) -> int:
    """The global rank of ``group``'s rank 0 (what ``broadcast`` takes as
    its source)."""
    return dist.get_global_rank(group, 0)


def _offsets(tensors: list[torch.Tensor]) -> tuple[list[int], int]:
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() // ALIGN) * ALIGN
    return offsets, total


def pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors laid end to end, each at an ALIGN-element offset, in one
    new buffer of their (common) dtype; the gaps are 0."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"a bucket holds one dtype, got {sorted(map(str, dtypes))}")
    offsets, total = _offsets(tensors)
    flat = torch.zeros(total, dtype=tensors[0].dtype, device=tensors[0].device)
    views = [flat[o: o + t.numel()].view(t.shape) for o, t in zip(offsets, tensors)]
    torch._foreach_copy_(views, tensors)
    return flat


def unpack(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of ``flat`` shaped like ``like`` (the inverse of :func:`pack`)."""
    offsets, _ = _offsets(like)
    return [flat[o: o + t.numel()].view(t.shape) for o, t in zip(offsets, like)]


def all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean over the group's ranks of each tensor: one bucketed sum,
    then a division by the group's size (views of the bucket)."""
    if group is None or not tensors:
        return tensors
    flat = pack(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(group_size(group))
    return unpack(flat, tensors)


def all_reduce_sum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The sum over the group's ranks of each tensor, in one bucket."""
    if group is None or not tensors:
        return tensors
    flat = pack(tensors)
    dist.all_reduce(flat, group=group)
    return unpack(flat, tensors)


def broadcast_first(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Rank 0's value of each tensor on every rank, in one bucket."""
    if group is None or not tensors:
        return tensors
    flat = pack(tensors)
    dist.broadcast(flat, src=first_rank(group), group=group)
    return unpack(flat, tensors)

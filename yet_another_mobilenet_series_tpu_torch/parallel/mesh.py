"""The data-parallel world of the port: the torch twin of
``yet_another_mobilenet_series_tpu/parallel/mesh.py``.

The JAX package runs one SPMD program over a 1-D ``('data',)`` mesh of
devices. The port runs one process per device (a rank), joined by a
``torch.distributed`` process group: NCCL between cards, gloo between CPU
processes. The backend follows the device; there is no fallback from one
to the other, and a group that fails to come up raises.

A :class:`Mesh` is this rank's view of the world: its group (None for one
process, where every collective of the port is skipped), its rank, the
world's size and its device. :func:`init_mesh` makes the group:

- ``dist.multihost=true`` reads torchrun's ``env://`` rendezvous
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); the rank's card is ``cuda:LOCAL_RANK``;
- ``dist.num_devices=N > 1`` without it: ``cli/train.py`` starts N local
  ranks itself and hands each its rank and a loopback address
  (``tcp://127.0.0.1:<port>``); rank r's card is ``cuda:r``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..models.convert import flatten_tree, unflatten_tree
from ..obs import trace as obs_trace
from ..utils import collectives
from ..utils.device import resolve_device

DATA_AXIS = "data"
# how long a collective (and the rendezvous) may wait for a missing rank
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the data-parallel world."""

    group: object  # a ProcessGroup, or None for one process
    rank: int
    size: int
    device: torch.device

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def backend_for(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def requested_world(num_devices: int, device: str | torch.device) -> int:
    """``dist.num_devices`` as a number of local ranks: 0 is every card (one
    process on the CPU). Raises when it asks for more cards than the machine
    has, or for a card where there is none."""
    dev = resolve_device(device)
    if num_devices < 0:
        raise ValueError(f"dist.num_devices must be >= 0, got {num_devices}")
    if dev.type != "cuda":
        return num_devices or 1
    have = torch.cuda.device_count()
    if num_devices > have:
        raise ValueError(f"dist.num_devices={num_devices} asks for {num_devices} cards; this machine has {have}")
    return num_devices or have


def make_mesh(device: str | torch.device = "cuda", group=None) -> Mesh:
    """This rank's mesh over an initialized ``group`` (any backend, the
    caller's choice), or, with ``group=None``, the mesh of one process."""
    if group is None:
        return Mesh(group=None, rank=0, size=1, device=resolve_device(device))
    return Mesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group), device=resolve_device(device))


def init_mesh(device: str | torch.device = "cuda", *, rank: int | None = None, world: int | None = None,
              init_method: str | None = None) -> Mesh:
    """Join the world and return this rank's mesh. Without ``rank`` the
    rendezvous is torchrun's ``env://`` (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); with it, ``init_method`` names the store of ``world``
    ranks started on this machine. The group is forced up with one
    all-reduce before this returns, so a backend that cannot start (NCCL on
    a broken card) raises here, not at the first step."""
    if rank is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"dist.multihost needs torchrun's env:// rendezvous; missing {missing}")
        rank, world, local = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ["LOCAL_RANK"])
        init_method = "env://"
    else:
        local = rank
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank, world_size=world,
                                timeout=TIMEOUT)
    mesh = make_mesh(dev, dist.group.WORLD)
    if (mesh.rank, mesh.size) != (rank, world):
        raise RuntimeError(f"the initialized process group is rank {mesh.rank} of {mesh.size}, not {rank} of {world}")
    dist.all_reduce(torch.zeros(1, device=dev), group=mesh.group)
    return mesh


def is_coordinator() -> bool:
    """True on exactly one rank (rank 0, or the only process): it alone
    writes checkpoints and logs, like the reference's ``is_master()``."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int, mesh: Mesh) -> int:
    """This rank's share of the global batch (one device per rank)."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by {mesh.size} devices")
    return global_batch // mesh.size


def _local_rows(batch: dict, mesh: Mesh) -> dict:
    local = local_batch_slice(next(iter(batch.values())).shape[0], mesh)
    return {k: v[mesh.rank * local: (mesh.rank + 1) * local] for k, v in batch.items()}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (rank r holds rows r*local ..
    (r+1)*local - 1), on the rank's device."""
    return {k: v.to(mesh.device) for k, v in _local_rows(batch, mesh).items()}


def replicate(tree, mesh: Mesh):
    """Rank 0's value of every tensor of ``tree`` (a nested dict of
    tensors, or a tensor) on every rank: one broadcast per dtype."""
    if mesh.group is None:
        return tree
    flat = {"": tree} if isinstance(tree, torch.Tensor) else flatten_tree(tree)
    out = dict(flat)
    by_dtype: dict = collections.defaultdict(list)
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            by_dtype[v.dtype].append(k)
    for keys in by_dtype.values():
        out.update(zip(keys, collectives.broadcast_first([flat[k] for k in keys], mesh.group)))
    return out[""] if isinstance(tree, torch.Tensor) else unflatten_tree(out)


def prefetch_to_device(batch_iter, device: str | torch.device, depth: int = 2):
    """Wraps an iterator of host batches so that the copy of the NEXT batch
    to ``device`` overlaps the CURRENT step: on a card each batch is copied
    on a copy stream of its own from pinned memory, and the consumer's
    stream waits on the copy's event before it reads the batch (the
    engine's staging fences). ``depth`` batches are in flight. Values that
    are not tensors (a host array of stream positions) pass through as they
    are. Validated eagerly: the first copies start here."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    buf: collections.deque = collections.deque()

    def fill() -> bool:
        try:
            with obs_trace.get_tracer().span("data/prefetch_fill", "data"):
                batch = next(batch_iter)
                if not cuda:
                    buf.append(({k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in batch.items()},
                                None))
                    return True
                with torch.cuda.stream(copy_stream):
                    moved = {k: (v if v.is_cuda else v.pin_memory()).to(dev, non_blocking=True)
                             if isinstance(v, torch.Tensor) else v for k, v in batch.items()}
                    event = torch.cuda.Event()
                    event.record(copy_stream)
                buf.append((moved, event))
            return True
        except StopIteration:
            return False

    for _ in range(depth):
        if not fill():
            break

    def gen():
        while buf:
            batch, event = buf.popleft()
            if event is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(stream)  # the copy stream's allocation is now read on this one
            fill()
            yield batch

    return gen()


def prefetch_to_mesh(batch_iter, mesh: Mesh, depth: int = 2):
    """:func:`prefetch_to_device` of this rank's rows of each global batch."""
    return prefetch_to_device((_local_rows(b, mesh) for b in batch_iter), mesh.device, depth)

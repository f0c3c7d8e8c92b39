"""Distributed substrate of the port: the mesh (process group, rank,
device), the data-parallel steps, the replica check, the grouped step and
the ZeRO sharded update. The torch twin of
``yet_another_mobilenet_series_tpu/parallel``."""

from .dp import (
    make_dp_eval_step,
    make_dp_train_step,
    make_grouped_train_step,
    make_replica_sync_check,
    rank_generator,
)
from .mesh import (
    DATA_AXIS,
    Mesh,
    init_mesh,
    is_coordinator,
    local_batch_slice,
    make_mesh,
    prefetch_to_device,
    prefetch_to_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS", "Mesh", "init_mesh", "make_mesh", "shard_batch", "replicate", "prefetch_to_mesh",
    "prefetch_to_device", "local_batch_slice", "is_coordinator",
    "make_dp_train_step", "make_dp_eval_step", "make_replica_sync_check", "make_grouped_train_step",
    "rank_generator",
]

"""AtomNAS search machinery of the port: the penalty, the masks and the
prune event, rematerialization, and the measured-latency cost table (the
torch twin of ``yet_another_mobilenet_series_tpu/nas``)."""

from . import rematerialize  # submodule (rematerialize.rematerialize is the entry point)
from .latency import LatencyTable, block_input_sizes, block_key
from .masking import init_masks, make_mask_update, mask_summary, prunable_blocks
from .penalty import atom_cost_table, make_penalty_fn
from .rematerialize import RematReport

__all__ = [
    "init_masks", "make_mask_update", "mask_summary", "prunable_blocks",
    "atom_cost_table", "make_penalty_fn", "RematReport", "rematerialize",
    "LatencyTable", "block_input_sizes", "block_key",
]

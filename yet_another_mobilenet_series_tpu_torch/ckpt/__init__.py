"""Checkpointing of the port: torch.save step dirs with a network-spec
sidecar and per-item digests (``manager.py``), and the torchvision importer
(``torch_import.py``)."""

from .manager import CheckpointCorrupt, CheckpointManager

__all__ = ["CheckpointCorrupt", "CheckpointManager"]

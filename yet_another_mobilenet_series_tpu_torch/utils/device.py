"""Device selection for the port's entry points.

The port runs on the card: every entry point takes ``device="cuda"`` unless
the caller asks for the CPU. A request for CUDA on a machine without a card
raises; the port never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available, or names a backend the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev

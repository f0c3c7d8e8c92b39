"""Device selection for the port's entry points.

The port runs on the card: every entry point takes ``device="cuda"`` unless
the caller asks for the CPU. A request for CUDA on a machine without a card
raises; the port never carries on silently on the CPU.

:func:`set_tf32` sets the two process-wide TF32 switches from a run's
compute dtype, so that what a float32 run computes does not depend on
what ran before it in the process.
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


def set_tf32(compute_dtype: str) -> dict:
    """Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` from ``compute_dtype`` and
    return them as ``{"tf32_cudnn", "tf32_matmul"}``. float32 turns both
    off: cuDNN's TF32 default keeps about three decimal digits, which is
    not a float32 run. bfloat16 turns both on: its convolutions and matmuls
    already round to 8 bits, and the few float32 products left (the
    classifier's) may use TF32 as XLA's default precision does."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    on = compute_dtype != "float32"
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    return {"tf32_cudnn": torch.backends.cudnn.allow_tf32, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}

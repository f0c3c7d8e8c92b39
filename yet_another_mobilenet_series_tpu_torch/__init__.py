"""yet_another_mobilenet_series_tpu_torch: the PyTorch/CUDA port of
``yet_another_mobilenet_series_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package grows beside it slice by
slice and keeps its module names, so each module here has a counterpart of
the same path there. It imports ``torch`` and numpy, never ``jax`` and
nothing of the JAX package: modules it needs that are free of JAX are
copied (see the header of each copy).

The first slice is the serving path: the folded-BN forward
(``serve/export.py`` ``apply_folded``), the bucketed engine
(``serve/engine.py``) and the synthetic-load CLI (``cli/serve.py``). Each
depthwise stage runs a hand-written CUDA kernel for Hopper
(``csrc/fused_depthwise.cu`` through ``ops/fused_depthwise.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for CUDA without a card raises.
"""

__version__ = "0.1.0"

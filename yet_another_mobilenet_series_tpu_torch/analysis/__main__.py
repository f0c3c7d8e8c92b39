# Copy of yet_another_mobilenet_series_tpu/analysis/__main__.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""`python -m yet_another_mobilenet_series_tpu_torch.analysis` -> yamt-lint."""

import sys

from .cli import main

sys.exit(main())

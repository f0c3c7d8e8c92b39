"""yamt-lint entry point of the port — ``python -m
yet_another_mobilenet_series_tpu_torch.cli.lint [paths...]``, sibling of
cli.train/cli.serve.

Thin wrapper: the implementation lives in analysis/cli.py (also reachable as
``python -m yet_another_mobilenet_series_tpu_torch.analysis``). Rules and the
suppression syntax are documented in analysis/ANALYZER.md.
"""

from __future__ import annotations

import sys

from ..analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())

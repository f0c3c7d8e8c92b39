# Copy of yet_another_mobilenet_series_tpu/analysis/__init__.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""yamt-lint for the port: the JAX package's static analyzer
(yet_another_mobilenet_series_tpu/analysis/), copied with torch twins of
its JAX rules.

Pure AST, as its source: it never imports the code it reads, nor torch or
jax. The framework (core, symbols, callgraph, summaries, concurrency,
contracts, exceptions, reporters, cli) and the generic rules are the
source's, under the same ids; the rules that key on ``jax.*`` names have
torch twins under the same ids (YAMT001: host effects under CUDA-graph
capture; 002/010: generator discipline; 003: collectives without a group;
006: private torch APIs; 008: a graph's static output read after a later
replay; 009: recapture hazards; 013: profiler windows; 014: non_blocking
copies; 016: wire upcasts). ``ANALYZER.md`` beside this file is the rule
reference, ``scope.py`` the gate's scope, and the CLI is
``python -m yet_another_mobilenet_series_tpu_torch.analysis``.

The tier-1 gate runs the analyzer over the port's package
(tests/test_torch_port_lint_clean.py), so every invariant here is enforced
on every PR.
"""

from .core import (
    Finding,
    Project,
    Rule,
    SourceFile,
    check_suppressions,
    load_rules,
    register,
    run_lint,
)
from .reporters import render_github, render_json, render_text

__all__ = [
    "Finding",
    "Project",
    "Rule",
    "SourceFile",
    "check_suppressions",
    "load_rules",
    "register",
    "render_github",
    "render_json",
    "render_text",
    "run_lint",
]

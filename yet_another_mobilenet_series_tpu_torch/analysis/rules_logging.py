# Copy of yet_another_mobilenet_series_tpu/analysis/rules_logging.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT007 — bare ``print(`` in package code.

The observability PR routed every runtime signal through one path — the
coordinator :class:`Logger` (+ module-level ``emit``), the obs registry, and
the span tracer — so "the run went quiet" is diagnosable from metrics.jsonl
instead of depending on which host's stdout a warning raced past. A bare
``print`` in package code silently forks that path again. This rule keeps it
closed.

Scope: only *package* code — files whose directory holds an ``__init__.py``
on disk. Standalone scripts, tests, and lint fixtures are exempt (a CLI
script's printed output IS its interface). Sanctioned surfaces inside the
package:

- ``utils/logging.py`` — the one place prints are the sink, by design;
- ``cli/profile.py`` and ``analysis/cli.py`` — report CLIs whose stdout is
  their product;
- any code under an ``if __name__ == "__main__":`` guard (module CLIs).

(Prints inside jit-traced functions are a different bug — YAMT001 — and are
flagged there; this rule is about host-side logging discipline.)
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, register

# path suffixes (last two components) where print IS the output mechanism
_SANCTIONED = {"utils/logging.py", "cli/profile.py", "analysis/cli.py"}


def _is_main_guard(node: ast.If) -> bool:
    """``if __name__ == "__main__":`` (either comparison order)."""
    t = node.test
    if not (isinstance(t, ast.Compare) and len(t.ops) == 1 and isinstance(t.ops[0], ast.Eq)):
        return False
    sides = [t.left, t.comparators[0]]
    has_name = any(isinstance(s, ast.Name) and s.id == "__name__" for s in sides)
    has_main = any(isinstance(s, ast.Constant) and s.value == "__main__" for s in sides)
    return has_name and has_main


@register
class BarePrintInPackage(Rule):
    id = "YAMT007"
    name = "bare-print-in-package"
    description = (
        "bare print() in package code outside the sanctioned surfaces "
        "(utils/logging.py, cli/profile.py, analysis/cli.py, __main__ guards): "
        "route it through utils.logging.Logger/emit or the obs registry/tracer"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        path = src.path.replace(os.sep, "/")
        if "/".join(path.split("/")[-2:]) in _SANCTIONED:
            return []
        # package code only: a dir with __init__.py. Standalone scripts and
        # test/fixture trees print freely.
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []

        guarded: set[int] = set()
        for node in src.nodes:
            if isinstance(node, ast.If) and _is_main_guard(node):
                for sub in ast.walk(node):
                    guarded.add(id(sub))

        findings: list[Finding] = []
        for node in src.nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
                and id(node) not in guarded
            ):
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, self.id,
                        "bare print() in package code: route through "
                        "utils.logging.Logger/emit (or an obs registry counter) "
                        "so the signal reaches metrics.jsonl, not a random stdout",
                    )
                )
        return findings

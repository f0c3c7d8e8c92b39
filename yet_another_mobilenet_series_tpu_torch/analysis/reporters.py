# Copy of yet_another_mobilenet_series_tpu/analysis/reporters.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Finding reporters: human text, machine JSON, and GitHub workflow
annotations (scripts/lint.sh --format github in CI)."""

from __future__ import annotations

import json
from typing import Sequence

from .core import Finding


def render_text(findings: Sequence[Finding]) -> str:
    """`path:line:col: RULE message` per finding plus a summary line."""
    lines = [f.format() for f in findings]
    n = len(findings)
    lines.append("clean: no findings" if n == 0 else f"{n} finding{'s' if n != 1 else ''}")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    """Stable JSON document: {"count": N, "findings": [{...}]}."""
    doc = {
        "count": len(findings),
        "findings": [
            {"path": f.path, "line": f.line, "col": f.col, "rule": f.rule, "message": f.message}
            for f in findings
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def render_github(findings: Sequence[Finding]) -> str:
    """One ``::error`` workflow command per finding, so a GitHub Actions run
    annotates the offending line in the PR diff. Newlines inside messages
    are %-escaped per the workflow-command spec; a trailing plain summary
    line keeps the raw log readable."""

    def esc(s: str) -> str:
        return s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")

    lines = [
        f"::error file={f.path},line={f.line},col={f.col + 1},title={f.rule}::{esc(f.message)}"
        for f in findings
    ]
    n = len(findings)
    lines.append("clean: no findings" if n == 0 else f"{n} finding{'s' if n != 1 else ''}")
    return "\n".join(lines)

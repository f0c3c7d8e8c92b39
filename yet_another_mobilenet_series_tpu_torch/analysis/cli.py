# Copy of yet_another_mobilenet_series_tpu/analysis/cli.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""yamt-lint command line.

Entry points (equivalent):

    python -m yet_another_mobilenet_series_tpu_torch.analysis [paths...]
    python -m yet_another_mobilenet_series_tpu_torch.cli.lint [paths...]

With no paths, runs the gate (scope.py): the port's package under every
rule, its scripts' twins under the curated subset. Exit codes: 0 clean,
1 findings, 2 usage error (argparse).
"""

from __future__ import annotations

import argparse
import sys

from .core import check_suppressions, load_rules, run_lint
from .reporters import render_github, render_json, render_text
from .scope import gate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="yamt-lint",
        description="the port's capture-safety and contract static analyzer (analysis/ANALYZER.md)",
    )
    p.add_argument("paths", nargs="*", help="files or directories to lint (default: the gate's scope)")
    p.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        help="report format ('github' emits ::error workflow annotations for CI)",
    )
    p.add_argument("--select", default="", metavar="IDS", help="comma-separated rule ids to run (default: all)")
    p.add_argument(
        "--deselect", default="", metavar="IDS",
        help="comma-separated rule ids to skip (applied after --select; used by "
        "scripts/lint.sh --changed to drop the whole-package pairing rules, "
        "which would report every contract's absent other side on a partial "
        "file set)",
    )
    p.add_argument("--list-rules", action="store_true", help="print the rule registry and exit")
    p.add_argument(
        "--check-suppressions", action="store_true",
        help="audit suppression comments instead of linting: a suppression whose "
        "rule no longer fires at its site is reported as YAMT900",
    )
    args = p.parse_args(argv)

    if args.list_rules:
        for rule in load_rules():
            print(f"{rule.id}  {rule.name}\n    {rule.description}")
        return 0

    select = {s.strip().upper() for s in args.select.split(",") if s.strip()} or None
    deselect = {s.strip().upper() for s in args.deselect.split(",") if s.strip()}
    if deselect:
        select = (select if select is not None else {r.id for r in load_rules()}) - deselect
    runner = check_suppressions if args.check_suppressions else run_lint
    try:
        if args.paths:
            findings = runner(args.paths, select=select)
        else:
            findings = gate(select, check=args.check_suppressions)
    except (OSError, ValueError) as e:
        print(f"yamt-lint: {e}", file=sys.stderr)
        return 2
    renderer = {"json": render_json, "github": render_github, "text": render_text}[args.format]
    print(renderer(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

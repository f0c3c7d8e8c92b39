"""The gate's scope: what the port's analyzer lints, under which rules.

The JAX package's gate (tests/test_lint_clean.py) lints its package under
every rule and its scripts/ under a curated subset. The port keeps the
twins of those scripts in its package: bench/ (the benches), the two data
tools data/to_tfrecords.py and data/jpeg_corpus.py (command-line writers of
TFRecord shards and of seeded JPEG corpora), and the repo's chip_smoke.py
beside the package. Their interface is the line they print, not a log, and
they are linted under SCRIPT_RULES, the twin of the source's subset:
generator discipline (YAMT002) and private torch APIs (YAMT006). The rest
of the package is linted under every rule.
"""

from __future__ import annotations

import os

from .core import Finding, check_suppressions, run_lint

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIP_SMOKE = os.path.join(os.path.dirname(PACKAGE), "chip_smoke.py")
SCRIPTS = ("bench", os.path.join("data", "to_tfrecords.py"), os.path.join("data", "jpeg_corpus.py"))
SCRIPT_RULES = {"YAMT002", "YAMT006"}


def script_paths() -> list[str]:
    """The scripts' twins, chip_smoke.py where the checkout has it."""
    out = [os.path.join(PACKAGE, s) for s in SCRIPTS]
    return out + ([CHIP_SMOKE] if os.path.isfile(CHIP_SMOKE) else [])


def package_paths() -> list[str]:
    """Every .py and .yml file of the package but its scripts."""
    skip = {os.path.join(PACKAGE, s) for s in SCRIPTS}
    out = []
    for root, dirs, names in os.walk(PACKAGE):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__" and os.path.join(root, d) not in skip)
        out += [os.path.join(root, n) for n in sorted(names)
                if n.endswith((".py", ".yml", ".yaml")) and os.path.join(root, n) not in skip]
    return out


def gate(select: set[str] | None = None, check: bool = False) -> list[Finding]:
    """The gate's findings: the package under ``select`` (every rule when
    None), the scripts under the part of SCRIPT_RULES that ``select`` keeps.
    ``check`` audits the suppressions instead (YAMT900)."""
    runner = check_suppressions if check else run_lint
    scripts = SCRIPT_RULES if select is None else SCRIPT_RULES & set(select)
    return sorted(set(runner(package_paths(), select=select) + runner(script_paths(), select=scripts)))

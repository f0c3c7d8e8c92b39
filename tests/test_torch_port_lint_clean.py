"""Tier-1 gate of the port: its package lints clean under its own analyzer.

The twin of tests/test_lint_clean.py. The gate's scope is
yet_another_mobilenet_series_tpu_torch/analysis/scope.py: the package under
every rule, the twins of the JAX package's scripts/ (bench/, the two data
tools, chip_smoke.py) under SCRIPT_RULES. A finding here is a real hazard
or an undocumented suppression: fix the code, don't widen the gate. The
gate's time is printed by chip_smoke.py's phase 16 on the card's machine,
not held to a bar here.
"""

from yet_another_mobilenet_series_tpu_torch.analysis import check_suppressions, cli, run_lint, scope
from yet_another_mobilenet_series_tpu_torch.analysis.core import collect_paths
from yet_another_mobilenet_series_tpu_torch.analysis.rules_imports import allowed, private_names, resolve


def _report(findings):
    return "\n".join(f.format() for f in findings)


def test_package_lints_clean():
    findings = run_lint(scope.package_paths())
    assert findings == [], "the port must lint clean (see analysis/ANALYZER.md):\n" + _report(findings)


def test_scripts_lint_clean_under_curated_subset():
    assert scope.SCRIPT_RULES == {"YAMT002", "YAMT006"}
    paths = scope.script_paths()
    assert any(p.endswith("chip_smoke.py") for p in paths) and any(p.endswith("bench") for p in paths)
    findings = run_lint(paths, select=scope.SCRIPT_RULES)
    assert findings == [], "the scripts' twins must lint clean under the curated subset:\n" + _report(findings)


def test_no_stale_suppressions():
    findings = check_suppressions(scope.package_paths()) + check_suppressions(
        scope.script_paths(), select=scope.SCRIPT_RULES)
    assert findings == [], "stale suppression comments (delete them):\n" + _report(findings)


def test_scope_splits_the_package():
    pkg = set(scope.package_paths())
    assert not any("/bench/" in p or p.endswith(("to_tfrecords.py", "jpeg_corpus.py")) for p in pkg)
    assert any(p.endswith("serve/engine.py") for p in pkg) and any(p.endswith("analysis/core.py") for p in pkg)


def test_apps_ymls_are_covered():
    py, yml = collect_paths(scope.package_paths())
    assert any(p.endswith("config.py") for p in py)
    assert sum(p.endswith((".yml", ".yaml")) for p in yml) >= 10


def test_cli_with_no_paths_runs_the_gate(capsys):
    assert cli.main([]) == 0
    assert capsys.readouterr().out.strip() == "clean: no findings"


def test_private_names_let_through_resolve_here():
    # phase 16 of chip_smoke.py resolves the same names on the card's torch
    import torch

    names = private_names(scope.package_paths() + scope.script_paths())
    assert "torch._C._cuda_getCurrentRawStream" in names and "torch._foreach_add_" in names
    for name in names:
        if torch.version.cuda is None and "._cuda" in name:
            continue  # a CPU build of torch has no CUDA bindings; the card's has
        obj = resolve(name, torch)
        # every name is a function or a class, but the profiler's module flag of an open session (obs/trace.py)
        assert callable(obj) or (name == "torch.autograd.profiler._is_profiler_enabled" and isinstance(obj, bool)), name
    assert all(allowed(n) for n in names if n.startswith("torch._foreach_"))

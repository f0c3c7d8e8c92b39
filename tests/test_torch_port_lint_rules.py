"""The port's analyzer (yet_another_mobilenet_series_tpu_torch/analysis/)
held to the JAX package's (yet_another_mobilenet_series_tpu/analysis/).

- Every copied rule gives the JAX analyzer's findings, tolerance zero (rule,
  path, line, column and message), on the JAX package's own fixture trees
  (tests/fixtures/lint/<id>/{bad,clean}, read in place) and over both
  packages.
- Every torch twin flags its bad fixture (tests/fixtures/torch_lint/<id>/bad)
  with its own rule alone, and stays silent on its clean fixture.
- The framework (suppressions, the YAMT900 audit, the reporters, the CLI's
  exit codes and output) behaves as the JAX package's on the same inputs.
- The two copies that differ on purpose, callgraph.py and concurrency.py,
  are pinned by what their difference does.
"""

import dataclasses
import pathlib
import re

import pytest

from yet_another_mobilenet_series_tpu import analysis as jax_analysis
from yet_another_mobilenet_series_tpu.analysis import cli as jax_cli
from yet_another_mobilenet_series_tpu_torch import analysis
from yet_another_mobilenet_series_tpu_torch.analysis import cli
from yet_another_mobilenet_series_tpu_torch.analysis.core import Project, SourceFile

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "fixtures" / "lint"
FIXTURES = REPO / "tests" / "fixtures" / "torch_lint"
# the rules whose code is the JAX package's, under the same ids
COPIED = ["YAMT004", "YAMT005", "YAMT007", "YAMT011", "YAMT012", "YAMT015", "YAMT017", "YAMT018",
          "YAMT019", "YAMT020", "YAMT021", "YAMT022", "YAMT023", "YAMT024", "YAMT025"]
# the rules that key on jax.* names, re-written for torch under the same ids
TWINS = ["YAMT001", "YAMT002", "YAMT003", "YAMT006", "YAMT008", "YAMT009", "YAMT010", "YAMT013",
         "YAMT014", "YAMT016"]


# two JAX messages name the change that found their bug; the port's copies
# drop the reference (tests/test_torch_port_repairs.py pins it)
CHANGE_REF = re.compile(r" \(the PR \d+ [^)]*\)")


def _t(findings):
    return [dataclasses.astuple(f) for f in findings]


def _jax(findings):
    """The JAX analyzer's findings, as the port words them."""
    return [(p, ln, col, rule, CHANGE_REF.sub("", msg)) for p, ln, col, rule, msg in _t(findings)]


# -- the copied rules ---------------------------------------------------------


@pytest.mark.parametrize("side", ["bad", "clean"])
@pytest.mark.parametrize("rule_id", COPIED)
def test_copied_rule_gives_the_jax_findings(rule_id, side):
    path = JAX_FIXTURES / rule_id.lower() / side
    want = _jax(jax_analysis.run_lint([path], select={rule_id}))
    assert _t(analysis.run_lint([path], select={rule_id})) == want
    assert bool(want) == (side == "bad")


@pytest.mark.parametrize("tree", ["yet_another_mobilenet_series_tpu", "yet_another_mobilenet_series_tpu_torch"])
def test_copied_rules_agree_over_a_package(tree):
    # the port's own package included: with the scripts' twins in it, the
    # copied rules find the same bare prints and thread targets there
    path = REPO / tree
    assert _t(analysis.run_lint([path], select=set(COPIED))) == _jax(jax_analysis.run_lint([path], select=set(COPIED)))


def test_every_jax_rule_is_copied_or_twinned():
    jax_ids = {r.id for r in jax_analysis.load_rules()}
    ids = {r.id for r in analysis.load_rules()}
    assert ids == jax_ids == {f"YAMT{i:03d}" for i in range(1, 26)}
    assert set(COPIED) | set(TWINS) == ids and not set(COPIED) & set(TWINS)
    for rule in analysis.load_rules():
        jax_rule = next(r for r in jax_analysis.load_rules() if r.id == rule.id)
        assert (rule.description == CHANGE_REF.sub("", jax_rule.description)) == (rule.id in COPIED), rule.id


# -- the torch twins ----------------------------------------------------------


@pytest.mark.parametrize("rule_id", TWINS)
def test_twin_flags_its_bad_fixture_only(rule_id):
    findings = analysis.run_lint([FIXTURES / rule_id.lower() / "bad"])
    assert findings, f"{rule_id}: bad fixture produced no findings"
    assert {f.rule for f in findings} == {rule_id}, "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("rule_id", TWINS)
def test_twin_is_silent_on_its_clean_fixture(rule_id):
    findings = analysis.run_lint([FIXTURES / rule_id.lower() / "clean"])
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("side,rc", [("bad", 1), ("clean", 0)])
@pytest.mark.parametrize("rule_id", TWINS)
def test_cli_exit_code_on_twin_fixtures(rule_id, side, rc, capsys):
    assert cli.main([str(FIXTURES / rule_id.lower() / side)]) == rc
    capsys.readouterr()


BAD_LINES = {
    # print in a callee, float(tensor arg) and .cpu() in an autograd.Function,
    # time and .item() in a with-capture, a counter after capture_begin,
    # synchronize in a graphed callable
    "YAMT001": [8, 15, 21, 27, 29, 38, 51],
    "YAMT002": [6, 10, 17, 26],
    "YAMT003": [6, 7, 11],
    "YAMT006": [3, 4, 8, 12],
    "YAMT008": [9, 16, 27],
    "YAMT009": [6, 14, 29],
    "YAMT010": [13, 21],
    "YAMT013": [7, 15, 23],
    "YAMT014": [9, 16, 24],
    "YAMT016": [10, 17, 22],
}


@pytest.mark.parametrize("rule_id", TWINS)
def test_twin_flags_each_hazard_of_its_fixture(rule_id):
    # one finding per planted hazard, at its line: nothing missed, nothing extra
    findings = analysis.run_lint([FIXTURES / rule_id.lower() / "bad"])
    assert [f.line for f in findings] == BAD_LINES[rule_id]


# -- the copies that differ -----------------------------------------------------


def _project(path):
    src = SourceFile(str(path), path.read_text())
    return src, Project([src])


def test_callgraph_finds_the_capture_regions():
    src, project = _project(FIXTURES / "yamt001" / "bad" / "capture_effects.py")
    labels = sorted(r.label for r in project.callgraph.capture_roots(src))
    assert labels == ["Scale.backward", "Scale.forward", "capture_begin", "fwd", "torch.cuda.graph"]


def test_callgraph_resolves_make_graphed_callables_as_a_wrapper():
    src, project = _project(FIXTURES / "yamt009" / "bad" / "recapture.py")
    call = next(n.value for n in src.nodes if getattr(n, "targets", None) and getattr(n.targets[0], "id", "") == "f")
    t = project.callgraph.resolve_expr(src, call, src.scopes[id(call)])
    assert t.kind == "jit" and t.inner is None  # fn is a parameter: the wrapped callable is opaque


def test_concurrency_counts_torch_syncs_as_blocking():
    path = FIXTURES / "concurrency" / "bad"
    got = analysis.run_lint([path])
    assert [(f.rule, f.line) for f in got] == [("YAMT021", 34), ("YAMT021", 35)]
    assert jax_analysis.run_lint([path]) == []  # the JAX model knows no torch sync


# -- the framework, against the JAX package's -------------------------------------


HAZARD = 'import subprocess\nsubprocess.run(["true"])'
SUPPRESSION_CASES = {
    "unsuppressed": f"{HAZARD}\n",
    "line": f"{HAZARD}  # yamt-lint: disable=YAMT015\n",
    "other-rule": f"{HAZARD}  # yamt-lint: disable=YAMT018\n",
    "file": f"# yamt-lint: disable-file=YAMT015\n{HAZARD}\n",
    "all": f"{HAZARD}  # yamt-lint: disable=all\n",
    "docstring": f'"""quoted:  # yamt-lint: disable-file=YAMT015\n"""\n{HAZARD}\n',
    "stale-line": "import os  # yamt-lint: disable=YAMT015\n",
    "stale-file": "# yamt-lint: disable-file=YAMT015\nimport os\n",
    "syntax-error": "def f(:\n",
}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppressions_and_audit_match_the_jax_analyzer(tmp_path, case):
    (tmp_path / "__init__.py").write_text("")
    (tmp_path / "m.py").write_text(SUPPRESSION_CASES[case])
    for select in (None, {"YAMT015"}, {"YAMT002"}):
        assert _t(analysis.run_lint([tmp_path], select=select)) == _jax(jax_analysis.run_lint([tmp_path], select=select))
        assert (_t(analysis.check_suppressions([tmp_path], select=select))
                == _jax(jax_analysis.check_suppressions([tmp_path], select=select)))
    rules = {f.rule for f in analysis.run_lint([tmp_path])} | {f.rule for f in analysis.check_suppressions([tmp_path])}
    want = {"unsuppressed": {"YAMT015"}, "other-rule": {"YAMT015", "YAMT900"}, "docstring": {"YAMT015"},
            "stale-line": {"YAMT900"}, "stale-file": {"YAMT900"}, "syntax-error": {"YAMT000"}}
    assert rules == want.get(case, set())


@pytest.mark.parametrize("render", ["render_text", "render_json", "render_github"])
def test_reporters_match_the_jax_reporters(render):
    path = JAX_FIXTURES / "yamt015" / "bad"
    got = getattr(analysis, render)(analysis.run_lint([path]))
    assert got == getattr(jax_analysis, render)(jax_analysis.run_lint([path]))
    assert getattr(analysis, render)([]) == getattr(jax_analysis, render)([])


CLI_CASES = {
    "bad": ["yamt015/bad"],
    "clean": ["yamt015/clean"],
    "json": ["yamt018/bad", "--format", "json"],
    "github": ["yamt018/bad", "--format", "github"],
    "select": ["yamt015/bad", "--select", "yamt015,YAMT018"],
    "deselect": ["yamt015/bad", "--deselect", "YAMT015"],
    "select-deselect": ["yamt015/bad", "--select", "YAMT015,YAMT018", "--deselect", "YAMT018"],
    "check-suppressions": ["yamt015/clean", "--check-suppressions"],
    "missing-path": ["no/such/file.txt"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_the_jax_cli(case, capsys):
    args = [str(JAX_FIXTURES / a) if i == 0 else a for i, a in enumerate(CLI_CASES[case])]
    rc = cli.main(args)
    out = capsys.readouterr()
    jax_rc = jax_cli.main(args)
    jax_out = capsys.readouterr()
    assert (rc, out.out, out.err) == (jax_rc, jax_out.out, jax_out.err)
    assert rc == {"bad": 1, "json": 1, "github": 1, "select": 1, "select-deselect": 1, "missing-path": 2}.get(case, 0)


@pytest.mark.parametrize("args", [["--format", "xml"], ["--no-such-flag"]])
def test_cli_usage_errors_exit_2(args, capsys):
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(args)
        assert e.value.code == 2
    capsys.readouterr()


def test_cli_lists_the_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines() if line.startswith("YAMT")]
    assert listed == [f"YAMT{i:03d}" for i in range(1, 26)]

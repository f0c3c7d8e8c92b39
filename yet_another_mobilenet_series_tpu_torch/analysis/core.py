# Copy of yet_another_mobilenet_series_tpu/analysis/core.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""yamt-lint core: source model, rule registry, suppressions, runner.

The analyzer is pure AST — it never imports the code under analysis, so it
runs in milliseconds per file and cannot be broken by the very hazards it
hunts (a version-fragile jax import crashes ``import``, not ``ast.parse``).

Two rule shapes:

- file rules (``Rule.check_file``): one parsed module at a time, with the
  whole :class:`Project` available for cross-file context (e.g. the set of
  known mesh-axis constants);
- project rules (``Rule.check_project``): whole-tree invariants that have no
  single home file (dataclass/field-tuple contracts, YAML/config drift).

Suppressions are comment-driven, pylint-style::

    lax.psum(x, "data")  # yamt-lint: disable=YAMT003
    # yamt-lint: disable-file=YAMT001,YAMT002   (anywhere in the file)

``disable=all`` silences every rule for that line (or file).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint hit, orderable into a stable (path, line, col) report."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(
    r"#\s*yamt-lint:\s*disable(?P<scope>-file)?\s*=\s*(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


def _import_aliases(nodes) -> dict[str, str]:
    """Local binding -> dotted origin, from every import in the module.

    ``import numpy as np`` -> ``{'np': 'numpy'}``; ``from jax import lax`` ->
    ``{'lax': 'jax.lax'}``; relative imports keep their leading dots so they
    can never collide with an absolute ``jax.*``/``numpy.*`` match. Takes
    the already-walked node list so the file is traversed once, not twice.
    """
    aliases: dict[str, str] = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    aliases[top] = top
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}" if base else a.name
    return aliases


def qualified_name(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted path of a Name/Attribute chain with import aliases resolved.

    ``lax.psum`` under ``from jax import lax`` -> ``'jax.lax.psum'``; returns
    None when the chain is not rooted in a plain name (call results,
    subscripts).
    """
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


class SourceFile:
    """One .py file: text, parsed tree, suppression table, import aliases."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree: ast.Module | None = None
        self.parse_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_error = e
        self._nodes: list[ast.AST] | None = None
        self._dfs: list[ast.AST] | None = None
        self._span: dict[int, tuple[int, int]] | None = None
        self._scopes: dict[int, ast.AST | None] | None = None
        self._parents: dict[int, ast.AST] | None = None
        self.aliases = _import_aliases(self.nodes) if self.tree is not None else {}
        self.line_suppressions: dict[int, set[str]] = {}
        self.file_suppressions: set[str] = set()
        self.file_suppression_lines: dict[str, int] = {}
        # tokenizing every file for suppression comments costs more than
        # parsing it; a file without the literal marker has none to find
        for lineno, comment in self._comments() if "yamt-lint" in text else ():
            m = _SUPPRESS_RE.search(comment)
            if m is None:
                continue
            rules = {r.strip().upper() for r in m.group("rules").split(",")}
            if m.group("scope"):
                self.file_suppressions |= rules
                for r in rules:
                    self.file_suppression_lines.setdefault(r, lineno)
            else:
                self.line_suppressions.setdefault(lineno, set()).update(rules)

    def _comments(self):
        """(lineno, text) of every real COMMENT token. Tokenizing (rather
        than regex-scanning raw lines) keeps suppression syntax QUOTED in a
        docstring or string literal from registering as a live suppression.
        Falls back to whole-line scanning only if tokenization fails."""
        try:
            return [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(io.StringIO(self.text).readline)
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return list(enumerate(self.lines, start=1))

    @property
    def nodes(self) -> list[ast.AST]:
        """Every AST node of the file in ``ast.walk`` (BFS) order, computed
        once and shared: ~20 rules re-walking every tree was the single
        biggest lint-time cost."""
        if self._nodes is None:
            self._nodes = [] if self.tree is None else list(ast.walk(self.tree))
        return self._nodes

    def subtree(self, node: ast.AST):
        """Every node of ``node``'s subtree (``node`` included) — the same
        node SET as ``ast.walk(node)``, served as a slice of a one-time
        DFS order of the whole tree instead of a fresh pure-Python re-walk
        (subtree walks were the analyzer's single hottest primitive).
        Contiguity is the invariant: a node's descendants occupy one
        contiguous segment of the DFS list. Iteration order differs from
        ``ast.walk`` (DFS vs BFS) — no consumer may depend on sibling
        order across depths. Nodes from another tree fall back to a real
        walk, never a wrong slice."""
        self._index()
        span = self._span.get(id(node))
        if span is None:
            return ast.walk(node)
        i, j = span
        return self._dfs[i:j]

    @property
    def scopes(self) -> dict[int, ast.AST | None]:
        """id(node) -> nearest enclosing FunctionDef/AsyncFunctionDef
        (None = module scope; a def's OWN scope is its enclosing one),
        filled during the same one-time DFS pass as :meth:`subtree`."""
        self._index()
        return self._scopes

    def _index(self) -> None:
        if self._dfs is not None:
            return
        order: list[ast.AST] = []
        spans: dict[int, tuple[int, int]] = {}
        scopes: dict[int, ast.AST | None] = {}
        if self.tree is not None:
            scopes[id(self.tree)] = None
            work: list = [self.tree]
            while work:
                n = work.pop()
                if type(n) is tuple:
                    spans[n[0]] = (n[1], len(order))
                    continue
                start = len(order)
                order.append(n)
                work.append((id(n), start))
                child_scope = (
                    n if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else scopes[id(n)]
                )
                for child in ast.iter_child_nodes(n):
                    scopes[id(child)] = child_scope
                    work.append(child)
        self._dfs = order
        self._span = spans
        self._scopes = scopes

    @property
    def parents(self) -> dict[int, ast.AST]:
        """id(child) -> parent node for the whole tree, computed once
        (rules that walk upward — try/finally enclosure, statement
        context — were each rebuilding this map per file)."""
        if self._parents is None:
            parents: dict[int, ast.AST] = {}
            for node in self.nodes:
                for child in ast.iter_child_nodes(node):
                    parents[id(child)] = node
            self._parents = parents
        return self._parents

    def suppressed(self, finding: Finding) -> bool:
        for scope in (self.file_suppressions, self.line_suppressions.get(finding.line, ())):
            if "ALL" in scope or finding.rule.upper() in scope:
                return True
        return False


class Project:
    """Every parsed source + data file under the linted paths."""

    def __init__(self, files: Sequence[SourceFile], yml_files: Sequence[str] = ()):
        self.files = list(files)
        self.yml_files = list(yml_files)
        self._axis_constants: dict[str, str] | None = None
        self._symbols = None
        self._callgraph = None
        self._summaries = None
        self._concurrency = None
        self._contracts = None
        self._exceptions = None

    @property
    def symbols(self):
        """Project-wide symbol table (symbols.py), built once per Project."""
        if self._symbols is None:
            from .symbols import SymbolTable

            self._symbols = SymbolTable(self)
        return self._symbols

    @property
    def callgraph(self):
        """Intra-package call resolution (callgraph.py), built once."""
        if self._callgraph is None:
            from .callgraph import CallGraph

            self._callgraph = CallGraph(self)
        return self._callgraph

    @property
    def summaries(self):
        """qualname -> FunctionSummary (summaries.py). The dict is installed
        BEFORE the fixpoint runs so the call graph's returns-resolution can
        read partial results while they converge."""
        if self._summaries is None:
            from . import summaries as summaries_mod

            self._summaries = {}
            summaries_mod.compute(self, self._summaries)
            self._summaries_done = True  # callgraph memoization gate
        return self._summaries

    @property
    def concurrency(self):
        """Thread-root + lock-domain model (concurrency.py), built once."""
        if self._concurrency is None:
            from .concurrency import ConcurrencyModel

            self._concurrency = ConcurrencyModel(self)
        return self._concurrency

    @property
    def contracts(self):
        """Wire-contract extraction (contracts.py), built once per Project:
        headers, _ERROR_MAP, metric names/families, config schema."""
        if self._contracts is None:
            from .contracts import ContractModel

            self._contracts = ContractModel(self)
        return self._contracts

    @property
    def exceptions(self):
        """Escaping-exception-set summaries (exceptions.py), demand-driven
        over the call graph; built once per Project."""
        if self._exceptions is None:
            from .exceptions import ExceptionModel

            self._exceptions = ExceptionModel(self)
        return self._exceptions

    @property
    def axis_constants(self) -> dict[str, str]:
        """Known mesh axes across the project: constant name (or a synthetic
        ``Mesh axis '...'`` key) -> axis name. Ground truth for YAMT003, from
        two sources:

        - module-level ``X_AXIS = "name"`` string constants
          (``parallel/mesh.py`` ``DATA_AXIS`` in production);
        - axis-name literals in ``Mesh(devices, ('a', 'b'))`` construction
          calls (incl. the ``axis_names=`` keyword) — so a 2-D mesh whose
          second axis never gets its own constant still validates.
        """
        if self._axis_constants is None:
            consts: dict[str, str] = {}
            for src in self.files:
                if src.tree is None:
                    continue
                for node in src.tree.body:
                    if (
                        isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id.isupper()
                        and node.targets[0].id.endswith("_AXIS")
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)
                    ):
                        consts[node.targets[0].id] = node.value.value
                for node in src.nodes:
                    if not isinstance(node, ast.Call):
                        continue
                    q = qualified_name(node.func, src.aliases) or ""
                    if q.rsplit(".", 1)[-1] != "Mesh":
                        continue
                    axis_arg = node.args[1] if len(node.args) > 1 else next(
                        (kw.value for kw in node.keywords if kw.arg == "axis_names"), None
                    )
                    if axis_arg is None:
                        continue
                    elts = axis_arg.elts if isinstance(axis_arg, (ast.Tuple, ast.List)) else [axis_arg]
                    for el in elts:
                        if isinstance(el, ast.Constant) and isinstance(el.value, str):
                            consts.setdefault(f"Mesh axis {el.value!r}", el.value)
            self._axis_constants = consts
        return self._axis_constants


class Rule:
    """Base class; subclasses register with :func:`register` and implement
    ``check_file`` and/or ``check_project``."""

    id: str = ""
    name: str = ""
    description: str = ""

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        return []

    def check_project(self, project: Project) -> list[Finding]:
        return []


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    rule = cls()
    if not rule.id:
        raise ValueError(f"{cls.__name__} has no rule id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def load_rules() -> list[Rule]:
    """Import every rule module (registration side effect) and return the
    registry sorted by id."""
    from . import (  # noqa: F401
        rules_async_staging,
        rules_concurrency,
        rules_config,
        rules_contracts,
        rules_donation,
        rules_dtype,
        rules_imports,
        rules_logging,
        rules_prng_flow,
        rules_profiler,
        rules_recompile,
        rules_sockets,
        rules_spmd,
        rules_subprocess,
        rules_swallow,
        rules_threads,
        rules_time,
        rules_tracing,
    )

    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def collect_paths(paths: Iterable[str]) -> tuple[list[str], list[str]]:
    """Expand files/directories into (.py files, .yml files), stably sorted."""
    py: list[str] = []
    yml: list[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", ".git", ".pytest_cache"))
                for n in sorted(names):
                    full = os.path.join(root, n)
                    if n.endswith(".py"):
                        py.append(full)
                    elif n.endswith((".yml", ".yaml")):
                        yml.append(full)
        elif p.endswith(".py"):
            py.append(p)
        elif p.endswith((".yml", ".yaml")):
            yml.append(p)
        else:
            raise ValueError(f"not a directory, .py, or .yml path: {p}")
    return py, yml


def _load_project(paths: Iterable[str]) -> tuple[list[Finding], list[SourceFile], Project]:
    """Read and parse every linted path once: (syntax-error findings,
    parsed files, Project). Shared by :func:`run_lint` and
    :func:`check_suppressions` so the two stay byte-for-byte consistent."""
    py_paths, yml_paths = collect_paths(paths)
    syntax: list[Finding] = []
    files: list[SourceFile] = []
    for path in py_paths:
        with open(path, encoding="utf-8") as f:
            src = SourceFile(path, f.read())
        if src.parse_error is not None:
            e = src.parse_error
            syntax.append(
                Finding(path, e.lineno or 1, max((e.offset or 1) - 1, 0), "YAMT000", f"syntax error: {e.msg}")
            )
            continue
        files.append(src)
    return syntax, files, Project(files, yml_paths)


def _raw_findings(rules: Sequence[Rule], files: Sequence[SourceFile], project: Project) -> list[Finding]:
    """Every finding BEFORE suppression filtering (deduped)."""
    findings: list[Finding] = []
    for rule in rules:
        for src in files:
            findings.extend(rule.check_file(src, project))
        findings.extend(rule.check_project(project))
    # two roots reaching the same traced helper must not report it twice
    return sorted(set(findings))


def run_lint(paths: Iterable[str], select: set[str] | None = None) -> list[Finding]:
    """Lint ``paths`` (files or directories) and return sorted findings.

    ``select`` restricts to a set of rule ids (upper-case). Suppression
    comments are honored here, so callers only ever see live findings.
    """
    rules = load_rules()
    if select is not None:
        rules = [r for r in rules if r.id in select]
    findings, files, project = _load_project(paths)
    by_path = {src.path: src for src in files}

    def live(f: Finding) -> bool:
        # interprocedural rules may attribute a finding to a DIFFERENT file
        # than the one being checked (a traced helper in another module);
        # suppressions must be honored where the finding lands
        owner = by_path.get(f.path)
        return owner is None or not owner.suppressed(f)

    findings.extend(f for f in _raw_findings(rules, files, project) if live(f))
    return sorted(set(findings))


def check_suppressions(paths: Iterable[str], select: set[str] | None = None) -> list[Finding]:
    """Audit every suppression comment under ``paths``: a suppression whose
    rule no longer fires at its site is STALE — dead weight that silently
    swallows the rule if the hazard ever comes back at that line. Stale ones
    are reported as rule ``YAMT900`` findings (never themselves
    suppressible: the raw, pre-suppression findings are compared against).

    ``select`` limits which rules are re-run and judged; suppressions for
    rules outside the selection are left alone, not declared stale.
    """
    rules = load_rules()
    if select is not None:
        rules = [r for r in rules if r.id in select]
    judged = {r.id for r in rules}
    _, files, project = _load_project(paths)
    raw = _raw_findings(rules, files, project)
    at_line: dict[tuple[str, int], set[str]] = {}
    in_file: dict[str, set[str]] = {}
    for f in raw:
        at_line.setdefault((f.path, f.line), set()).add(f.rule)
        in_file.setdefault(f.path, set()).add(f.rule)

    out: list[Finding] = []
    for src in files:
        for lineno in sorted(src.line_suppressions):
            here = at_line.get((src.path, lineno), set())
            for r in sorted(src.line_suppressions[lineno]):
                if r == "ALL":
                    stale = not here
                elif r in judged:
                    stale = r not in here
                else:
                    continue
                if stale:
                    what = "no rule fires" if r == "ALL" else f"{r} no longer fires"
                    out.append(
                        Finding(
                            src.path, lineno, 0, "YAMT900",
                            f"stale suppression: {what} at this line; delete the "
                            "comment (it would silently swallow the rule if the "
                            "hazard returns)",
                        )
                    )
        for r in sorted(src.file_suppressions):
            if r == "ALL":
                stale = not in_file.get(src.path)
            elif r in judged:
                stale = r not in in_file.get(src.path, set())
            else:
                continue
            if stale:
                what = "no rule fires" if r == "ALL" else f"{r} never fires"
                out.append(
                    Finding(
                        src.path, src.file_suppression_lines.get(r, 1), 0, "YAMT900",
                        f"stale file-wide suppression: {what} anywhere in this "
                        "file; delete the disable-file comment",
                    )
                )
    return sorted(set(out))

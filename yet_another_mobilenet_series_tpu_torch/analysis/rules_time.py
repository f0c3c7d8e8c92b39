# Copy of yet_another_mobilenet_series_tpu/analysis/rules_time.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT017 — wall-clock durations: ``time.time()`` differenced in package
code.

``time.time()`` reads the WALL clock: NTP slews and steps it, operators and
VMs jump it, leap smears bend it. A timestamp read from it is fine — that is
what it is for — but the moment two readings are SUBTRACTED the result is a
duration measured with a ruler that changes length, and this repo's serving
stack is built out of exactly the code where that corrupts behavior:
timeouts, retry backoff, breaker cooldowns, hedge timers, poll schedules,
latency histograms. A backward NTP step can re-arm a cooldown forever; a
forward step fires every deadline at once. The sanctioned idiom is
``time.monotonic()`` (or ``time.perf_counter()`` for fine measurement) —
guaranteed non-decreasing, which is the property every duration needs.

Flagged (package code only — a directory holding ``__init__.py`` — like
YAMT007/011/012):

- a subtraction where either operand is a ``time.time()`` call or a local
  name assigned from one (``t0 = time.time(); ...; time.time() - t0``);
- comparisons against a wall-clock DEADLINE: a name assigned from
  ``time.time() + x`` (or augmented ``+=``) compared to ``time.time()``
  or to another tainted name (``while time.time() < deadline:``).

Deliberately NOT flagged:

- ``time.time()`` stored, logged, or shipped as a TIMESTAMP (the
  ``_PROC_START_UNIX`` identity field, provenance stamps, artifact rows):
  the hazard is subtraction, not the reading;
- ``time.monotonic()`` / ``time.perf_counter()`` arithmetic — the fix;
- cross-process comparisons of wall timestamps for EQUALITY/identity
  (restart detection compares ``start_unix`` values, never differences
  them into a duration).

Intentional wall-clock durations (rare: log-file age math against mtimes)
carry a same-line suppression with a WHY comment (docs/LINT.md house
rule)::

    age = time.time() - mtime  # yamt-lint: disable=YAMT017 — mtime IS wall clock
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

# the wall clock; datetime.now() family deliberately out of scope (never
# used for durations in this repo — revisit if it appears)
_WALL = ("time.time",)


def _is_wall_call(node: ast.AST, aliases: dict[str, str]) -> bool:
    return (
        isinstance(node, ast.Call)
        and not node.args
        and not node.keywords
        and qualified_name(node.func, aliases) in _WALL
    )


class _ScopeTaint(ast.NodeVisitor):
    """Per-scope (module / function) taint walk in source order.

    ``stamps`` are names holding a raw wall-clock reading; ``deadlines``
    are names holding wall-clock arithmetic (``time.time() + x``). Both
    taint through reassignment and augmented assignment; any other
    assignment to the name clears it (linear flow, the repo's idiom — the
    rules_async_staging trade-off: simple and predictable beats a full
    dataflow lattice for a lint gate)."""

    def __init__(self, src: SourceFile, rule_id: str):
        self.src = src
        self.rule_id = rule_id
        self.stamps: set[str] = set()
        self.deadlines: set[str] = set()
        self.findings: list[Finding] = []

    # -- taint sources -------------------------------------------------------

    def _tainted(self, node: ast.AST) -> bool:
        """Wall-clock VALUE: a direct call or a stamp/deadline name."""
        if _is_wall_call(node, self.src.aliases):
            return True
        return isinstance(node, ast.Name) and (
            node.id in self.stamps or node.id in self.deadlines
        )

    def _value_taint(self, value: ast.AST) -> str | None:
        """'stamp' / 'deadline' / None for one assigned value."""
        if _is_wall_call(value, self.src.aliases):
            return "stamp"
        if isinstance(value, ast.Name):
            if value.id in self.stamps:
                return "stamp"
            if value.id in self.deadlines:
                return "deadline"
            return None
        if isinstance(value, ast.BinOp) and isinstance(value.op, (ast.Add, ast.Sub)):
            # time.time() + x / stamp + x: a wall-clock deadline. (A Sub of
            # two tainted values is flagged as a duration where it OCCURS;
            # the assigned name still carries deadline taint so later
            # comparisons keep flagging.)
            if self._tainted(value.left) or self._tainted(value.right):
                return "deadline"
        return None

    def _assign_name(self, name: str, value: ast.AST) -> None:
        taint = self._value_taint(value)
        self.stamps.discard(name)
        self.deadlines.discard(name)
        if taint == "stamp":
            self.stamps.add(name)
        elif taint == "deadline":
            self.deadlines.add(name)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)  # flag expressions inside the value first
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                self._assign_name(tgt.id, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None and isinstance(node.target, ast.Name):
            self._assign_name(node.target.id, node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if isinstance(node.target, ast.Name) and isinstance(node.op, (ast.Add, ast.Sub)):
            name = node.target.id
            # deadline += gap keeps deadline taint; t0 += x stays a stamp-ish
            # wall value; adding a wall value to a clean name taints it
            if name in self.stamps or name in self.deadlines or self._tainted(node.value):
                self.stamps.discard(name)
                self.deadlines.add(name)

    # -- hazards -------------------------------------------------------------

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            self.src.path, node.lineno, node.col_offset, self.rule_id,
            f"{what}: time.time() is the WALL clock — NTP steps corrupt the "
            "difference; use time.monotonic() (or time.perf_counter()) for "
            "durations, deadlines, timeouts, and backoff",
        ))

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Sub) and (
            self._tainted(node.left) or self._tainted(node.right)
        ):
            self._flag(node, "wall-clock duration (subtraction of time.time() readings)")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        operands = [node.left, *node.comparators]
        ordered = any(isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE)) for op in node.ops)
        if ordered and sum(1 for o in operands if self._tainted(o)) >= 2:
            # time.time() < deadline / t_now >= t_deadline: an ordering
            # comparison of two wall readings IS a duration in disguise.
            # (Equality against a recorded start_unix is identity, not a
            # duration — not flagged.)
            self._flag(node, "wall-clock deadline comparison")
        self.generic_visit(node)

    # nested functions get their own scope walk (run by the rule), so stop
    # descending into them from the enclosing scope
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


@register
class WallClockDuration(Rule):
    id = "YAMT017"
    name = "wall-clock-duration"
    description = (
        "time.time() readings subtracted or deadline-compared in package "
        "code: wall-clock durations jump with NTP steps — use "
        "time.monotonic()/perf_counter() for timeouts, backoff, and latency"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        # package code only: a dir with __init__.py (scripts/tests exempt)
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []
        findings: list[Finding] = []
        scopes: list[ast.AST] = [src.tree]
        for node in src.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                scopes.append(node)
        for scope in scopes:
            walker = _ScopeTaint(src, self.id)
            body = scope.body if not isinstance(scope, ast.Lambda) else [ast.Expr(scope.body)]
            for stmt in body:
                walker.visit(stmt)
            findings.extend(walker.findings)
        return findings

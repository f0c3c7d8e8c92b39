# Copy of yet_another_mobilenet_series_tpu/analysis/rules_threads.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT011 — unguarded thread-target functions in package code.

A worker thread that dies on an unhandled exception dies SILENTLY: Python
prints a traceback to stderr (if anyone is watching) and the thread is gone,
while everything that depended on it — queued futures, the in-flight window,
the heartbeat the watchdog waits for — hangs forever. For the serving stack
this is the worst failure mode there is: a crashed collect/completion/accept
thread turns every client call into an unbounded wait (the motivating bug
class behind serve/batcher.py's ``_crash_guard`` and the drain timeout).

The rule: every function handed to ``threading.Thread(target=...)`` in
package code must carry a TOP-LEVEL exception guard — after the docstring
and trivial setup statements (assignments, imports, ``global``/``nonlocal``,
``pass``), the function's work must live inside a ``try:`` that has at least
one ``except`` handler. ``try/finally`` alone does not count: the exception
still escapes and kills the thread. What the handler DOES is the author's
policy (fail live futures, count ``serve.thread_crashes``, write stderr) —
the rule only insists the death is handled, not how.

Scope and resolution, matching the sibling rules' pragmatics:

- **package code only** (a directory holding ``__init__.py``) — standalone
  scripts and tests exempt, like YAMT007;
- targets resolved within the file: a plain name binds to the (nearest)
  ``def`` with that name in the module (including nested defs — the
  closure-worker idiom), ``self.<method>`` binds to the method on the
  enclosing class (or any class in the file defining it — the
  ``_start_threads`` override idiom);
- a ``lambda`` target is flagged outright (a lambda cannot contain a
  guard);
- targets the file cannot resolve (callables from other modules, factory
  results, ``functools.partial``) degrade to silence, not noise.

Guarded-delegation counts: a one-statement body that is itself the guard
(``try: self._loop_inner() except Exception: ...``) is the sanctioned
wrapper shape.
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

# setup statements allowed before/around the guarded try at function top
# level — bindings and declarations, not control flow doing real work
_SETUP_STMTS = (
    ast.Assign,
    ast.AnnAssign,
    ast.AugAssign,
    ast.Import,
    ast.ImportFrom,
    ast.Global,
    ast.Nonlocal,
    ast.Pass,
)


def _body_sans_docstring(fn: ast.FunctionDef) -> list[ast.stmt]:
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    return body


def _is_guarded(fn: ast.FunctionDef) -> bool:
    """Top-level guard check: every non-setup statement is a try-with-except
    (finally-only does not stop the exception), and at least one exists."""
    body = _body_sans_docstring(fn)
    guarded_tries = 0
    for st in body:
        if isinstance(st, ast.Try):
            if not st.handlers:
                return False  # try/finally alone: the exception still escapes
            guarded_tries += 1
        elif not isinstance(st, _SETUP_STMTS):
            return False
    return guarded_tries > 0


class _DefIndex:
    """Function/method definitions in one module, for target resolution."""

    def __init__(self, src: SourceFile):
        self.by_name: dict[str, list[ast.FunctionDef]] = {}
        self.methods: dict[tuple[str, str], ast.FunctionDef] = {}
        self.enclosing_class: dict[int, str] = {}
        for node in src.nodes:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.methods[(node.name, sub.name)] = sub
                for sub in src.subtree(node):
                    self.enclosing_class[id(sub)] = node.name
            if isinstance(node, ast.FunctionDef):
                self.by_name.setdefault(node.name, []).append(node)

    def resolve(self, target: ast.expr, call: ast.Call) -> list[ast.FunctionDef]:
        """Candidate defs for a Thread target expression; [] = opaque."""
        if isinstance(target, ast.Name):
            return self.by_name.get(target.id, [])
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            # the enclosing class first (the _start_threads shape), then any
            # class in the file defining that method (subclass overrides)
            cls = self.enclosing_class.get(id(call))
            hit = self.methods.get((cls, target.attr)) if cls else None
            if hit is not None:
                return [hit]
            return [m for (c, name), m in self.methods.items() if name == target.attr]
        return []


@register
class UnguardedThreadTarget(Rule):
    id = "YAMT011"
    name = "unguarded-thread-target"
    description = (
        "a threading.Thread target function in package code without a top-level "
        "try/except guard: an unhandled exception kills the thread SILENTLY and "
        "hangs everything waiting on it (futures, windows, heartbeats) — wrap the "
        "body in a guard that fails dependents loudly"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        # package code only: a dir with __init__.py (scripts/tests exempt)
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []
        index = None
        findings: list[Finding] = []
        flagged: set[int] = set()  # one finding per target def, however many Thread()s
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            q = qualified_name(node.func, src.aliases)
            if q != "threading.Thread":
                continue
            target = next((kw.value for kw in node.keywords if kw.arg == "target"), None)
            if target is None:
                continue
            if isinstance(target, ast.Lambda):
                findings.append(Finding(
                    src.path, target.lineno, target.col_offset, self.id,
                    "lambda thread target cannot carry an exception guard: "
                    "use a def with a top-level try/except",
                ))
                continue
            if index is None:
                index = _DefIndex(src)
            for fn in index.resolve(target, node):
                if id(fn) in flagged or _is_guarded(fn):
                    continue
                flagged.add(id(fn))
                findings.append(Finding(
                    src.path, fn.lineno, fn.col_offset, self.id,
                    f"thread target '{fn.name}' has no top-level try/except guard: "
                    "an unhandled exception kills the thread silently and hangs "
                    "its dependents (try/finally alone still lets it escape)",
                ))
        return findings

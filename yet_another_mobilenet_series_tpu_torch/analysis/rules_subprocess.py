# Copy of yet_another_mobilenet_series_tpu/analysis/rules_subprocess.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT015 — subprocess spawns without a bounded cleanup path.

A supervisor that spawns a child and then dies on the exception edge leaks
that child: the fleet supervisor (cli/fleet.py) spawning N serving replicas
is the motivating shape — a replica that outlives its supervisor keeps its
port, its memory, and (on a TPU host) the device lease, and nothing will
ever reap it. The complementary hazard is the UNBOUNDED blocking wait:
``subprocess.run``/``check_output`` with no ``timeout=`` turns a wedged
child into a wedged parent — the exact failure the serving stack's drain
timeouts exist to prevent.

Two checks, package code only (a directory holding ``__init__.py`` —
standalone scripts and tests exempt, like YAMT007/YAMT011):

1. **``subprocess.Popen(...)``** — the spawning code must own a bounded
   cleanup path. Sanctioned shapes:

   - the enclosing function contains an exception-edge cleanup: a
     ``.terminate()`` / ``.kill()`` / ``.send_signal()`` / bounded
     ``.wait(timeout=...)`` call inside an ``except`` handler or ``finally``
     body (calling a cleanup METHOD named ``kill``/``terminate`` counts —
     the wrapper-method idiom);
   - the handle is assigned to ``self.<attr>`` and some function in the
     file cleans that attribute up (``self._proc.terminate()`` in a
     ``stop()`` method — ownership handed to an object that can reap it).

   A bare ``.wait()`` with no timeout is NOT cleanup — it is the unbounded
   hang the rule exists to prevent.

2. **``subprocess.run`` / ``call`` / ``check_call`` / ``check_output``**
   without a ``timeout=`` keyword — an unbounded wait on the child.

Resolution stays file-local and silence-biased like the sibling rules:
handles that escape to other modules, factory results, and dynamically
built commands degrade to silence, not noise.
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_WAIT_FUNCS = ("subprocess.run", "subprocess.call", "subprocess.check_call",
               "subprocess.check_output")
_CLEANUP_ATTRS = {"terminate", "kill", "send_signal"}


def _is_cleanup_call(node: ast.AST) -> ast.expr | None:
    """The receiver expression when ``node`` is a bounded cleanup call
    (terminate/kill/send_signal, or wait WITH a timeout), else None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    if attr in _CLEANUP_ATTRS:
        return node.func.value
    if attr == "wait" and (node.args or any(kw.arg == "timeout" for kw in node.keywords)):
        return node.func.value
    return None


def _self_attr(node: ast.expr) -> str | None:
    """'attr' when ``node`` is exactly ``self.<attr>``, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Index(ast.NodeVisitor):
    """One pass over the module: Popen/run call sites with their enclosing
    function, functions owning an exception-edge cleanup, and the set of
    ``self.<attr>`` names cleaned up anywhere in the file."""

    def __init__(self, aliases: dict[str, str]):
        self._aliases = aliases
        self._fn_stack: list[ast.AST] = []
        self.popen_sites: list[tuple[ast.Call, ast.AST | None, str | None]] = []
        self.wait_sites: list[tuple[ast.Call, str]] = []
        self.edge_cleanup_fns: set[int] = set()  # id() of functions with one
        self.cleaned_self_attrs: set[str] = set()

    def _visit_fn(self, node):
        self._fn_stack.append(node)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_fn

    def visit_Try(self, node: ast.Try) -> None:
        edge = list(node.handlers) + list(node.finalbody)
        for part in edge:
            for sub in ast.walk(part):
                if _is_cleanup_call(sub) is not None and self._fn_stack:
                    self.edge_cleanup_fns.add(id(self._fn_stack[-1]))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # self.<attr> = subprocess.Popen(...): ownership lands on the object
        if (isinstance(node.value, ast.Call)
                and qualified_name(node.value.func, self._aliases) == "subprocess.Popen"
                and len(node.targets) == 1):
            attr = _self_attr(node.targets[0])
            if attr is not None:
                fn = self._fn_stack[-1] if self._fn_stack else None
                self.popen_sites.append((node.value, fn, attr))
                self.generic_visit(node)
                return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        recv = _is_cleanup_call(node)
        if recv is not None:
            attr = _self_attr(recv)
            if attr is not None:
                self.cleaned_self_attrs.add(attr)
        q = qualified_name(node.func, self._aliases)
        if q == "subprocess.Popen":
            if not any(site[0] is node for site in self.popen_sites):
                fn = self._fn_stack[-1] if self._fn_stack else None
                self.popen_sites.append((node, fn, None))
        elif q in _WAIT_FUNCS:
            if not any(kw.arg == "timeout" for kw in node.keywords):
                self.wait_sites.append((node, q))
        self.generic_visit(node)


@register
class UnboundedSubprocess(Rule):
    id = "YAMT015"
    name = "unbounded-subprocess"
    description = (
        "package code spawning a subprocess without a bounded wait/terminate path "
        "on the exception edge (a leaked child outlives its supervisor), or blocking "
        "on subprocess.run/check_* with no timeout (a wedged child wedges the parent)"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        # package code only: a dir with __init__.py (scripts/tests exempt)
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []
        if "subprocess" not in src.text:
            return []
        index = _Index(src.aliases)
        index.visit(src.tree)
        findings: list[Finding] = []
        for call, fn, self_attr in index.popen_sites:
            if fn is not None and id(fn) in index.edge_cleanup_fns:
                continue  # the spawner itself guards the exception edge
            if self_attr is not None and self_attr in index.cleaned_self_attrs:
                continue  # ownership handed to an object that can reap it
            where = f"in '{fn.name}'" if fn is not None else "at module level"
            findings.append(Finding(
                src.path, call.lineno, call.col_offset, self.id,
                f"subprocess.Popen {where} has no bounded cleanup path: add a "
                "terminate/kill/wait(timeout=...) on the exception edge (except/"
                "finally), or store the handle on an object whose stop path reaps it",
            ))
        for call, q in index.wait_sites:
            findings.append(Finding(
                src.path, call.lineno, call.col_offset, self.id,
                f"{q} without timeout= blocks the parent unboundedly on a wedged "
                "child: pass an explicit timeout",
            ))
        return findings

# Copy of yet_another_mobilenet_series_tpu/analysis/rules_sockets.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT018 — sockets without an explicit timeout in package code.

A socket with no timeout blocks FOREVER, and "forever" is exactly what a
partitioned network delivers: a blackholed peer accepts the handshake and
then says nothing, a half-open socket ACKs and never answers, a dead NAT
entry eats the response. Every one of those turns a blocking ``recv`` /
``connect`` into a wedged thread — the hang class serve/netchaos.py exists
to inject and the connect/read timeout split exists to contain. The
sanctioned idiom is an EXPLICIT bound on every socket the package opens:
the operator chose a budget, whatever it is.

Flagged (package code only — a directory holding ``__init__.py`` — like
YAMT007/011/012/017):

- ``socket.create_connection(addr)`` without a timeout (second positional
  argument or ``timeout=`` keyword);
- ``http.client.HTTPConnection(...)`` / ``HTTPSConnection(...)`` without a
  ``timeout=`` keyword (the stdlib default is ``None`` = block forever);
- ``socket.socket(...)`` whose result never receives a ``.settimeout(...)``
  (or ``.setblocking(False)`` — the non-blocking idiom) in the same scope:
  tracked through plain-name and ``self.attr`` assignments and ``with``
  targets, linear flow like the other scope-walk rules. An unassigned
  ``socket.socket()`` call (passed straight into something else) is flagged
  — the timeout cannot be proven from here.

Deliberately NOT flagged:

- an explicit ``timeout=None`` — the operator SAID forever, loudly; the
  rule polices silent defaults, not deliberate choices;
- sockets the stdlib hands back already bounded by their owner
  (``accept()`` results, ``ThreadingHTTPServer`` internals): only
  constructor calls are in scope;
- scripts/ and tests/ (not package code) — benches own their budgets.

Intentional unbounded sockets carry a same-line suppression with a WHY
comment (docs/LINT.md house rule)::

    s = socket.socket()  # yamt-lint: disable=YAMT018 — lifetime-bounded by X
"""

from __future__ import annotations

import ast
import os

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_CREATE_CONN = ("socket.create_connection",)
_HTTP_CONNS = ("http.client.HTTPConnection", "http.client.HTTPSConnection")
_SOCKET_CTOR = ("socket.socket",)


def _has_timeout_kw(node: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in node.keywords)


def _target_path(node: ast.AST) -> str | None:
    """'name' or 'self.attr' for assignment/with targets we can track."""
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)):
        return f"{node.value.id}.{node.attr}"
    return None


class _ScopeWalk(ast.NodeVisitor):
    """One scope's socket bookkeeping: socket.socket() calls assigned to
    trackable targets, and the settimeout/setblocking calls that sanction
    them. Linear flow, no dataflow lattice — the repo's scope-walk idiom."""

    def __init__(self, src: SourceFile, rule_id: str):
        self.src = src
        self.rule_id = rule_id
        self.findings: list[Finding] = []
        # target path -> the socket() Call node awaiting a settimeout
        self.pending: dict[str, ast.Call] = {}

    def _is_socket_ctor(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and qualified_name(node.func, self.src.aliases) in _SOCKET_CTOR)

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            self.src.path, node.lineno, node.col_offset, self.rule_id,
            f"{what}: a socket with no timeout blocks forever on a partitioned "
            "peer (blackhole / half-open) — set an explicit bound "
            "(settimeout(...), timeout=..., or a deliberate timeout=None)",
        ))

    # -- constructor sites ----------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        qn = qualified_name(node.func, self.src.aliases)
        if qn in _CREATE_CONN and len(node.args) < 2 and not _has_timeout_kw(node):
            self._flag(node, "socket.create_connection without a timeout")
        elif qn in _HTTP_CONNS and not _has_timeout_kw(node):
            self._flag(node, f"{qn.rsplit('.', 1)[1]} without timeout= "
                             "(the stdlib default blocks forever)")
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if not self._is_socket_ctor(node.value):
            return
        tracked = False
        for tgt in node.targets:
            path = _target_path(tgt)
            if path is not None:
                self.pending[path] = node.value
                tracked = True
        if not tracked:
            self._flag(node.value, "socket.socket() result untracked")

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if self._is_socket_ctor(item.context_expr):
                path = _target_path(item.optional_vars) if item.optional_vars else None
                if path is not None:
                    self.pending[path] = item.context_expr
                else:
                    self._flag(item.context_expr, "socket.socket() in a with block")
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        # <target>.settimeout(...) / <target>.setblocking(False) sanctions
        # the pending socket on that target
        call = node.value
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr in ("settimeout", "setblocking")):
            path = _target_path(call.func.value)
            if path is not None:
                self.pending.pop(path, None)
        self.generic_visit(node)

    # nested scopes run their own walk (the rule drives them), so stop here
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def flush(self) -> None:
        for call in self.pending.values():
            self._flag(call, "socket.socket() never given a timeout in this scope")


@register
class SocketWithoutTimeout(Rule):
    id = "YAMT018"
    name = "socket-without-timeout"
    description = (
        "socket.socket()/create_connection/HTTPConnection without an explicit "
        "timeout in package code: unbounded sockets wedge threads on "
        "partitioned peers — set an explicit bound"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        # package code only: a dir with __init__.py (scripts/tests exempt)
        if not os.path.exists(os.path.join(os.path.dirname(src.path), "__init__.py")):
            return []
        findings: list[Finding] = []
        scopes: list[ast.AST] = [src.tree]
        for node in src.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        for scope in scopes:
            walker = _ScopeWalk(src, self.id)
            for stmt in scope.body:
                walker.visit(stmt)
            walker.flush()
            findings.extend(walker.findings)
        return findings

"""YAMT008 — a CUDA graph's static output kept across a later replay: the
torch twin of the JAX package's donated-buffer reuse
(yet_another_mobilenet_series_tpu/analysis/rules_donation.py).

A captured graph writes its outputs into the same static tensors on every
``replay()``: a replay overwrites, in place, the buffer the previous replay
left there (as a donated jit argument is deleted by the call that donates
it). A reference bound to that output, or to a view of it, after one replay
and read after the next, reads the newer result, silently. The sanctioned
idioms copy out between replays: ``.clone()``, ``dst.copy_(out)``, or a
copy to the host.

Static outputs are the names bound in the capture region of a graph (the
body of ``with torch.cuda.graph(g)``, the statements after
``g.capture_begin()``) and the attributes of the object whose graph is
replayed (``exe.y`` beside ``exe.graph.replay()``). A name bound to one of
them, or to a view of it (a subscript, ``view``/``reshape``/``unbind``/
``narrow``/``detach``...), after a replay of that graph in the same
function is stale at the next replay; a read of it before it is rebound
flags. In a loop that replays a graph, appending one of its static outputs
(or a view) to a container flags too: every entry is the same buffer. Flow
is linear within one function, loop bodies walked twice (the YAMT014
shape).
"""

from __future__ import annotations

import ast

from .callgraph import _CAPTURE_CONTEXTS
from .core import Finding, Project, Rule, SourceFile, qualified_name, register
from .rules_async_staging import _iter_nodes

_VIEW_METHODS = {
    "view", "view_as", "reshape", "unbind", "narrow", "select", "squeeze", "unsqueeze", "flatten",
    "unflatten", "detach", "t", "permute", "transpose", "movedim", "chunk", "split", "expand",
    "expand_as", "as_strided", "diagonal",
}
_CONTAINER_METHODS = {"append", "extend", "insert", "add", "put", "put_nowait", "appendleft"}


def _graph_owner(g: ast.expr) -> str:
    """Owner key of graph ``g``: the object holding it (``exe`` of
    ``exe.graph``), or the graph itself."""
    return ast.dump(g.value if isinstance(g, ast.Attribute) else g)


def _replay_owner(call: ast.Call) -> str | None:
    """Owner key of ``<graph>.replay()``, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "replay" and not call.args:
        return _graph_owner(f.value)
    return None


def _captured_names(scope, aliases) -> dict[str, str]:
    """Names bound in the capture regions of ``scope`` -> owner key."""
    out: dict[str, str] = {}

    def bind(stmts, owner):
        for st in stmts:
            for n in ast.walk(st):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    out[n.id] = owner

    for node in ast.walk(scope):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for it in node.items:
                c = it.context_expr
                if isinstance(c, ast.Call) and qualified_name(c.func, aliases) in _CAPTURE_CONTEXTS and c.args:
                    bind(node.body, _graph_owner(c.args[0]))
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if not isinstance(block, list):
                continue
            for i, st in enumerate(block):
                if (
                    isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)
                    and isinstance(st.value.func, ast.Attribute) and st.value.func.attr == "capture_begin"
                ):
                    bind(block[i + 1:], _graph_owner(st.value.func.value))
    return out


class _Scanner:
    def __init__(self, rule, src: SourceFile, scope):
        self.rule, self.src = rule, src
        self.captured = _captured_names(scope, src.aliases)
        self.owners = {o for n in _iter_nodes(scope) if isinstance(n, ast.Call)
                       for o in [_replay_owner(n)] if o is not None}
        self.replayed: set[str] = set()
        self.aliases: dict[str, tuple[str, bool]] = {}  # name -> (owner, bound after a replay)
        self.stale: dict[str, int] = {}  # name -> line of the replay that overwrote it
        self.loop_owners: list[set[str]] = []
        self.out: dict[tuple, Finding] = {}

    def _output_of(self, expr: ast.expr) -> str | None:
        """Owner key when ``expr`` is a static output or a view of one."""
        while True:
            if isinstance(expr, ast.Subscript):
                expr = expr.value
            elif (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                  and expr.func.attr in _VIEW_METHODS):
                expr = expr.func.value
            else:
                break
        if isinstance(expr, ast.Name):
            if expr.id in self.aliases:
                return self.aliases[expr.id][0]
            return self.captured.get(expr.id)
        if isinstance(expr, ast.Attribute) and ast.dump(expr.value) in self.owners:
            return ast.dump(expr.value)
        return None

    def run(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            self._exprs(st.test if isinstance(st, ast.While) else st.iter)
            owners = {o for s in st.body for n in [s, *_iter_nodes(s)] if isinstance(n, ast.Call)
                      for o in [_replay_owner(n)] if o is not None}
            self.loop_owners.append(owners)
            for _ in range(2):
                for s in st.body:
                    self._stmt(s)
            self.loop_owners.pop()
            for s in st.orelse:
                self._stmt(s)
            return
        if isinstance(st, (ast.If, ast.Try, ast.With, ast.AsyncWith)):
            if isinstance(st, ast.If):
                self._exprs(st.test)
                blocks = [st.body, st.orelse]
            elif isinstance(st, ast.Try):
                blocks = [st.body, *[h.body for h in st.handlers], st.orelse, st.finalbody]
            else:
                for item in st.items:
                    self._exprs(item.context_expr)
                blocks = [st.body]
            for block in blocks:
                for s in block:
                    self._stmt(s)
            return
        if isinstance(st, ast.Assign):
            self._exprs(st.value)
            owner = self._output_of(st.value)
            for t in st.targets:
                self._bind(t, owner)
                if isinstance(t, ast.Subscript) and owner is not None:
                    self._kept(st.value, owner)
            return
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                self._exprs(st.value)
            if isinstance(st.target, ast.Name):
                self._bind(st.target, None)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._exprs(child)

    def _bind(self, target, owner):
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                self.stale.pop(n.id, None)
                if owner is not None:
                    self.aliases[n.id] = (owner, owner in self.replayed)
                else:
                    self.aliases.pop(n.id, None)

    def _kept(self, expr, owner):
        if any(owner in owners for owners in self.loop_owners):
            f = Finding(
                self.src.path, expr.lineno, expr.col_offset, self.rule.id,
                "a CUDA graph's static output kept in a container inside the loop that replays "
                "the graph: every entry is the same buffer, overwritten by each replay; keep "
                "a .clone()",
            )
            self.out.setdefault((f.line, f.col), f)

    def _exprs(self, expr):
        if expr is None:
            return
        for node in [expr, *_iter_nodes(expr)]:
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) and node.id in self.stale:
                f = Finding(
                    self.src.path, node.lineno, node.col_offset, self.rule.id,
                    f"'{node.id}' is a CUDA graph's static output (or a view of it) read after the "
                    f"replay at line {self.stale[node.id]} overwrote it in place; .clone() it "
                    "before the next replay",
                )
                self.out.setdefault((f.line, f.col), f)
            elif isinstance(node, ast.Call):
                owner = _replay_owner(node)
                if owner is not None:
                    for name, (o, held) in self.aliases.items():
                        if o == owner and held:
                            self.stale[name] = node.lineno
                    self.replayed.add(owner)
                elif (isinstance(node.func, ast.Attribute) and node.func.attr in _CONTAINER_METHODS
                      and node.args):
                    for arg in node.args:
                        o = self._output_of(arg)
                        if o is not None:
                            self._kept(arg, o)


@register
class StaticOutputAfterReplay(Rule):
    id = "YAMT008"
    name = "static-output-after-replay"
    description = (
        "a CUDA graph's static output (or a view of it) read after a later replay() of the "
        "same graph with no copy or .clone() between: the replay overwrote it in place"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        scopes = [src.tree] + [n for n in src.nodes if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            scanner = _Scanner(self, src, scope)
            if not scanner.owners:
                continue
            scanner.run(scope.body)
            findings.extend(scanner.out.values())
        return findings

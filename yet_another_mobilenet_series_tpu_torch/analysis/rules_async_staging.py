"""YAMT014 — a host tensor touched while a ``non_blocking`` copy still owns
it: the torch twin of the JAX package's async-staging rule
(yet_another_mobilenet_series_tpu/analysis/rules_async_staging.py).

A ``non_blocking=True`` copy from or into pinned host memory returns before
the card has moved the bytes: that is the point, the copy overlaps the
host's next work. Until an event or stream sync says the copy is done, the
host buffer belongs to the copy.

- H2D: a host tensor handed to ``dst.copy_(src, non_blocking=True)`` or
  ``src.to(device, non_blocking=True)`` / ``src.cuda(non_blocking=True)``
  and then WRITTEN (a subscript store, an in-place method such as
  ``copy_``/``fill_``/``zero_``/``add_``, ``+=``) races the transfer: the card
  may read torn data.
- D2H: a pinned host tensor (bound in the same function from
  ``torch.empty/zeros/...(..., pin_memory=True)`` or ``.pin_memory()``)
  filled by ``host.copy_(dev, non_blocking=True)`` (or a slice of it) and
  then READ (a subscript load, a method call other than another copy into
  it, ``float/int/bool(host)``, ``numpy``/``torch`` functions of it) may read
  bytes the copy has not written yet.

A host sync clears every pending copy: ``.synchronize()`` on anything
(``torch.cuda.synchronize``, an Event, a Stream). ``Event.record`` and
``Stream.wait_event`` are device-side and clear nothing. Handing the buffer
on (``return host, done``, storing it, passing it to a call) is not a read:
the receiver waits on the event it is handed with it, which is the port's
idiom (serve/engine.py ``_launch``, ckpt/manager.py's snapshot). Flow is
the source rule's: linear within one function, loop bodies walked twice,
branches not forked.
"""

from __future__ import annotations

import ast

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_PINNED_ALLOCS = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like", "ones_like", "full_like",
                  "empty_strided"}
_NOT_READS = {"copy_", "record_stream", "is_pinned", "size", "dim", "numel", "element_size", "data_ptr"}
_READ_FUNCS = ("numpy.", "torch.")


def _iter_nodes(node: ast.AST):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        yield child
        yield from _iter_nodes(child)


def _chain(expr: ast.expr) -> str | None:
    """``a.b.c`` of a Name/Attribute chain (imports not resolved), else None."""
    return qualified_name(expr, {})


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) and kw.value.value is True
               for kw in call.keywords)


class _Scanner:
    def __init__(self, rule, src: SourceFile):
        self.rule, self.src = rule, src
        self.parents = src.parents
        self.pinned: set[str] = set()
        self.h2d: dict[str, int] = {}  # host buffer -> line of the copy reading it
        self.d2h: dict[str, int] = {}  # pinned host buffer -> line of the copy filling it
        self.out: dict[tuple, Finding] = {}

    def run(self, stmts):
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            self._exprs(st.test if isinstance(st, ast.While) else st.iter)
            for _ in range(2):
                for s in st.body:
                    self._stmt(s)
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
            pinned = self._is_pinned_alloc(st.value)
            for t in st.targets:
                self._store(t, pinned)
            return
        if isinstance(st, ast.AugAssign):
            self._exprs(st.value)
            chain = _chain(st.target) if not isinstance(st.target, ast.Subscript) else _chain(st.target.value)
            if chain is not None:
                self._write(chain, st.target)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._exprs(child)

    def _is_pinned_alloc(self, value) -> bool:
        if not isinstance(value, ast.Call):
            return False
        if isinstance(value.func, ast.Attribute) and value.func.attr == "pin_memory":
            return True
        q = qualified_name(value.func, self.src.aliases) or ""
        return q.startswith("torch.") and q.rsplit(".", 1)[-1] in _PINNED_ALLOCS and any(
            kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant) and kw.value.value is True
            for kw in value.keywords)

    def _store(self, target, pinned=False):
        if isinstance(target, ast.Subscript):
            chain = _chain(target.value)
            if chain is not None:
                self._write(chain, target)
            return
        chain = _chain(target)
        if chain is not None:
            for table in (self.h2d, self.d2h):
                table.pop(chain, None)
            if pinned:
                self.pinned.add(chain)
            else:
                self.pinned.discard(chain)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._store(el)

    def _write(self, chain, node):
        line = self.h2d.get(chain)
        if line is not None:
            self._flag(node, f"'{chain}' written after a non_blocking copy read it (line {line}) with no "
                             "sync between: the card may still be reading it, and sees torn data — "
                             "synchronize the copy's event before rewriting the buffer")

    def _read(self, chain, node):
        line = self.d2h.get(chain)
        if line is not None:
            self._flag(node, f"pinned '{chain}' read after a non_blocking copy into it (line {line}) with "
                             "no sync between: the bytes may not have landed — synchronize the copy's "
                             "event first")

    def _flag(self, node, msg):
        f = Finding(self.src.path, node.lineno, node.col_offset, self.rule.id, msg)
        self.out.setdefault((f.line, f.col), f)

    def _exprs(self, expr):
        if expr is None:
            return
        for node in [expr, *_iter_nodes(expr)]:
            if isinstance(node, ast.Call):
                self._call(node)
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
                chain = _chain(node.value)
                parent = self.parents.get(id(node))
                if chain is not None and not (isinstance(parent, ast.Attribute) and parent.attr == "copy_"):
                    self._read(chain, node)

    def _call(self, call):
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "synchronize":
            self.h2d.clear()
            self.d2h.clear()
            return
        if isinstance(f, ast.Attribute):
            recv = f.value
            chain = _chain(recv)
            base = _chain(recv.value) if isinstance(recv, ast.Subscript) else chain
            if f.attr == "copy_" and call.args:
                if _non_blocking(call):
                    src_chain = _chain(call.args[0])
                    if src_chain is not None:
                        self.h2d[src_chain] = call.lineno
                    if base is not None and base in self.pinned:
                        self.d2h[base] = call.lineno
                if base is not None:
                    self._write(base, call)
                return
            if f.attr in ("to", "cuda") and _non_blocking(call) and chain is not None:
                self.h2d[chain] = call.lineno
                return
            if chain is not None and f.attr.endswith("_") and not f.attr.startswith("_"):
                self._write(chain, call)
            if chain is not None and f.attr not in _NOT_READS:
                self._read(chain, call)
            return
        if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and len(call.args) == 1:
            chain = _chain(call.args[0])
            if chain is not None:
                self._read(chain, call)
            return
        q = qualified_name(f, self.src.aliases) or ""
        if q.startswith(_READ_FUNCS):
            for arg in call.args:
                chain = _chain(arg)
                if chain is not None:
                    if q == "numpy.copyto" and arg is call.args[0]:
                        self._write(chain, call)
                    else:
                        self._read(chain, call)


@register
class AsyncCopyHazard(Rule):
    id = "YAMT014"
    name = "non-blocking-copy-hazard"
    description = (
        "a host tensor written after a non_blocking H2D copy read it, or a pinned host tensor "
        "read after a non_blocking D2H copy into it, with no event or stream sync between"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        scopes = [src.tree] + [n for n in src.nodes if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            scanner = _Scanner(self, src)
            scanner.run(scope.body)
            findings.extend(scanner.out.values())
        return findings

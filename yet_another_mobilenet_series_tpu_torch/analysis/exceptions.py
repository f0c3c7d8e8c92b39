# Copy of yet_another_mobilenet_series_tpu/analysis/exceptions.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Escaping-exception-set summaries over the call graph (YAMT022's model).

For any function the rules ask about, :class:`ExceptionModel` computes the
set of exception TYPES that can escape a call to it, to fixpoint over the
resolved call graph (callgraph.py):

- ``raise X`` / ``raise X(...)`` / ``raise X from Y`` contribute the
  resolved class of ``X`` — a project :class:`~.symbols.ClassInfo` (keyed by
  its dotted qualname) or an external dotted name (``"ValueError"``,
  ``"json.JSONDecodeError"``);
- a bare ``raise`` (and ``raise e`` of the handler-bound name) re-raises the
  set the enclosing ``except`` actually absorbed;
- ``try/except`` narrows by the symbol-table class hierarchy: an exception
  passes a handler only when it is PROVABLY not a subclass of any caught
  type (project bases are walked structurally; external-vs-external falls
  back to the real builtin exception hierarchy, and anything still unknown
  absorbs — toward silence, never a guess);
- a bare/broad handler (``except:`` / ``except Exception``) absorbs
  everything, unless its body re-raises;
- calls add the callee's current escape set at the call site (so a raise
  three frames down still narrows through every ``try`` above it); opaque
  call targets, futures, and computed raise expressions contribute NOTHING.

Under-approximation is the contract: every degradation is toward a smaller
escape set, so a rule that flags an escaping type can trust it. The model is
demand-driven — only the call-closure of the functions a rule asks about is
walked, and each closure runs its own bounded fixpoint (the package-wide
sweep touches a few hundred functions, not every def in the tree).
"""

from __future__ import annotations

import ast
import builtins
from typing import Optional

from .core import qualified_name
from .symbols import ClassInfo

_MAX_ROUNDS = 12
_BROAD = ("Exception", "BaseException")

# the sentinel key for "a broad handler caught this": only used internally
# while narrowing, never escapes into a summary


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _builtin_exc(name: str):
    """The real builtin exception class behind a bare name, or None."""
    obj = getattr(builtins, _last(name), None)
    if isinstance(obj, type) and issubclass(obj, BaseException):
        return obj
    return None


class ExceptionModel:
    """Demand-driven escape-set summaries for one Project."""

    def __init__(self, project):
        self.project = project
        self.symbols = project.symbols
        self.cg = project.callgraph
        project.summaries  # converge returns-resolution before resolving calls
        self.classes: dict[str, ClassInfo] = {}  # key -> project class
        self._escapes: dict[str, frozenset[str]] = {}
        self._done: set[str] = set()
        self._callees: dict[str, list[str]] = {}  # qualname -> callee qualnames
        self._callee_at: dict[int, Optional[str]] = {}  # id(Call) -> qualname
        self._ancestors: dict[str, tuple[set[str], set[str], bool]] = {}

    # -- public -------------------------------------------------------------

    def escape_set(self, qualname: str) -> frozenset[str]:
        """Exception-type keys that can escape ``qualname`` (project classes
        by dotted qualname — see :attr:`classes` — externals by dotted
        name). Unknown functions escape nothing."""
        if qualname not in self._done:
            self._converge(qualname)
        return self._escapes.get(qualname, frozenset())

    def is_subtype(self, key: str, base: str) -> Optional[bool]:
        """True/False when the hierarchy answers, None when it cannot
        (external classes we never see the body of)."""
        return self._subtype(key, base)

    # -- fixpoint -----------------------------------------------------------

    def _converge(self, qualname: str) -> None:
        sub: list[str] = []
        seen: set[str] = set()
        stack = [qualname]
        while stack:
            q = stack.pop()
            if q in seen or q in self._done:
                continue
            seen.add(q)
            if q not in self.project.summaries:
                continue
            sub.append(q)
            stack.extend(self._callee_list(q))
        for _ in range(_MAX_ROUNDS):
            changed = False
            for q in sub:
                new = self._scan(q)
                if new != self._escapes.get(q, frozenset()):
                    self._escapes[q] = new
                    changed = True
            if not changed:
                break
        self._done.update(seen)

    def _callee_list(self, qualname: str) -> list[str]:
        got = self._callees.get(qualname)
        if got is not None:
            return got
        fi = self.project.summaries[qualname].fi
        src = fi.module.src
        out: list[str] = []
        for node in src.subtree(fi.node):
            if not isinstance(node, ast.Call):
                continue
            callee = self._resolve_callee(src, node)
            self._callee_at[id(node)] = callee
            if callee is not None:
                out.append(callee)
        self._callees[qualname] = out
        return out

    def _resolve_callee(self, src, call: ast.Call) -> Optional[str]:
        scope = self.cg.enclosing_scope(src, call)
        t = self.cg.resolve_call(src, call, scope)
        if t is None:
            return None
        if t.kind == "jit" and t.inner is not None:
            t = t.inner
        if t.kind == "function" and t.func is not None:
            return t.func.qualname
        if t.kind == "class" and "__init__" in t.cls.methods:
            return t.cls.methods["__init__"].qualname
        return None

    # -- one function's walk ------------------------------------------------

    def _scan(self, qualname: str) -> frozenset[str]:
        fi = self.project.summaries[qualname].fi
        self._callee_list(qualname)  # ensure call sites are resolved
        src = fi.module.src
        return frozenset(self._block(src, fi.node.body, frozenset(), {}))

    def _block(self, src, stmts, caught: frozenset[str],
               named: dict[str, frozenset[str]]) -> set[str]:
        out: set[str] = set()
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested defs escape only when called
            if isinstance(st, ast.Raise):
                out |= self._calls_in(st)
                out |= self._raised(src, st, caught, named)
            elif isinstance(st, ast.Try):
                out |= self._try(src, st, caught, named)
            else:
                out |= self._calls_in(st, skip_blocks=True)
                for block in ("body", "orelse", "finalbody"):
                    out |= self._block(src, getattr(st, block, []), caught, named)
                for case in getattr(st, "cases", []):
                    out |= self._block(src, case.body, caught, named)
        return out

    def _try(self, src, st: ast.Try, caught, named) -> set[str]:
        body = self._block(src, st.body, caught, named)
        out: set[str] = set()
        remaining = set(body)
        for h in st.handlers:
            catch = self._catch_keys(src, h)
            if catch is None:  # bare/broad/unresolvable: absorbs everything
                absorbed, remaining = remaining, set()
            else:
                absorbed = {e for e in remaining if not self._passes(e, catch)}
                remaining -= absorbed
            h_named = dict(named)
            if h.name:
                h_named[h.name] = frozenset(absorbed)
            out |= self._block(src, h.body, frozenset(absorbed), h_named)
        out |= remaining
        # else-block exceptions bypass this try's handlers (Python semantics)
        out |= self._block(src, st.orelse, caught, named)
        out |= self._block(src, st.finalbody, caught, named)
        return out

    def _raised(self, src, st: ast.Raise, caught, named) -> set[str]:
        if st.exc is None:  # bare raise: the handler's absorbed set
            return set(caught)
        expr = st.exc
        if isinstance(expr, ast.Name) and expr.id in named:
            return set(named[expr.id])  # `except X as e: ... raise e`
        if isinstance(expr, ast.Call):
            f = expr.func
            # `raise e.with_traceback(...)` re-raises the handler binding
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "with_traceback"
                and isinstance(f.value, ast.Name)
                and f.value.id in named
            ):
                return set(named[f.value.id])
            expr = f
        key = self._class_key(src, expr)
        return {key} if key is not None else set()

    def _calls_in(self, node, skip_blocks: bool = False) -> set[str]:
        """Callee escape contributions of every call under ``node`` (nested
        defs excluded; with ``skip_blocks`` the statement lists of compound
        statements are excluded too — the caller recurses into those)."""
        out: set[str] = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(n, ast.Call):
                callee = self._callee_at.get(id(n))
                if callee is not None:
                    out |= self._escapes.get(callee, frozenset())
            for name, field in ast.iter_fields(n):
                if skip_blocks and name in ("body", "orelse", "finalbody", "handlers", "cases"):
                    continue
                if isinstance(field, ast.AST):
                    stack.append(field)
                elif isinstance(field, list):
                    stack.extend(x for x in field if isinstance(x, ast.AST))
        return out

    # -- type keys and hierarchy --------------------------------------------

    def _class_key(self, src, expr: ast.expr) -> Optional[str]:
        t = self.cg.resolve_expr(src, expr, self.cg.enclosing_scope(src, expr))
        if t is not None and t.kind == "class":
            self.classes[t.cls.qualname] = t.cls
            return t.cls.qualname
        q = qualified_name(expr, src.aliases)
        # external dotted name — but only a CamelCase tail reads as a CLASS
        # reference; a lowercase name is a variable holding a computed
        # exception (``raise mk()``), which must degrade to silence
        if q is not None and _last(q)[:1].isupper():
            return q
        return None

    def _catch_keys(self, src, h: ast.ExceptHandler) -> Optional[list[str]]:
        """Caught-type keys of one handler; None means "absorbs everything"
        (bare except, a broad type, or anything we cannot resolve)."""
        if h.type is None:
            return None
        elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        keys: list[str] = []
        for e in elts:
            key = self._class_key(src, e)
            if key is None or _last(key) in _BROAD:
                return None
            keys.append(key)
        return keys

    def _passes(self, exc: str, catch: list[str]) -> bool:
        """True only when ``exc`` PROVABLY escapes every caught type; an
        unknown relationship absorbs (under-approximation toward silence)."""
        return all(self._subtype(exc, c) is False for c in catch)

    def _subtype(self, exc: str, base: str) -> Optional[bool]:
        if _last(base) in _BROAD:
            return True
        if exc == base:
            return True
        if exc in self.classes:
            proj, ext, opaque = self._ancestry(exc)
            if base in self.classes:
                return True if base in proj else (None if opaque else False)
            b = _builtin_exc(base)
            for name in ext:
                if _last(name) == _last(base):
                    return True
                eb = _builtin_exc(name)
                if b is not None and eb is not None and issubclass(eb, b):
                    return True
            return None if opaque else False
        if base in self.classes:
            return False  # an external class cannot subclass a project one
        if _last(exc) == _last(base):
            return True
        e, b = _builtin_exc(exc), _builtin_exc(base)
        if e is not None and b is not None:
            return issubclass(e, b)
        return None  # two externals whose bodies we never see

    def _ancestry(self, key: str) -> tuple[set[str], set[str], bool]:
        """(project-ancestor keys, external-ancestor names, opaque-base?)
        of a project class — the class itself included in the first set."""
        got = self._ancestors.get(key)
        if got is not None:
            return got
        proj: set[str] = set()
        ext: set[str] = set()
        opaque = False
        self._ancestors[key] = (proj, ext, opaque)  # cycle guard
        stack = [key]
        while stack:
            k = stack.pop()
            if k in proj:
                continue
            proj.add(k)
            ci = self.classes.get(k)
            if ci is None:
                continue
            for b in ci.node.bases:
                bkey = self._class_key(ci.module.src, b)
                if bkey is None:
                    opaque = True
                elif bkey in self.classes:
                    stack.append(bkey)
                else:
                    ext.add(bkey)
        self._ancestors[key] = (proj, ext, opaque)
        return proj, ext, opaque

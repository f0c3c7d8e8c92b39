# Copy of yet_another_mobilenet_series_tpu/analysis/callgraph.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Intra-package call resolution on top of the symbol table (symbols.py).

Resolves, purely from the AST, what a call expression refers to:

- direct calls to module functions, including through import aliases
  (``from .core import helper as h`` / ``eng.helper(...)``);
- method calls on locally-constructed instances (``trainer = Trainer(...);
  trainer.train_step(...)``) and on parameters annotated with a project
  class, plus ``self.method(...)`` / ``self._fn(...)`` inside methods
  (``self._fn = ...`` assignments are read from the class body);
- ``jax.jit``/``jax.pmap``/``functools.partial(jax.jit, ...)`` wrappers,
  carrying their static ``donate_argnums``/``static_argnums``/
  ``static_argnames`` and the wrapped callable, and
  ``torch.cuda.make_graphed_callables(f, ...)``, whose ``f`` runs under
  CUDA-graph capture;
- call-result bindings through function summaries (``step =
  make_train_step(...)`` resolves to the inner ``step_fn`` that
  ``make_train_step`` returns — summaries.py computes ``returns``);
- values threaded through LITERAL containers and same-length tuple
  unpacking (``fwd, bwd = make_fwd, make_bwd`` then ``fwd(...)``;
  ``steps = (init, apply); steps[1](...)``; constant-keyed dict literals) —
  the container must be a literal visible in the scope chain, and the
  index/key a constant.

Anything else — ``getattr`` chains, containers built by calls or mutated
after construction, computed indices — degrades to *opaque* (``None``),
never a crash or a guess: every interprocedural rule must stay sound when
resolution gives up.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .core import qualified_name
from .symbols import ClassInfo, FunctionInfo, ModuleInfo

_JIT_WRAPPERS = {"jax.jit", "jax.pmap", "torch.cuda.make_graphed_callables"}
_PARTIAL = {"functools.partial", "partial"}
# torch's "this code runs under capture": the body of a ``with`` over these,
# the code between a graph's ``capture_begin()`` and ``capture_end()``, the
# callables given to make_graphed_callables, and the forward/backward of an
# autograd.Function subclass. Their Python runs once, at capture; a replay
# runs only the kernels they launched.
_CAPTURE_CONTEXTS = {"torch.cuda.graph"}
_GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables"}
_CAPTURE_BASES = {"torch.autograd.Function"}
_CAPTURE_METHODS = ("forward", "backward")


@dataclasses.dataclass
class CaptureRoot:
    """A region whose Python runs under capture: ``nodes`` (statements or a
    def) of ``src``, inside the def ``scope`` (None = module level)."""

    label: str
    src: object
    scope: Optional[ast.AST]
    nodes: list


@dataclasses.dataclass
class Target:
    """What an expression resolves to. ``kind`` is one of ``function``
    (a project def; ``bound`` when reached through an instance), ``class``
    (a project class, i.e. a constructor), ``instance`` (a value known to be
    an instance of a project class), ``module``, or ``jit`` (a
    jax.jit/jax.pmap-wrapped callable with its static call contract)."""

    kind: str
    func: Optional[FunctionInfo] = None
    cls: Optional[ClassInfo] = None
    mod: Optional[ModuleInfo] = None
    inner: Optional["Target"] = None  # kind == 'jit': the wrapped callable
    donate: tuple[int, ...] = ()
    static_nums: tuple[int, ...] = ()
    static_names: tuple[str, ...] = ()
    bound: bool = False


def _int_tuple(node: ast.expr) -> tuple[int, ...] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)) and all(
        isinstance(e, ast.Constant) and isinstance(e.value, int) for e in node.elts
    ):
        return tuple(e.value for e in node.elts)
    return None


def _str_tuple(node: ast.expr) -> tuple[str, ...] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)) and all(
        isinstance(e, ast.Constant) and isinstance(e.value, str) for e in node.elts
    ):
        return tuple(e.value for e in node.elts)
    return None


class CallGraph:
    """Lazy resolver over one :class:`core.Project`. Scope environments are
    cached; target resolution is recomputed on demand (it may sharpen as the
    summary fixpoint fills in)."""

    def __init__(self, project):
        self.project = project
        self.symbols = project.symbols
        self._envs: dict = {}
        self._cache: dict[tuple, Optional[Target]] = {}
        self._summary_reads = 0

    # -- scope bookkeeping --------------------------------------------------

    def enclosing_scope(self, src, node: ast.AST):
        """Nearest enclosing FunctionDef/AsyncFunctionDef of ``node`` in
        ``src`` (None = module scope) — served from the SourceFile's
        one-time DFS index rather than a per-file recursion here."""
        return src.scopes.get(id(node))

    def _scope_chain(self, src, scope_node):
        chain = []
        node = scope_node
        while node is not None:
            chain.append(node)
            fi = self.symbols.by_node.get(id(node))
            node = fi.parent.node if fi is not None and fi.parent is not None else None
        return chain

    def _env(self, src, scope_node):
        key = (src.path, id(scope_node) if scope_node is not None else None)
        env = self._envs.get(key)
        if env is not None:
            return env
        env = {}
        self._envs[key] = env  # registered first: annotation resolution below re-enters
        raw = src.tree.body if scope_node is None else scope_node.body
        body = raw if isinstance(raw, list) else []  # a Lambda's body is an expression
        if scope_node is not None and not isinstance(scope_node, ast.Lambda):
            fi = self.symbols.by_node.get(id(scope_node))
            if fi is not None and fi.cls is not None and fi.pos_params:
                env[fi.pos_params[0]] = ("instance", fi.cls)
            for arg in (
                *scope_node.args.posonlyargs, *scope_node.args.args, *scope_node.args.kwonlyargs
            ):
                if arg.annotation is not None:
                    # annotations name module-level classes; resolving them
                    # against the (still-building) local scope would recurse
                    t = self.resolve_expr(src, arg.annotation, None)
                    if t is not None and t.kind == "class":
                        env.setdefault(arg.arg, ("instance", t.cls))
        self._fill_env(env, body, src)
        return env

    def _fill_env(self, env, stmts, src):
        """Shallow binding prepass over one scope: nested defs/classes bind
        their names; every other assignment target binds its RHS (or opaque
        when unresolvable/conflicting) so inner scopes can't leak through."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self.symbols.by_node.get(id(st))
                self._bind(env, st.name, ("def", fi) if fi is not None else ("opaque", None))
            elif isinstance(st, ast.ClassDef):
                self._bind(env, st.name, ("opaque", None))  # local classes: rare, skip
            elif isinstance(st, ast.Assign) and len(st.targets) == 1 and isinstance(st.targets[0], ast.Name):
                self._bind(env, st.targets[0].id, ("expr", st.value))
            elif (
                isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], (ast.Tuple, ast.List))
                and isinstance(st.value, (ast.Tuple, ast.List))
                and len(st.targets[0].elts) == len(st.value.elts)
                and not any(isinstance(e, ast.Starred) for e in st.value.elts)
            ):
                # same-length literal tuple unpack: elementwise bindings
                for tgt, val in zip(st.targets[0].elts, st.value.elts):
                    if isinstance(tgt, ast.Name):
                        self._bind(env, tgt.id, ("expr", val))
                    else:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                self._bind(env, n.id, ("opaque", None))
            else:
                for t in self._assigned_names(st):
                    self._bind(env, t, ("opaque", None))
                for block in ("body", "orelse", "finalbody"):
                    self._fill_env(env, getattr(st, block, []), src)
                for h in getattr(st, "handlers", []):
                    self._fill_env(env, h.body, src)

    @staticmethod
    def _assigned_names(st) -> list[str]:
        out = []

        def targets(t):
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    targets(el)
            elif isinstance(t, ast.Starred):
                targets(t.value)

        if isinstance(st, ast.Assign):
            for t in st.targets:
                targets(t)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets(st.target)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            targets(st.target)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                if item.optional_vars is not None:
                    targets(item.optional_vars)
        return out

    def _bind(self, env, name, binding):
        if name in env and env[name] != binding:
            prev = env[name]
            same = (
                prev[0] == binding[0] == "expr"
                and ast.dump(prev[1]) == ast.dump(binding[1])
            )
            if not same:
                env[name] = ("opaque", None)
            return
        env[name] = binding

    # -- resolution ---------------------------------------------------------

    def resolve_call(self, src, call: ast.Call, scope_node=None) -> Optional[Target]:
        return self.resolve_expr(src, call.func, scope_node)

    def resolve_expr(self, src, expr: ast.expr, scope_node=None, _guard=None) -> Optional[Target]:
        """Resolve an expression to a :class:`Target`, or None (opaque)."""
        if _guard is None:
            # memoize top-level resolutions, but only once the summaries
            # fixpoint has converged: mid-fixpoint results sharpen as
            # ``returns`` entries land, and caching them would freeze the
            # weaker answer (AST node ids are stable: the Project owns every
            # tree for its whole lifetime)
            key = (id(expr), id(scope_node) if scope_node is not None else None)
            if key in self._cache:
                return self._cache[key]
            before = self._summary_reads
            result = self.resolve_expr(src, expr, scope_node, set())
            # a resolution whose descent never consulted a summary's
            # ``returns`` depends only on static structure (symbols, env
            # bindings) and cannot sharpen — cache it mid-fixpoint too
            if getattr(self.project, "_summaries_done", False) or self._summary_reads == before:
                self._cache[key] = result
            return result
        if id(expr) in _guard:
            return None
        _guard.add(id(expr))

        if isinstance(expr, ast.Name):
            return self._resolve_name(src, expr.id, scope_node, _guard)
        if isinstance(expr, ast.Attribute):
            base = self.resolve_expr(src, expr.value, scope_node, _guard)
            if base is None:
                return None
            return self._member(base, expr.attr, _guard)
        if isinstance(expr, ast.Call):
            return self._resolve_call_result(src, expr, scope_node, _guard)
        if isinstance(expr, ast.Subscript):
            return self._resolve_subscript(src, expr, scope_node, _guard)
        return None

    def _resolve_subscript(self, src, sub: ast.Subscript, scope_node, _guard):
        """``container[const]`` where the container chases (through Name
        bindings) to a literal Tuple/List/Dict: resolve the selected element.
        Mutated-after-construction containers never get here — any second
        binding of the name went opaque in ``_bind``."""
        if not isinstance(sub.slice, ast.Constant):
            return None
        got = self._literal_container(src, sub.value, scope_node)
        if got is None:
            return None
        cont, csrc, cscope = got
        idx = sub.slice.value
        if isinstance(cont, (ast.Tuple, ast.List)):
            if (
                isinstance(idx, int)
                and not isinstance(idx, bool)
                and -len(cont.elts) <= idx < len(cont.elts)
                and not any(isinstance(e, ast.Starred) for e in cont.elts)
            ):
                return self.resolve_expr(csrc, cont.elts[idx], cscope, _guard)
            return None
        if isinstance(cont, ast.Dict):
            for k, v in zip(cont.keys, cont.values):
                if k is None:  # **spread: key set unknowable
                    return None
                if isinstance(k, ast.Constant) and k.value == idx:
                    return self.resolve_expr(csrc, v, cscope, _guard)
        return None

    def _literal_container(self, src, expr, scope_node, _depth=0):
        """Chase ``expr`` through Name bindings to a literal container node;
        returns (container, src, scope_node-for-its-free-names) or None."""
        if _depth > 8:
            return None
        if isinstance(expr, (ast.Tuple, ast.List, ast.Dict)):
            return expr, src, scope_node
        if not isinstance(expr, ast.Name):
            return None
        for node in self._scope_chain(src, scope_node):
            env = self._env(src, node)
            if expr.id in env:
                tag, val = env[expr.id]
                if tag != "expr":
                    return None
                return self._literal_container(src, val, node, _depth + 1)
        mi = self.symbols.by_path.get(src.path)
        got = self.symbols.resolve_member(mi, expr.id) if mi is not None else None
        if got is not None and got[0] == "assign":
            _, val, mi2 = got
            return self._literal_container(mi2.src, val, None, _depth + 1)
        return None

    def _resolve_name(self, src, name, scope_node, _guard):
        for node in self._scope_chain(src, scope_node):
            env = self._env(src, node)
            if name in env:
                return self._from_binding(src, env[name], node, _guard)
        mi = self.symbols.by_path.get(src.path)
        if mi is None:
            return None
        got = self.symbols.resolve_member(mi, name)
        return self._from_symbol(got, _guard)

    def _from_binding(self, src, binding, scope_node, _guard):
        tag, val = binding
        if tag == "def":
            return self._function_target(val)
        if tag == "instance":
            return Target("instance", cls=val)
        if tag == "expr":
            return self.resolve_expr(src, val, scope_node, _guard)
        return None  # opaque

    def _from_symbol(self, got, _guard):
        if got is None:
            return None
        tag = got[0]
        if tag == "func":
            return self._function_target(got[1])
        if tag == "class":
            return Target("class", cls=got[1])
        if tag == "module":
            return Target("module", mod=got[1])
        if tag == "assign":
            _, expr, mi = got
            return self.resolve_expr(mi.src, expr, None, _guard)
        return None

    def _member(self, base: Target, attr: str, _guard):
        if base.kind == "module":
            return self._from_symbol(self.symbols.resolve_member(base.mod, attr), _guard)
        if base.kind in ("instance", "class"):
            ci = base.cls
            if attr in ci.methods:
                t = self._function_target(ci.methods[attr])
                if t is not None and base.kind == "instance":
                    return dataclasses.replace(t, bound=True) if t.kind == "function" else t
                return t
            rhs = ci.attr_assigns.get(attr)
            if rhs is not None:
                # the RHS was written inside a method; its free names resolve
                # against the defining module's top-level scope
                return self.resolve_expr(ci.module.src, rhs, None, _guard)
        return None

    def _function_target(self, fi: FunctionInfo) -> Optional[Target]:
        if fi is None:
            return None
        t = Target("function", func=fi)
        # a def decorated with jax.jit / partial(jax.jit, ...) carries its
        # static/donate contract at every call site
        wrap = self._decorator_jit(fi)
        if wrap is not None:
            return dataclasses.replace(wrap, inner=t)
        return t

    def _decorator_jit(self, fi: FunctionInfo) -> Optional[Target]:
        aliases = fi.module.src.aliases
        for dec in fi.node.decorator_list:
            q = qualified_name(dec.func if isinstance(dec, ast.Call) else dec, aliases)
            if q in _JIT_WRAPPERS:
                return self._jit_target(dec if isinstance(dec, ast.Call) else None)
            if isinstance(dec, ast.Call) and q in _PARTIAL and dec.args:
                q2 = qualified_name(dec.args[0], aliases)
                if q2 in _JIT_WRAPPERS:
                    return self._jit_target(dec)
        return None

    def _jit_target(self, call: ast.Call | None, inner: Target | None = None) -> Target:
        donate: tuple[int, ...] = ()
        nums: tuple[int, ...] = ()
        names: tuple[str, ...] = ()
        for kw in call.keywords if call is not None else ():
            if kw.arg == "donate_argnums":
                donate = _int_tuple(kw.value) or ()
            elif kw.arg == "static_argnums":
                nums = _int_tuple(kw.value) or ()
            elif kw.arg == "static_argnames":
                names = _str_tuple(kw.value) or ()
        return Target("jit", inner=inner, donate=donate, static_nums=nums, static_names=names)

    def _resolve_call_result(self, src, call: ast.Call, scope_node, _guard):
        """What a call EVALUATES to (constructor -> instance, jit(...) -> a
        jit-wrapped callable, factory -> its summarized return)."""
        q = qualified_name(call.func, src.aliases)
        if q in _JIT_WRAPPERS:
            inner = self.resolve_expr(src, call.args[0], scope_node, _guard) if call.args else None
            return self._jit_target(call, inner)
        if q in _PARTIAL and call.args:
            q2 = qualified_name(call.args[0], src.aliases)
            if q2 in _JIT_WRAPPERS:
                return self._jit_target(call)
        callee = self.resolve_expr(src, call.func, scope_node, _guard)
        if callee is None:
            return None
        if callee.kind == "class":
            return Target("instance", cls=callee.cls)
        fi = callee.func if callee.kind == "function" else (
            callee.inner.func if callee.kind == "jit" and callee.inner is not None
            and callee.inner.kind == "function" else None
        )
        if fi is not None:
            self._summary_reads += 1
            summary = self.project.summaries.get(fi.qualname)
            if summary is not None and summary.returns is not None:
                return summary.returns
        return None

    # -- capture regions ----------------------------------------------------

    def capture_roots(self, src) -> list[CaptureRoot]:
        """Every region of ``src`` that runs under CUDA-graph capture (see
        ``_CAPTURE_CONTEXTS``); a graphed callable resolves through the call
        graph into any module, an unresolvable one is skipped."""
        aliases = src.aliases
        out: list[CaptureRoot] = []
        for node in src.nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(
                    isinstance(it.context_expr, ast.Call)
                    and qualified_name(it.context_expr.func, aliases) in _CAPTURE_CONTEXTS
                    for it in node.items
                ):
                    out.append(CaptureRoot("torch.cuda.graph", src, self.enclosing_scope(src, node), node.body))
            elif isinstance(node, ast.ClassDef):
                if any(qualified_name(b, aliases) in _CAPTURE_BASES for b in node.bases):
                    for st in node.body:
                        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) and st.name in _CAPTURE_METHODS:
                            out.append(CaptureRoot(f"{node.name}.{st.name}", src, st, [st]))
            elif isinstance(node, ast.Call):
                if qualified_name(node.func, aliases) in _GRAPHED_CALLABLES and node.args:
                    first = node.args[0]
                    fns = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
                    scope = self.enclosing_scope(src, node)
                    for fn in fns:
                        t = self.resolve_expr(src, fn, scope)
                        if t is not None and t.kind == "instance" and "forward" in t.cls.methods:
                            t = self._function_target(t.cls.methods["forward"])
                        if t is not None and t.kind == "function":
                            out.append(CaptureRoot(t.func.name, t.func.module.src, t.func.node, [t.func.node]))
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if isinstance(block, list) and block and isinstance(block[0], ast.stmt):
                    out.extend(self._begin_end_regions(src, node, block))
        return out

    def _begin_end_regions(self, src, owner, block) -> list[CaptureRoot]:
        """``g.capture_begin(...)`` then the statements of the same block up
        to ``g.capture_end()`` (or the block's end)."""
        out = []
        for i, st in enumerate(block):
            if _method_stmt(st, "capture_begin"):
                end = next((j for j in range(i + 1, len(block)) if _method_stmt(block[j], "capture_end")), len(block))
                scope = owner if isinstance(owner, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    else self.enclosing_scope(src, st)
                out.append(CaptureRoot("capture_begin", src, scope, block[i + 1:end]))
        return out

    # -- convenience for rules/tests ---------------------------------------

    def resolved_calls(self, src):
        """Every Call in ``src`` with its enclosing scope and resolution:
        list of (call_node, scope_node, Target-or-None)."""
        out = []
        for node in src.nodes:
            if isinstance(node, ast.Call):
                scope = self.enclosing_scope(src, node)
                out.append((node, scope, self.resolve_call(src, node, scope)))
        return out


def _method_stmt(st: ast.stmt, attr: str) -> bool:
    """``<expr>.<attr>(...)`` as a statement of its own."""
    return (
        isinstance(st, ast.Expr)
        and isinstance(st.value, ast.Call)
        and isinstance(st.value.func, ast.Attribute)
        and st.value.func.attr == attr
    )

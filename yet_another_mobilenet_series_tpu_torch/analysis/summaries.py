# Copy of yet_another_mobilenet_series_tpu/analysis/summaries.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Per-function dataflow summaries over the call graph.

For every def in the project (top-level, method, nested closure) a
:class:`FunctionSummary` records the facts the interprocedural rules need:

- ``key_params`` — parameters consumed as PRNG keys: passed as the first
  positional argument of any ``jax.random.*`` call (``split``/``fold_in``
  included: two callees splitting the SAME key derive the same streams), or
  passed whole to a resolved callee whose matching parameter is
  key-consuming (transitive, via fixpoint). YAMT010's ground truth.
- ``donated_params`` — positional parameter indices whose buffer is donated
  when the function runs: the parameter is passed at a donated position of a
  ``jit(..., donate_argnums=...)`` callable or of a callee that itself
  donates. YAMT008's cross-call ground truth.
- ``returns`` — the resolved Target of the function's return value when it
  is a callable we can model: a jit wrapper (``return jax.jit(fn,
  donate_argnums=(0,))`` — the cli/train.py step-factory shape) or a local
  def (``return step_fn`` — the make_train_step shape). This is what lets
  ``step = make_dp_train_step(...)`` act as a donating function at its call
  sites two modules away.

The fixpoint iterates until no summary changes (bounded); resolution that
cannot be decided stays absent — over-approximation is only ever toward
"don't flag".
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from .core import qualified_name
from .callgraph import Target
from .symbols import FunctionInfo

# jax.random functions whose first argument is NOT a key
_NON_KEY_FIRST_ARG = {"PRNGKey", "key", "wrap_key_data"}

_MAX_ROUNDS = 12


@dataclasses.dataclass
class FunctionSummary:
    fi: FunctionInfo
    key_params: set[str] = dataclasses.field(default_factory=set)
    donated_params: set[int] = dataclasses.field(default_factory=set)
    returns: Optional[Target] = None

    def caller_donated_positions(self, bound: bool) -> tuple[int, ...]:
        """Donated positions as the CALLER sees them (``self`` already bound
        for instance-method calls)."""
        if bound:
            return tuple(sorted(i - 1 for i in self.donated_params if i >= 1))
        return tuple(sorted(self.donated_params))

    def param_at(self, index: int, bound: bool) -> Optional[str]:
        pos = self.fi.pos_params[1:] if bound else self.fi.pos_params
        return pos[index] if 0 <= index < len(pos) else None


def summary_for_target(project, target: Optional[Target]) -> Optional[FunctionSummary]:
    """The FunctionSummary behind a resolved call target (unwrapping one
    jit layer), or None for anything opaque."""
    if target is None:
        return None
    if target.kind == "jit" and target.inner is not None:
        target = target.inner
    if target.kind != "function" or target.func is None:
        return None
    return project.summaries.get(target.func.qualname)


def donated_caller_positions(project, target: Optional[Target]) -> tuple[int, ...]:
    """Caller-side donated positions of a call to ``target`` ((), if none)."""
    if target is None:
        return ()
    if target.kind == "jit":
        if target.donate:
            return target.donate
        return ()
    if target.kind == "function":
        s = summary_for_target(project, target)
        if s is not None:
            return s.caller_donated_positions(target.bound)
    return ()


def compute(project, out: dict[str, FunctionSummary]) -> None:
    """Fill ``out`` (qualname -> summary) to fixpoint. ``out`` is installed
    on the project BEFORE this runs, so the call graph's returns-resolution
    sees partial results and sharpens round over round."""
    symbols = project.symbols
    cg = project.callgraph
    infos = list(symbols.by_node.values())
    for fi in infos:
        out[fi.qualname] = FunctionSummary(fi)

    # per-function call-site lists are STATIC across fixpoint rounds: the
    # walk, the qualified-name lookup, and the enclosing scope never change
    # — only call-target resolution sharpens round over round. Precomputing
    # them once keeps later rounds to pure resolution work.
    sites: dict[str, list] = {}
    for fi in infos:
        src = fi.module.src
        aliases = src.aliases
        sites[fi.qualname] = [
            (node, qualified_name(node.func, aliases), cg.enclosing_scope(src, node))
            for node in src.subtree(fi.node)
            if isinstance(node, ast.Call)
        ]

    for _ in range(_MAX_ROUNDS):
        changed = False
        for fi in infos:
            s = out[fi.qualname]
            changed |= _scan_function(project, cg, fi, s, sites[fi.qualname])
        if not changed:
            break


def _scan_function(project, cg, fi: FunctionInfo, s: FunctionSummary, sites) -> bool:
    src = fi.module.src
    params = fi.all_params
    pos = fi.pos_params
    changed = False

    for node, q, scope in sites:
        if q and q.startswith("jax.random.") and q.rsplit(".", 1)[-1] not in _NON_KEY_FIRST_ARG:
            if node.args and isinstance(node.args[0], ast.Name) and node.args[0].id in params:
                if node.args[0].id not in s.key_params:
                    s.key_params.add(node.args[0].id)
                    changed = True
            continue
        target = cg.resolve_call(src, node, scope)
        if target is None:
            continue
        callee = summary_for_target(project, target)
        if callee is not None:
            bound = target.kind == "function" and target.bound
            for i, arg in enumerate(node.args):
                if not (isinstance(arg, ast.Name) and arg.id in params):
                    continue
                pname = callee.param_at(i, bound)
                if pname is not None and pname in callee.key_params and arg.id not in s.key_params:
                    s.key_params.add(arg.id)
                    changed = True
            for kw in node.keywords:
                if (
                    kw.arg is not None
                    and isinstance(kw.value, ast.Name)
                    and kw.value.id in params
                    and kw.arg in callee.key_params
                    and kw.value.id not in s.key_params
                ):
                    s.key_params.add(kw.value.id)
                    changed = True
        for d in donated_caller_positions(project, target):
            if d < len(node.args) and isinstance(node.args[d], ast.Name):
                name = node.args[d].id
                if name in pos:
                    idx = pos.index(name)
                    if idx not in s.donated_params:
                        s.donated_params.add(idx)
                        changed = True

    if s.returns is None:
        ret = _returned_callable(cg, fi)
        if ret is not None:
            s.returns = ret
            changed = True
    return changed


def _returned_callable(cg, fi: FunctionInfo) -> Optional[Target]:
    """First return value (own body only, not nested defs) that resolves to
    a jit wrapper, a project function, or a project-class instance (so
    method calls on a factory's result — ``predict_async(x).result()`` —
    resolve through the returned class)."""
    src = fi.module.src
    stack = list(fi.node.body)
    while stack:
        st = stack.pop(0)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(st, ast.Return) and st.value is not None:
            t = cg.resolve_expr(src, st.value, fi.node)
            if t is not None and t.kind in ("jit", "function", "instance"):
                return t
            continue
        for block in ("body", "orelse", "finalbody"):
            stack.extend(getattr(st, block, []))
        for h in getattr(st, "handlers", []):
            stack.extend(h.body)
    return None

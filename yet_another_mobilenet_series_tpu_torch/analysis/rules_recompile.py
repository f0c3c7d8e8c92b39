"""YAMT009 — recapture hazards: the torch twin of the JAX package's
recompilation hazards (yet_another_mobilenet_series_tpu/analysis/
rules_recompile.py).

A CUDA-graph capture costs a warm-up run, the capture and the graph's
instantiation: tens of milliseconds to seconds, paid once per executable
when the graph is kept and replayed. Two AST-visible ways to pay it on
every call instead (the JAX package's re-jit per step):

1. **A graph that does not outlive its capture.** A ``torch.cuda.CUDAGraph()``
   captured (``with torch.cuda.graph(g)`` or ``g.capture_begin()``) in a
   function that neither returns it nor stores it (an attribute, a
   subscript, a container, or an argument of another call) is captured
   anew by every call, and so is a ``make_graphed_callables`` result that
   is only called where it is made.

2. **A cache keyed on a value that changes every call.** A graph (or the
   result of a resolved project function that captures one) stored as
   ``cache[key] = ...`` with a key that holds ``id(...)``, ``.data_ptr()``,
   ``time.*``, ``uuid.*``, ``random.*`` or ``next(...)``: the cache never
   hits, and every call captures. The port's executable caches
   (serve/engine.py by (model, bucket, size, k), parallel/dp.py's
   ``GroupedStep`` by its first call) key on shapes and settings.
"""

from __future__ import annotations

import ast

from .callgraph import _CAPTURE_CONTEXTS, _GRAPHED_CALLABLES as _GRAPHED
from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_GRAPH = {"torch.cuda.CUDAGraph"}
# receivers' methods that use a graph without keeping it
_GRAPH_METHODS = {"capture_begin", "capture_end", "replay", "register_generator_state", "reset",
                  "enable_debug_mode", "debug_dump", "pool"}
_VOLATILE_NAMES = {"id", "next", "object"}
_VOLATILE_PREFIXES = ("time.", "uuid.", "random.", "numpy.random.")


def _capturing(project) -> set[int]:
    """ids of the defs that capture a graph, directly or through resolved
    callees (to a fixpoint)."""
    cached = getattr(project, "_torch_capturing", None)
    if cached is not None:
        return cached
    cg = project.callgraph
    infos = list(project.symbols.by_node.values())
    out: set[int] = set()
    calls = {}
    for fi in infos:
        src = fi.module.src
        calls[id(fi.node)] = []
        for node in src.subtree(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if qualified_name(node.func, src.aliases) in _GRAPH | _GRAPHED | _CAPTURE_CONTEXTS:
                out.add(id(fi.node))
            else:
                calls[id(fi.node)].append((src, node))
    for _ in range(8):
        changed = False
        for fi in infos:
            if id(fi.node) in out:
                continue
            for src, node in calls[id(fi.node)]:
                t = cg.resolve_call(src, node, cg.enclosing_scope(src, node))
                if t is not None and t.kind == "function" and id(t.func.node) in out:
                    out.add(id(fi.node))
                    changed = True
                    break
        if not changed:
            break
    project._torch_capturing = out
    return out


def _volatile(key: ast.expr, aliases) -> str | None:
    for n in ast.walk(key):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Name) and n.func.id in _VOLATILE_NAMES:
            return f"{n.func.id}(...)"
        if isinstance(n.func, ast.Attribute) and n.func.attr == "data_ptr":
            return ".data_ptr()"
        q = qualified_name(n.func, aliases) or ""
        if q.startswith(_VOLATILE_PREFIXES):
            return f"{q}(...)"
    return None


@register
class RecaptureHazard(Rule):
    id = "YAMT009"
    name = "recapture-hazard"
    description = (
        "a CUDA graph captured where it cannot be kept (dropped when the function returns) "
        "or cached under a key that changes every call: every call pays a capture"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        out: list[Finding] = []
        cg = project.callgraph
        capturing = None
        for node in src.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._dropped(node, src))
            elif isinstance(node, ast.Assign):
                subs = [t for t in node.targets if isinstance(t, ast.Subscript)]
                if not subs or not isinstance(node.value, ast.Call):
                    continue
                q = qualified_name(node.value.func, src.aliases)
                graph = q in _GRAPH | _GRAPHED
                if not graph:
                    if capturing is None:
                        capturing = _capturing(project)
                    t = cg.resolve_call(src, node.value, cg.enclosing_scope(src, node))
                    graph = t is not None and t.kind == "function" and id(t.func.node) in capturing
                for sub in subs if graph else ():
                    why = _volatile(sub.slice, src.aliases)
                    if why is not None:
                        out.append(Finding(
                            src.path, sub.lineno, sub.col_offset, self.id,
                            f"a captured graph cached under a key holding {why}, which changes every "
                            "call: the cache never hits and every call captures; key it on shapes "
                            "and settings"))
        return out

    def _dropped(self, fn, src) -> list[Finding]:
        """Graphs bound in ``fn`` that no return, store or call keeps."""
        aliases = src.aliases
        made: dict[str, ast.AST] = {}
        for st in src.subtree(fn):
            if (
                isinstance(st, ast.Assign) and len(st.targets) == 1 and isinstance(st.targets[0], ast.Name)
                and isinstance(st.value, ast.Call) and qualified_name(st.value.func, aliases) in _GRAPH | _GRAPHED
                and src.scopes.get(id(st)) is fn
            ):
                made[st.targets[0].id] = st
        out = []
        for name, st in made.items():
            if not self._kept(fn, name, src):
                what = "make_graphed_callables result" if qualified_name(st.value.func, aliases) in _GRAPHED \
                    else "CUDA graph"
                out.append(Finding(
                    src.path, st.lineno, st.col_offset, self.id,
                    f"{what} '{name}' is captured and dropped within one call of '{fn.name}': every "
                    "call pays a capture; keep it (an attribute or a keyed cache) and replay it"))
        return out

    def _kept(self, fn, name, src) -> bool:
        parents = src.parents
        for n in src.subtree(fn):
            if not (isinstance(n, ast.Name) and n.id == name and isinstance(n.ctx, ast.Load)):
                continue
            p = parents.get(id(n))
            if isinstance(p, ast.Attribute) and p.attr in _GRAPH_METHODS:
                continue  # g.replay(), g.capture_begin(...): a use, not a keep
            if isinstance(p, ast.Call) and n in p.args and qualified_name(p.func, src.aliases) in _CAPTURE_CONTEXTS:
                continue  # with torch.cuda.graph(g): the capture itself
            if isinstance(p, ast.Call) and p.func is n:
                continue  # graphed(x): a call of the graphed callable
            return True  # returned, stored, passed on or put in a container
        return False

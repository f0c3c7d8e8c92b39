"""Capture-safety and generator rules: the torch twins of the JAX package's
YAMT001 and YAMT002 (yet_another_mobilenet_series_tpu/analysis/
rules_tracing.py), under the same ids.

YAMT001 — host effects and host syncs in code captured into a CUDA graph.
The Python of a capture body runs ONCE, at capture; a replay runs only the
kernels it launched. A ``print``, a ``time.*`` read, a registry counter or an
``np.random`` draw there happens once, never per replay (JAX's "runs once at
trace time"), and a host sync (``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()``, ``float/int/bool`` of an argument annotated as a tensor,
``torch.cuda.synchronize``, ``.synchronize()``) is illegal under capture and
invalidates it. Capture regions come from the call graph
(``callgraph.CallGraph.capture_roots``): the body of ``with
torch.cuda.graph(...)``, the statements between ``g.capture_begin()`` and
``g.capture_end()``, the callables given to
``torch.cuda.make_graphed_callables`` and the forward/backward of a
``torch.autograd.Function``. Every resolved callee of a region is scanned
too (opaque calls are skipped).

YAMT002 — generator discipline. A draw from torch's global generator
(``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
``multinomial``/``normal`` and their ``_like`` forms, or the in-place
``Tensor.uniform_``/``normal_``/``random_``/``bernoulli_``/
``exponential_``/``geometric_``/``cauchy_``/``log_normal_``) with no
``generator=`` in package code: its stream depends on every other draw in
the process, so a run is not a function of its seed. And a generator
re-seeded with the same value for a second consumer: in one block, a
``g.manual_seed(E)`` after an earlier ``g.manual_seed(E)`` (the same
expression) with ``g`` used in between, or a ``g.manual_seed(E)`` in a loop
whose seed does not change with the iteration while ``g`` is used in the
loop. Both consumers then read the same stream: perfectly correlated. The
cross-call form (a callee that seeds what it is passed) is YAMT010.
"""

from __future__ import annotations

import ast

from .concurrency import is_package_code
from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_HOST_CALL_NAMES = {"print", "input", "breakpoint", "open"}
_HOST_PREFIXES = ("time.", "numpy.random.", "random.", "datetime.")
# .synchronize() covers torch.cuda.synchronize and Event/Stream.synchronize
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
# obs registry instruments: reg.counter(name).inc() and friends
_INSTRUMENTS = {"counter", "gauge", "histogram"}
_RECORDS = {"inc", "dec", "set", "observe"}

# draws from a generator: torch.<fn>(...) and tensor.<method>(...)
DRAW_FUNCTIONS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal", "poisson",
    "rand_like", "randn_like", "randint_like",
}
DRAW_METHODS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_", "geometric_", "cauchy_",
    "log_normal_",
}


def _tensor_params(fn, aliases) -> set[str]:
    """Parameters annotated as tensors: ``float(x)`` of one reads the card.
    (An unannotated parameter may be a Python number: ``int(stride)``.)"""
    a = fn.args
    return {
        x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)
        if x.annotation is not None
        and (qualified_name(x.annotation, aliases) or "").rsplit(".", 1)[-1] == "Tensor"
    }


def _resolved_function(cg, src, expr, scope):
    t = cg.resolve_expr(src, expr, scope)
    if t is None:
        return None
    if t.kind == "jit" and t.inner is not None:
        t = t.inner
    return t.func if t.kind == "function" else None


@register
class HostEffectsUnderCapture(Rule):
    id = "YAMT001"
    name = "host-effect-under-capture"
    description = (
        "print/time/np.random/a registry counter, or a host sync (.item(), .cpu(), "
        ".numpy(), .tolist(), float(tensor), synchronize), in code captured into a "
        "CUDA graph: runs once at capture, never per replay (or breaks the capture)"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        cg = project.callgraph
        findings: dict[tuple, Finding] = {}
        visited: set[int] = set()
        for root in cg.capture_roots(src):
            params = _tensor_params(root.scope, root.src.aliases) if root.scope is not None else set()
            for node in root.nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visited.add(id(node))
                self._scan(node, root.label, params, root.src, findings, cg, visited, root.scope)
        return list(findings.values())

    def _scan(self, node, label, params, src, out, cg, visited, scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params = params | _tensor_params(node, src.aliases)
            scope = node
        if isinstance(node, ast.Call):
            self._check_call(node, label, params, src, out)
            fi = _resolved_function(cg, src, node.func, scope)
            if fi is not None and id(fi.node) not in visited:
                visited.add(id(fi.node))
                self._scan(fi.node, label, set(), fi.module.src, out, cg, visited, fi.node)
        for child in ast.iter_child_nodes(node):
            self._scan(child, label, params, src, out, cg, visited, scope)

    def _check_call(self, node: ast.Call, label, params, src, out):
        def flag(msg):
            out[(src.path, node.lineno, node.col_offset)] = Finding(
                src.path, node.lineno, node.col_offset, self.id, msg)

        func = node.func
        where = f"code captured into a CUDA graph ({label})"
        if isinstance(func, ast.Name):
            if func.id in _HOST_CALL_NAMES:
                flag(f"host call `{func.id}(...)` in {where}: runs once at capture, never per replay")
            elif (
                func.id in ("float", "int", "bool")
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in params
            ):
                flag(f"`{func.id}({node.args[0].id})` of a tensor argument in {where} reads it on the "
                     "host: a sync, illegal under capture")
            return
        if not isinstance(func, ast.Attribute):
            return
        q = qualified_name(func, src.aliases) or ""
        if func.attr in _SYNC_METHODS:
            flag(f"host sync `.{func.attr}()` in {where}: illegal under capture; read the result "
                 "after the replay")
        elif q.startswith(_HOST_PREFIXES):
            flag(f"host-side `{q}(...)` in {where}: runs once at capture, never per replay "
                 "(hoist it out, or make it a device op)")
        elif (
            func.attr in _RECORDS
            and isinstance(func.value, ast.Call)
            and isinstance(func.value.func, ast.Attribute)
            and func.value.func.attr in _INSTRUMENTS
        ):
            flag(f"registry `{func.value.func.attr}(...).{func.attr}()` in {where}: counts the capture "
                 "once, never a replay (count at the replay site)")


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords) or any(
        kw.arg is None for kw in call.keywords)  # **kwargs may carry it


def is_draw(call: ast.Call, aliases) -> str | None:
    """The draw's name when ``call`` draws random numbers, else None."""
    func = call.func
    q = qualified_name(func, aliases) or ""
    if q.startswith("torch.") and q.count(".") == 1 and q[6:] in DRAW_FUNCTIONS:
        return q
    if isinstance(func, ast.Attribute) and func.attr in DRAW_METHODS:
        return f".{func.attr}"
    return None


def generator_uses(node: ast.AST, key: str):
    """Nodes in ``node`` that consume the generator whose dumped expression
    is ``key``: passed positionally or by keyword to any call."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            for arg in (*sub.args, *(kw.value for kw in sub.keywords)):
                if ast.dump(arg) == key:
                    yield sub


def seeding(st: ast.stmt):
    """``(generator key, seed key, call)`` when ``st`` is ``g.manual_seed(E)``
    (or ``x = g.manual_seed(E)``) with ``g`` a name or attribute chain."""
    value = st.value if isinstance(st, (ast.Expr, ast.Assign)) else None
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and value.func.attr == "manual_seed"
        and isinstance(value.func.value, (ast.Name, ast.Attribute))
        and len(value.args) == 1
    ):
        return ast.dump(value.func.value), ast.dump(value.args[0]), value
    return None


def assigned_names(stmts) -> set[str]:
    out: set[str] = set()
    for st in stmts:
        for n in ast.walk(st):
            if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
                out.add(n.id)
    return out


def blocks(tree):
    """Every statement list of ``tree`` with its loop statement, if the
    list is a loop body."""
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list) and block and isinstance(block[0], ast.stmt):
                loop = node if field == "body" and isinstance(node, (ast.For, ast.AsyncFor, ast.While)) else None
                yield block, loop


@register
class GeneratorDiscipline(Rule):
    id = "YAMT002"
    name = "generator-discipline"
    description = (
        "a torch draw with no generator= (the global generator: not a function of the "
        "run's seed), or a generator re-seeded with the same value for a second "
        "consumer: the two consumers read one stream"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        out: list[Finding] = []
        if is_package_code(src.path):
            for node in src.nodes:
                if isinstance(node, ast.Call) and not _has_generator(node):
                    what = is_draw(node, src.aliases)
                    if what is not None:
                        out.append(Finding(
                            src.path, node.lineno, node.col_offset, self.id,
                            f"`{what}(...)` with no generator= draws from torch's global generator: "
                            "the stream depends on every other draw in the process; pass a "
                            "torch.Generator seeded from the run's seed"))
        for block, loop in blocks(src.tree):
            out.extend(self._reseeds(block, loop, src))
        return out

    def _reseeds(self, block, loop, src) -> list[Finding]:
        out = []
        seen: dict[tuple[str, str], int] = {}  # (generator, seed) -> index in block
        for i, st in enumerate(block):
            got = seeding(st)
            if got is None:
                continue
            gen, seed, call = got
            j = seen.get((gen, seed))
            if j is not None and any(True for s in block[j + 1:i] for _ in generator_uses(s, gen)):
                out.append(Finding(
                    src.path, call.lineno, call.col_offset, self.id,
                    f"generator re-seeded with the seed it had at line {block[j].lineno}, after a "
                    "consumer read it: the next consumer reads the same stream (derive a "
                    "distinct seed, or keep drawing from the one stream)"))
            seen[(gen, seed)] = i
            if loop is not None:
                varying = assigned_names(block) | (
                    assigned_names([ast.Assign(targets=[loop.target], value=ast.Constant(0))])
                    if isinstance(loop, (ast.For, ast.AsyncFor)) else set())
                seed_names = {n.id for n in ast.walk(call.args[0]) if isinstance(n, ast.Name)}
                used = any(True for s in block if s is not st for _ in generator_uses(s, gen))
                if used and not (seed_names & varying):
                    out.append(Finding(
                        src.path, call.lineno, call.col_offset, self.id,
                        "generator re-seeded with the same value every iteration of this loop: "
                        "each iteration's consumer reads the same stream (fold the iteration "
                        "into the seed)"))
        return out

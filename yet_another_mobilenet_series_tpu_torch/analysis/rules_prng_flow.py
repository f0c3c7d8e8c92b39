"""YAMT010 — a generator re-seeded with the same value through a callee:
the torch twin of the JAX package's cross-call key reuse
(yet_another_mobilenet_series_tpu/analysis/rules_prng_flow.py).

YAMT002 sees a ``g.manual_seed(E)`` written in the block that repeats it.
A callee that seeds the generator it is passed (``def init(gen, seed):
gen.manual_seed(seed)``) hides the repeat behind its ``def``: ``init(g,
s); ...; init(g, s)`` hands the second consumer the first one's stream. Per
function, this rule computes which parameters it seeds and from what (a
constant, or another of its parameters), through resolved callees to a
fixpoint. A seeding is then an event at its call site, keyed by the
generator expression and the seed it puts in; two events with the same
keys in one block, at least one of them through a callee, with the
generator used in between (a seeding callee counts as a use: it seeds to
draw), flag the second. Two direct seedings are YAMT002's. Opaque callees
and seeds the analysis cannot name never count.
"""

from __future__ import annotations

import ast

from .core import Finding, Project, Rule, SourceFile, register
from .rules_tracing import blocks, generator_uses, seeding

_MAX_ROUNDS = 8


def _seeded_params(project) -> dict[str, dict[str, tuple[str, object]]]:
    """qualname -> {seeded parameter: ("const", ast.Constant) | ("param", name)}."""
    cached = getattr(project, "_torch_seeded_params", None)
    if cached is not None:
        return cached
    cg = project.callgraph
    infos = list(project.symbols.by_node.values())
    out: dict[str, dict[str, tuple[str, object]]] = {fi.qualname: {} for fi in infos}
    for fi in infos:
        params = set(fi.all_params)
        for node in fi.module.src.subtree(fi.node):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in params
                and len(node.args) == 1
            ):
                seed = node.args[0]
                if isinstance(seed, ast.Name) and seed.id in params:
                    out[fi.qualname][node.func.value.id] = ("param", seed.id)
                elif isinstance(seed, ast.Constant):
                    out[fi.qualname][node.func.value.id] = ("const", seed)
    for _ in range(_MAX_ROUNDS):
        changed = False
        for fi in infos:
            src, params, mine = fi.module.src, set(fi.all_params), out[fi.qualname]
            for node in src.subtree(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                for gen, seed in _call_seedings(cg, src, node, cg.enclosing_scope(src, node), out):
                    if not (isinstance(gen, ast.Name) and gen.id in params) or gen.id in mine:
                        continue
                    if isinstance(seed, ast.Name) and seed.id in params:
                        mine[gen.id] = ("param", seed.id)
                    elif isinstance(seed, ast.Constant):
                        mine[gen.id] = ("const", seed)
                    else:
                        continue
                    changed = True
        if not changed:
            break
    project._torch_seeded_params = out
    return out


def _call_seedings(cg, src, call: ast.Call, scope, seeded):
    """``(generator argument, seed expression)`` for each generator that the
    resolved callee of ``call`` seeds."""
    t = cg.resolve_call(src, call, scope)
    if t is None or t.kind != "function" or t.func is None:
        return []
    fi = t.func
    table = seeded.get(fi.qualname) or {}
    if not table:
        return []
    pos = fi.pos_params[1:] if t.bound else fi.pos_params

    def arg_for(name):
        if name in pos and pos.index(name) < len(call.args):
            return call.args[pos.index(name)]
        return next((kw.value for kw in call.keywords if kw.arg == name), None)

    out = []
    for gen_param, (kind, val) in table.items():
        gen = arg_for(gen_param)
        if gen is None:
            continue
        seed = val if kind == "const" else arg_for(val)
        if seed is not None:
            out.append((gen, seed))
    return out


@register
class CrossCallReseed(Rule):
    id = "YAMT010"
    name = "cross-call-generator-reseed"
    description = (
        "a generator re-seeded with the same value for a second consumer through a "
        "callee that seeds the generator it is passed: the two consumers read one stream"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        cg = project.callgraph
        seeded = _seeded_params(project)
        out: dict[tuple, Finding] = {}
        for block, _ in blocks(src.tree):
            events = []  # (index, generator key, seed key, via callee, node)
            for i, st in enumerate(block):
                got = seeding(st)
                if got is not None:
                    events.append((i, got[0], got[1], False, got[2]))
                    continue
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) or \
                        any(isinstance(getattr(st, f, None), list) for f in ("body", "orelse")):
                    continue  # nested blocks are their own
                for node in ast.walk(st):
                    if isinstance(node, ast.Call):
                        scope = cg.enclosing_scope(src, node)
                        for gen, seed in _call_seedings(cg, src, node, scope, seeded):
                            events.append((i, ast.dump(gen), ast.dump(seed), True, node))
            for a in range(len(events)):
                ia, gen, seed, via_a, _ = events[a]
                for b in range(a + 1, len(events)):
                    ib, gen_b, seed_b, via_b, node = events[b]
                    if (gen_b, seed_b) != (gen, seed) or not (via_a or via_b):
                        continue
                    if via_a or any(True for s in block[ia + 1:ib] for _ in generator_uses(s, gen)):
                        f = Finding(
                            src.path, node.lineno, node.col_offset, self.id,
                            f"generator re-seeded through a callee with the seed it got at line "
                            f"{block[ia].lineno}: the next consumer reads the stream the first one "
                            "read (derive a distinct seed per consumer)")
                        out.setdefault((f.line, f.col), f)
                    break
        return list(out.values())

"""YAMT013 — a torch profiler window with no finally-guaranteed stop: the
torch twin of the JAX package's start_trace rule
(yet_another_mobilenet_series_tpu/analysis/rules_profiler.py).

``torch.profiler.profile(...).start()`` (or ``.__enter__()``) opens a
process-wide capture, and ``torch.cuda.profiler.start()`` (or
``cudart().cudaProfilerStart()``) CUDA's own. If the code between start
and stop raises, an unguarded window stays open: every later op keeps
streaming into it, its trace is never written, and the next window refuses
to open ("profiler already enabled"). ``with torch.profiler.profile(...)``
is guarded by construction and never flags.

A start is GUARDED, as in the source rule, when a stop (``.stop()``,
``.__exit__(...)``, ``torch.cuda.profiler.stop()``, ``cudaProfilerStop()``)
is reachable on every exit path through a ``finally``: the start sits in a
``try`` whose ``finally`` stops (any level up, within the function), or the
start is followed in its block by such a ``try``. A ``.start()`` counts
when its receiver is a ``torch.profiler.profile(...)`` /
``torch.autograd.profiler.profile(...)`` call, or a name or attribute bound
to one in the same function. Split start/stop pairs that cannot share a
frame (a window opened and closed by separate HTTP requests, or across
training steps) carry a same-line suppression naming their out-of-band
guard.
"""

from __future__ import annotations

import ast

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

_PROFILES = {"torch.profiler.profile", "torch.autograd.profiler.profile", "torch.profiler._KinetoProfile"}
_CUDA_START = {"torch.cuda.profiler.start"}
_CUDA_STOP = {"torch.cuda.profiler.stop"}


def _is_stop_call(node: ast.AST, aliases) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if qualified_name(f, aliases) in _CUDA_STOP:
        return True
    return isinstance(f, ast.Attribute) and f.attr in ("stop", "__exit__", "cudaProfilerStop")


def _has_stop(stmts, aliases) -> bool:
    return any(_is_stop_call(n, aliases) for st in stmts for n in ast.walk(st))


def _profile_targets(src: SourceFile) -> set[tuple[int, str]]:
    """(id of the enclosing def, chain) of every name or attribute bound to a
    profiler object."""
    out = set()
    for node in src.nodes:
        if (
            isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
            and qualified_name(node.value.func, src.aliases) in _PROFILES
        ):
            for t in node.targets:
                out.add((id(src.scopes.get(id(node))), qualified_name(t, {})))
    return out


@register
class ProfilerStopGuard(Rule):
    id = "YAMT013"
    name = "profiler-window-unguarded"
    description = (
        "torch.profiler.profile(...).start() / .__enter__() or torch.cuda.profiler.start() "
        "with no finally-guaranteed stop in the same function: an exception inside the "
        "window leaks it — wrap the window in try/finally, or use `with`"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        bound = _profile_targets(src)
        findings: list[Finding] = []
        for node in src.nodes:
            if not isinstance(node, ast.Call) or not self._is_start(node, src, bound):
                continue
            if self._guarded(node, src.parents, src.aliases):
                continue
            findings.append(Finding(
                src.path, node.lineno, node.col_offset, self.id,
                "profiler window started with no finally-guaranteed stop: an exception inside "
                "the window leaks it — use `with torch.profiler.profile(...)` or "
                "`prof.start(); try: ... finally: prof.stop()` (or suppress with the "
                "out-of-band guard named, for split start/stop pairs)",
            ))
        return findings

    def _is_start(self, call: ast.Call, src, bound) -> bool:
        f = call.func
        if qualified_name(f, src.aliases) in _CUDA_START:
            return True
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr == "cudaProfilerStart":
            return True
        if f.attr not in ("start", "__enter__"):
            return False
        recv = f.value
        if isinstance(recv, ast.Call):
            return qualified_name(recv.func, src.aliases) in _PROFILES
        chain = qualified_name(recv, {})
        return chain is not None and (id(src.scopes.get(id(call))), chain) in bound

    def _guarded(self, call: ast.Call, parents, aliases) -> bool:
        cur: ast.AST = call
        while True:
            parent = parents.get(id(cur))
            if parent is None or isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)):
                return self._followed_by_guarded_try(cur, parent, aliases)
            if isinstance(parent, ast.Try):
                in_guarded = any(cur in getattr(parent, f) for f in ("body", "orelse")) or cur in parent.handlers
                if in_guarded and _has_stop(parent.finalbody, aliases):
                    return True
            if isinstance(cur, ast.stmt) and self._followed_by_guarded_try(cur, parent, aliases):
                return True
            cur = parent

    def _followed_by_guarded_try(self, stmt, parent, aliases) -> bool:
        if parent is None or not isinstance(stmt, ast.stmt):
            return False
        for field in ("body", "orelse", "finalbody"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and stmt in block:
                after = block[block.index(stmt) + 1:]
                return any(isinstance(st, ast.Try) and _has_stop(st.finalbody, aliases) for st in after)
        return False

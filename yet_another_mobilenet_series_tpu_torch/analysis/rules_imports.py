"""YAMT006 — private torch APIs: the torch twin of the JAX package's
version-fragile imports (yet_another_mobilenet_series_tpu/analysis/
rules_imports.py).

A name of torch's with a private segment (``torch._C._cuda_getCurrentRawStream``,
``torch._C._profiler._ExperimentalConfig``, ``torch._dynamo``,
``torch._inductor``, ``torch.distributed._*``, ``torch.utils._*``...) is no
part of torch's API: it moves or goes between releases without notice, and
the card's machine runs another torch than the one a change is written on.
An import of one, or an attribute chain that reaches one, flags unless it
sits in a ``try`` whose handler catches ImportError/AttributeError (the
version-guard idiom, as in the source rule), or its name is allowed below
with the reason. A use that is worth its risk carries a same-line
suppression naming why; ``private_names`` lists every private name the rule
lets through by name or suppression, so that ``chip_smoke.py`` resolves
each on the card's torch.
"""

from __future__ import annotations

import ast
import importlib

from .core import Finding, Project, Rule, SourceFile, _load_project, qualified_name, register

# private names let through by prefix, with the reason
ALLOWED: dict[str, str] = {
    "torch._foreach_": (
        "the multi-tensor ops that torch.optim's foreach paths are built on, in torch since "
        "1.9 with the same signatures; chip_smoke.py resolves each one the port uses"
    ),
}
_GUARD_EXCEPTIONS = {"ImportError", "ModuleNotFoundError", "Exception", "AttributeError"}


def private_segment(name: str) -> bool:
    """True when a dotted name rooted at torch has a private segment (one
    underscore; dunders such as ``__version__`` are public)."""
    parts = name.split(".")
    return parts[0] == "torch" and any(p.startswith("_") and not p.startswith("__") for p in parts[1:])


def allowed(name: str) -> str | None:
    return next((why for prefix, why in ALLOWED.items() if name.startswith(prefix)), None)


def _guarded(src: SourceFile) -> set[int]:
    """ids of every node inside a try whose handlers catch ImportError or
    AttributeError (or everything)."""
    out: set[int] = set()
    for node in src.nodes:
        if not isinstance(node, ast.Try):
            continue
        catches = set()
        for h in node.handlers:
            t = h.type
            for n in t.elts if isinstance(t, ast.Tuple) else ([t] if t else []):
                catches.add(n.id if isinstance(n, ast.Name) else getattr(n, "attr", ""))
        if catches & _GUARD_EXCEPTIONS or any(h.type is None for h in node.handlers):
            for block in (node.body, node.orelse):
                for st in block:
                    out.update(id(n) for n in src.subtree(st))
    return out


def _uses(src: SourceFile):
    """``(node, dotted name)`` of every private torch name in ``src``: each
    import, and the longest attribute chain that reaches one."""
    parents = src.parents
    for node in src.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                if private_segment(a.name):
                    yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").startswith("torch"):
            for a in node.names:
                name = f"{node.module}.{a.name}"
                if private_segment(name):
                    yield node, name
        elif isinstance(node, ast.Attribute) and not isinstance(parents.get(id(node)), ast.Attribute):
            q = qualified_name(node, src.aliases)
            if q and private_segment(q):
                yield node, q


@register
class PrivateTorchAPI(Rule):
    id = "YAMT006"
    name = "private-torch-api"
    description = (
        "a private torch name (torch._C.*, torch._dynamo, torch._inductor, "
        "torch.distributed._*, torch.utils._*, ...) outside a try/except version guard "
        "and not allowed by name: it moves between torch releases without notice"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        guarded = _guarded(src)
        out: dict[tuple, Finding] = {}
        for node, name in _uses(src):
            if id(node) in guarded or allowed(name):
                continue
            f = Finding(
                src.path, node.lineno, node.col_offset, self.id,
                f"private torch name `{name}`: no part of torch's API, it moves between releases; "
                "use the public API, guard it with try/except AttributeError, or suppress with "
                "the reason it is worth the risk",
            )
            out.setdefault((f.line, f.col), f)
        return list(out.values())


def private_names(paths) -> dict[str, list[str]]:
    """Every private torch name under ``paths`` that YAMT006 lets through
    by name or by a suppression on its line (name -> ``path:line`` of its
    uses): each must resolve on the torch the port runs on. Version-guarded
    names are left out; their guard handles a torch that lacks them."""
    _, files, _ = _load_project(paths)
    out: dict[str, list[str]] = {}
    for src in files:
        for node, name in _uses(src):
            if allowed(name) or src.suppressed(
                    Finding(src.path, node.lineno, node.col_offset, PrivateTorchAPI.id, "")):
                out.setdefault(name, []).append(f"{src.path}:{node.lineno}")
    return {k: sorted(set(v)) for k, v in sorted(out.items())}


def resolve(name: str, torch_module):
    """What ``name`` names on the torch given as ``torch_module`` (the
    analyzer imports no torch), importing submodules on the way; raises
    AttributeError or ImportError where it does not resolve."""
    obj, parts = torch_module, name.split(".")
    for i, part in enumerate(parts[1:], start=2):
        if not hasattr(obj, part):
            importlib.import_module(".".join(parts[:i]))
        obj = getattr(obj, part)
    return obj

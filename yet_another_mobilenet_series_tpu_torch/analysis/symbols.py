# Copy of yet_another_mobilenet_series_tpu/analysis/symbols.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Project-wide symbol table: the name-resolution half of the
interprocedural layer (docs/LINT.md "Architecture").

One :class:`ModuleInfo` per parsed source file, holding its top-level
functions, classes (with methods and ``self.x = ...`` attribute assignments),
and simple top-level name bindings. Module names are derived from the on-disk
package structure (a directory chain of ``__init__.py``), so
``yet_another_mobilenet_series_tpu/train/steps.py`` resolves as
``yet_another_mobilenet_series_tpu.train.steps`` and a bare fixture file as
its stem. Imports are recorded structurally (module, member, relative level)
rather than as flattened dotted strings, because ``from . import core``
and ``from .core import f`` need different resolution arithmetic.

Everything here is pure AST bookkeeping — resolution logic that needs local
dataflow (instances, jit wrappers, returned closures) lives in
``callgraph.py``; per-function PRNG/donation facts live in ``summaries.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ImportEntry:
    """One imported binding: ``bound`` resolves to ``member`` of ``module``
    (``member=None`` for whole-module imports), ``level`` counting the
    leading dots of a relative import."""

    bound: str
    module: str
    member: Optional[str]
    level: int


@dataclasses.dataclass
class FunctionInfo:
    """A def anywhere in a module (top-level, method, or nested closure)."""

    qualname: str  # "module.fn", "module.Class.method", "module.outer.inner"
    module: "ModuleInfo"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional["ClassInfo"] = None
    parent: Optional["FunctionInfo"] = None  # enclosing def for closures

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def pos_params(self) -> list[str]:
        a = self.node.args
        return [x.arg for x in (*a.posonlyargs, *a.args)]

    @property
    def kwonly_params(self) -> list[str]:
        return [x.arg for x in self.node.args.kwonlyargs]

    @property
    def all_params(self) -> set[str]:
        a = self.node.args
        return set(self.pos_params) | set(self.kwonly_params) | {
            x.arg for x in (a.vararg, a.kwarg) if x is not None
        }


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    module: "ModuleInfo"
    node: ast.ClassDef
    methods: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    # attribute name -> RHS expression of a single consistent `self.x = ...`
    # (or class-level `x = ...`); conflicting assignments drop the attr to
    # opaque (absent) rather than guessing
    attr_assigns: dict[str, Optional[ast.expr]] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.node.name


@dataclasses.dataclass
class ModuleInfo:
    name: str  # dotted
    src: object  # SourceFile (core.py; untyped to avoid the import cycle)
    functions: dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    # top-level single-target Name assigns; None marks a conflicted binding
    assigns: dict[str, Optional[ast.expr]] = dataclasses.field(default_factory=dict)
    imports: dict[str, ImportEntry] = dataclasses.field(default_factory=dict)


def module_name_for(path: str) -> str:
    """Dotted module name from the on-disk package chain of ``path``."""
    path = os.path.abspath(path)
    base = os.path.basename(path)
    stem = base[:-3] if base.endswith(".py") else base
    parts = [] if stem == "__init__" else [stem]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(reversed(parts)) or stem


def _record_attr_assign(ci: ClassInfo, attr: str, value: ast.expr) -> None:
    if attr in ci.attr_assigns:
        prev = ci.attr_assigns[attr]
        if prev is None or ast.dump(prev) != ast.dump(value):
            ci.attr_assigns[attr] = None  # conflicting writes: opaque
    else:
        ci.attr_assigns[attr] = value


class SymbolTable:
    """Modules by dotted name, every FunctionInfo by AST node id, and the
    import-resolution arithmetic shared by the call graph."""

    def __init__(self, project):
        self.modules: dict[str, ModuleInfo] = {}
        self.by_path: dict[str, ModuleInfo] = {}
        self.by_node: dict[int, FunctionInfo] = {}
        self._ambiguous: set[str] = set()
        for src in project.files:
            if src.tree is None:
                continue
            mi = self._index_module(src)
            if mi.name in self.modules:
                self._ambiguous.add(mi.name)
            else:
                self.modules[mi.name] = mi
            self.by_path[src.path] = mi

    # -- indexing -----------------------------------------------------------

    def _index_module(self, src) -> ModuleInfo:
        mi = ModuleInfo(module_name_for(src.path), src)
        for node in src.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        mi.imports[a.asname] = ImportEntry(a.asname, a.name, None, 0)
                    else:
                        top = a.name.split(".")[0]
                        mi.imports[top] = ImportEntry(top, top, None, 0)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name == "*":
                        continue
                    bound = a.asname or a.name
                    mi.imports[bound] = ImportEntry(bound, node.module or "", a.name, node.level)
        for st in src.tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mi.functions[st.name] = self._index_function(mi, st, f"{mi.name}.{st.name}", None, None)
            elif isinstance(st, ast.ClassDef):
                mi.classes[st.name] = self._index_class(mi, st)
            elif (
                isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
            ):
                name = st.targets[0].id
                if name in mi.assigns:
                    mi.assigns[name] = None  # rebound at top level: opaque
                else:
                    mi.assigns[name] = st.value
        return mi

    def _index_function(self, mi, node, qualname, cls, parent) -> FunctionInfo:
        fi = FunctionInfo(qualname, mi, node, cls, parent)
        self.by_node[id(node)] = fi
        for st in mi.src.subtree(node):
            if st is not node and isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(st) not in self.by_node:
                    # nearest registered ancestor wins as parent; qualname
                    # nests for uniqueness within the module
                    self._index_function(mi, st, f"{qualname}.{st.name}", cls, fi)
        return fi

    def _index_class(self, mi, node: ast.ClassDef) -> ClassInfo:
        ci = ClassInfo(f"{mi.name}.{node.name}", mi, node)
        for st in node.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[st.name] = self._index_function(
                    mi, st, f"{ci.qualname}.{st.name}", ci, None
                )
            elif (
                isinstance(st, ast.Assign)
                and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
            ):
                _record_attr_assign(ci, st.targets[0].id, st.value)
        # `self.x = ...` in any method body
        for m in ci.methods.values():
            for st in mi.src.subtree(m.node):
                if not (isinstance(st, ast.Assign) and len(st.targets) == 1):
                    continue
                t = st.targets[0]
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    _record_attr_assign(ci, t.attr, st.value)
        return ci

    # -- resolution ---------------------------------------------------------

    def resolve_module(self, from_mod: ModuleInfo, dotted: str, level: int = 0) -> Optional[ModuleInfo]:
        """The ModuleInfo a (possibly relative) import path refers to, or
        None. Absolute paths match exactly first, then by unambiguous dotted
        suffix (fixture files import each other as bare top-level names)."""
        if level > 0:
            pkg = from_mod.name.split(".")[:-1]  # the module's own package
            if level - 1 > len(pkg):
                return None
            base = pkg[: len(pkg) - (level - 1)]
            full = ".".join(base + ([dotted] if dotted else []))
            mi = self.modules.get(full)
            return None if mi is None or full in self._ambiguous else mi
        if dotted in self.modules:
            return None if dotted in self._ambiguous else self.modules[dotted]
        tail = "." + dotted
        hits = [m for name, m in self.modules.items() if name.endswith(tail)]
        return hits[0] if len(hits) == 1 else None

    def resolve_member(self, mi: ModuleInfo, name: str):
        """('func', fi) | ('class', ci) | ('assign', expr, mi) |
        ('module', sub) | None for a member of module ``mi``."""
        if name in mi.functions:
            return ("func", mi.functions[name])
        if name in mi.classes:
            return ("class", mi.classes[name])
        if mi.assigns.get(name) is not None:
            return ("assign", mi.assigns[name], mi)
        sub = self.modules.get(f"{mi.name}.{name}")
        if sub is not None:
            return ("module", sub)
        # member re-exported through the module's own imports
        ent = mi.imports.get(name)
        if ent is not None:
            return self.resolve_import(mi, ent)
        return None

    def resolve_import(self, from_mod: ModuleInfo, ent: ImportEntry):
        """What an ImportEntry binds: same tagged-union shape as
        :meth:`resolve_member`, or None for anything outside the project."""
        target_mod = self.resolve_module(from_mod, ent.module, ent.level)
        if ent.member is None:
            return None if target_mod is None else ("module", target_mod)
        if target_mod is not None:
            got = self.resolve_member(target_mod, ent.member)
            if got is not None:
                return got
        # `from pkg import mod` where pkg/__init__ isn't in the linted set
        # still resolves when pkg.mod is
        dotted = f"{ent.module}.{ent.member}" if ent.module else ent.member
        as_mod = self.resolve_module(from_mod, dotted, ent.level)
        return None if as_mod is None else ("module", as_mod)

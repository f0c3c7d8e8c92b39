"""YAMT016 — silent f32 upcast of a wire-typed (quantized) staging buffer:
the torch twin of the JAX package's rule (yet_another_mobilenet_series_tpu/
analysis/rules_dtype.py). Its numpy half is the source's; the torch half
is added.

The quantized serving path (serve/quant.py, serve.quant.wire="uint8") exists
to shrink every transferred byte: staging buffers, client batches and the
graph's static input carry a narrow WIRE dtype, and the engine widens to
f32 on the card, after the H2D copy. The hazard is the silent widening on
the host: one ``astype(np.float32)``, ``.float()`` or
``.to(torch.float32)`` on a buffer that was deliberately allocated narrow
restores the 4x bytes the wire mode exists to remove, before they cross.

A local name is **wire-typed** when it is bound from an expression whose
dtype is explicitly narrow:

- a numpy allocation with a narrow dtype: ``np.zeros/empty/ones/full/
  asarray/array/ascontiguousarray(..., <narrow>)`` (positional or
  ``dtype=``), or a cast ``x.astype(<narrow>)``;
- a torch allocation with a narrow ``dtype=``: ``torch.zeros/empty/ones/
  full/as_tensor/tensor/empty_like/zeros_like(..., dtype=<narrow>)``, a cast
  ``x.to(<narrow>)`` / ``x.byte()`` / ``x.char()`` / ``x.half()`` /
  ``x.bfloat16()``, or ``torch.from_numpy(<wire-typed array>)``;

where ``<narrow>`` is a uint8/int8/uint16/int16/float16/bfloat16 literal
(``np.uint8``, ``torch.uint8``, or the string ``"uint8"``...). The mark
propagates through plain rebinding, subscripts/slices (views share dtype)
and dtype-preserving methods (``reshape``/``ravel``/``copy``/``transpose``/
``view``/``squeeze``, and torch's ``clone``/``contiguous``/``pin_memory``/
``permute``/``flatten``/``unsqueeze``/``detach``); it clears when the name is
rebound to anything else or deleted, and a ``.to(device)`` / ``.cuda()``
result is on the card and never marked. While a name is wire-typed, these
conversions flag:

- ``name.astype(<f32>)``, ``np.asarray|array(name, <f32>)`` and the
  dtype-LESS ``jnp.asarray(name)`` (the source's numpy half);
- ``name.float()`` / ``name.double()``, ``name.to(<f32>)`` (the dtype
  positional, after a device, or ``dtype=``) and
  ``torch.as_tensor|tensor(name, dtype=<f32>)``.

Conversions whose dtype argument is a *variable* are the sanctioned idiom
and never flag — the rule targets literals, because a literal is what a
config flip cannot reach. Flow handling matches YAMT014: linear source
order within one function, loop bodies walked twice, branches not forked.
"""

from __future__ import annotations

import ast

from .core import Finding, Project, Rule, SourceFile, qualified_name, register

# dtypes that mark a buffer as deliberately narrow (the wire side)
_NARROW = {"uint8", "int8", "uint16", "int16", "float16", "bfloat16"}
# dtypes whose literal use on a narrow buffer is the flagged upcast
_WIDE = {"float32", "float64"}

_ALLOC_FNS = {"zeros", "empty", "ones", "full", "asarray", "array", "ascontiguousarray"}
_NUMPY_ROOTS = {"numpy", "jax.numpy"}
# methods that preserve dtype: the mark rides through them
_PRESERVING = {"reshape", "ravel", "copy", "transpose", "view", "squeeze"}
# the torch half
_TORCH_ALLOC_FNS = {"zeros", "empty", "ones", "full", "as_tensor", "tensor", "empty_like", "zeros_like",
                    "ones_like", "full_like"}
_TORCH_PRESERVING = {"clone", "contiguous", "pin_memory", "permute", "flatten", "unsqueeze", "detach"}
_TORCH_NARROW_CASTS = {"byte", "char", "half", "bfloat16"}
_TORCH_WIDE_CASTS = {"float", "double"}


def _np_root(q: str | None) -> str | None:
    """'numpy' / 'jax.numpy' when the dotted name is rooted there."""
    if not q:
        return None
    for root in _NUMPY_ROOTS:
        if q == root or q.startswith(root + "."):
            return root
    return None


def _dtype_class(node: ast.expr | None, aliases: dict) -> str | None:
    """'narrow' / 'wide' / None for a dtype-argument expression. Only
    LITERALS classify — a variable dtype is the sanctioned config-routed
    idiom and returns None."""
    name = None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value
    else:
        q = qualified_name(node, aliases) if node is not None else None
        if q is not None:
            name = q.rsplit(".", 1)[-1]
            if _np_root(q) is None and "." in q and not q.startswith("torch."):
                return None  # some_module.uint8 that is not numpy/jnp/torch
    if name in _NARROW:
        return "narrow"
    if name in _WIDE:
        return "wide"
    return None


def _call_dtype_arg(call: ast.Call, pos: int) -> ast.expr | None:
    """The dtype argument of an allocation/conversion call: ``dtype=`` or
    positional index ``pos``."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    if len(call.args) > pos:
        return call.args[pos]
    return None


class _Scanner:
    """Linear event interpreter for one scope (the YAMT014 shape): narrow
    marks, clearing rebinds, upcast findings deduped by location."""

    def __init__(self, rule: "SilentWireUpcast", src: SourceFile):
        self.rule = rule
        self.src = src
        self.marks: set[str] = set()
        self.out: dict[tuple, Finding] = {}

    def run(self, stmts) -> None:
        for st in stmts:
            self._stmt(st)

    # -- statements ---------------------------------------------------------

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            self._exprs(st.test if isinstance(st, ast.While) else st.iter)
            for _ in range(2):  # wrap-around: bottom-of-loop mark, top-of-loop use
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
            cls = self._expr_class(st.value)
            for t in st.targets:
                self._bind(t, cls)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._exprs(st.value)
                self._bind(st.target, self._expr_class(st.value))
            return
        if isinstance(st, ast.AugAssign):
            self._exprs(st.value)
            if isinstance(st.target, ast.Name):
                self.marks.discard(st.target.id)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.marks.discard(t.id)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._exprs(child)

    def _bind(self, target: ast.expr, cls: str | None) -> None:
        if isinstance(target, ast.Name):
            if cls == "narrow":
                self.marks.add(target.id)
            else:
                self.marks.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, None)  # tuple unpack: conservatively clear
        elif isinstance(target, ast.Starred):
            self._bind(target.value, None)

    # -- expression classification -----------------------------------------

    def _expr_class(self, expr: ast.expr) -> str | None:
        """'narrow' when the expression produces a wire-typed array (and so
        its binding target should carry the mark)."""
        # plain rebinding / views / dtype-preserving methods propagate
        if isinstance(expr, ast.Name):
            return "narrow" if expr.id in self.marks else None
        if isinstance(expr, ast.Subscript):
            return self._expr_class(expr.value)
        if isinstance(expr, ast.Call):
            f = expr.func
            # buf.reshape(...) etc. on a marked name
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _PRESERVING | _TORCH_PRESERVING
                and self._marked(f.value)
            ):
                return "narrow"
            torch_class = self._torch_class(expr)
            if torch_class is not None:
                return torch_class or None
            # x.astype(<narrow>)
            if isinstance(f, ast.Attribute) and f.attr == "astype":
                if _dtype_class(_call_dtype_arg(expr, 0), self.src.aliases) == "narrow":
                    return "narrow"
                return None
            # np.zeros(..., <narrow>) and friends
            q = qualified_name(f, self.src.aliases)
            root = _np_root(q)
            if root is not None and q.rsplit(".", 1)[-1] in _ALLOC_FNS:
                pos = 1  # dtype is the 2nd positional for every _ALLOC_FNS member
                if _dtype_class(_call_dtype_arg(expr, pos), self.src.aliases) == "narrow":
                    return "narrow"
        return None

    def _marked(self, expr) -> bool:
        """A marked name, or a subscript/preserving-method chain over one."""
        return self._expr_class(expr) == "narrow"

    def _torch_class(self, call: ast.Call) -> str | None:
        """The torch half of :meth:`_expr_class`: "narrow", "" (a torch
        expression that is not narrow: a device copy, a wide cast), or None
        when ``call`` is no torch allocation or cast."""
        f = call.func
        q = qualified_name(f, self.src.aliases) or ""
        if q == "torch.from_numpy":
            return "narrow" if call.args and self._marked(call.args[0]) else ""
        if q.startswith("torch.") and q.count(".") == 1 and q[6:] in _TORCH_ALLOC_FNS:
            dt = next((kw.value for kw in call.keywords if kw.arg == "dtype"), None)
            return "narrow" if _dtype_class(dt, self.src.aliases) == "narrow" else ""
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr in _TORCH_NARROW_CASTS and not call.args:
            return "narrow"
        if f.attr == "to":
            dts = [*call.args, *(kw.value for kw in call.keywords if kw.arg == "dtype")]
            return "narrow" if any(_dtype_class(d, self.src.aliases) == "narrow" for d in dts) else ""
        if f.attr == "cuda":
            return ""
        return None

    # -- uses (the findings) ------------------------------------------------

    def _exprs(self, expr: ast.expr | None) -> None:
        if expr is None:
            return
        for node in self.src.subtree(expr):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, (ast.Lambda,)):
                continue
            self._check_call(node)

    def _check_call(self, call: ast.Call) -> None:
        f = call.func
        # name.astype(<f32 literal>)
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "astype"
            and isinstance(f.value, ast.Name)
            and f.value.id in self.marks
            and _dtype_class(_call_dtype_arg(call, 0), self.src.aliases) == "wide"
        ):
            self._flag(f.value.id, call, "astype")
            return
        if isinstance(f, ast.Attribute) and self._marked(f.value):
            name = ast.unparse(f.value)
            if f.attr in _TORCH_WIDE_CASTS and not call.args:
                self._flag(name, call, f".{f.attr}()")
                return
            if f.attr == "to" and any(
                _dtype_class(d, self.src.aliases) == "wide"
                for d in [*call.args, *(kw.value for kw in call.keywords if kw.arg == "dtype")]
            ):
                self._flag(name, call, ".to(<f32>)")
                return
        q = qualified_name(f, self.src.aliases)
        if q in ("torch.as_tensor", "torch.tensor") and call.args and self._marked(call.args[0]):
            dt = next((kw.value for kw in call.keywords if kw.arg == "dtype"), None)
            if _dtype_class(dt, self.src.aliases) == "wide":
                self._flag(ast.unparse(call.args[0]), call, f"{q}(..., dtype=<f32>)")
            return
        root = _np_root(q)
        if root is None or q.rsplit(".", 1)[-1] not in ("asarray", "array", "ascontiguousarray"):
            return
        if not (call.args and isinstance(call.args[0], ast.Name) and call.args[0].id in self.marks):
            return
        dt = _call_dtype_arg(call, 1)
        cls = _dtype_class(dt, self.src.aliases)
        if cls == "wide":
            self._flag(call.args[0].id, call, "forced-f32 conversion")
        elif dt is None and root == "jax.numpy" and q.rsplit(".", 1)[-1] in ("asarray", "array"):
            # the dtype-less device conversion: erases the wire contract at
            # the host/device boundary instead of stating it
            self._flag(call.args[0].id, call, "dtype-less device conversion")

    def _flag(self, name: str, node: ast.AST, what: str) -> None:
        f = Finding(
            self.src.path, node.lineno, node.col_offset, self.rule.id,
            f"{what} of wire-typed buffer '{name}': the quantized serving wire "
            "deliberately allocated it narrow, and a literal f32 (or dtype-less "
            "device) conversion silently restores 4x the bytes — route the "
            "dtype through one config-resolved wire_dtype variable instead "
            "(serve/quant.py discipline)",
        )
        self.out.setdefault((f.line, f.col, name), f)


@register
class SilentWireUpcast(Rule):
    id = "YAMT016"
    name = "silent-wire-upcast"
    description = (
        "a buffer deliberately allocated/cast to a narrow wire dtype (numpy or torch) is "
        "widened on the host with a literal f32 (astype, .float(), .to(torch.float32), "
        "as_tensor(..., dtype=torch.float32)) before its H2D copy: the silent widening "
        "un-does the quantized serving wire — pass the config-resolved wire dtype, or "
        "widen on the card"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        scopes: list[ast.AST] = [src.tree]
        scopes += [
            n for n in src.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for scope in scopes:
            scanner = _Scanner(self, src)
            scanner.run(scope.body)
            findings.extend(scanner.out.values())
        return findings

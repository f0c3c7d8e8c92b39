# Copy of yet_another_mobilenet_series_tpu/analysis/contracts.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Cross-process wire-contract extraction (YAMT022-025's ground truth).

The fleet's correctness lives partly in STRING contracts that cross process
boundaries: typed exceptions mapped to wire verdicts in ``_ERROR_MAP``,
custom headers sent by one tier and parsed by another, registry metric
names that must appear in the docs taxonomy and ``PROM_LABEL_FAMILIES``,
and config dataclass sections that must be registered in
``_SECTION_TYPES``. One :class:`ContractModel` per Project extracts all
four surfaces in a single pass over the package ASTs (plus the
``docs/OBSERVABILITY.md`` taxonomy found by walking up from the package),
so the rules in rules_contracts.py are pure set comparisons.

Extraction is literal-only, matching the framework's no-guess bar: a header
name built at runtime, a metric name passed through a variable (unless it
chases to a module-level string constant), an ``_ERROR_MAP`` row holding a
computed class — all degrade to absence, and every rule treats absence as
silence, not a finding.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Optional

from .concurrency import is_package_code
from .core import qualified_name

# custom wire headers: the X- namespace plus Retry-After (RFC 9110's
# backpressure hint, which the router parses as its ejection discriminator).
# Standard entity headers (Content-Type/Length, Host...) are out of scope.
_HEADER_RE = re.compile(r"^(X-[A-Za-z0-9-]+|Retry-After)$")

_SEND_METHODS = {"send_header", "putheader", "add_header"}
_PARSE_METHODS = {"get", "getheader"}
_METRIC_METHODS = {"counter", "gauge", "histogram"}

# backticked dotted tokens in the observability doc; segments carrying
# placeholder syntax (`<class>`, `{short,long}`, `d<i>`) mark family forms
_DOC_TOKEN_RE = re.compile(r"`((?:[A-Za-z_][\w]*|)(?:\.[\w<>{},]+)+)`")
_PLAIN_SEG_RE = re.compile(r"^[a-z0-9_]+$")

_DOC_RELPATH = os.path.join("docs", "OBSERVABILITY.md")
_MAX_WALK_UP = 10


@dataclasses.dataclass(frozen=True)
class Site:
    path: str
    line: int


@dataclasses.dataclass
class ErrorMap:
    """One module-level ``_ERROR_MAP`` list: the typed-exception -> wire
    verdict table, plus the classes the same module handles by hand
    (``isinstance`` dispatch, narrow ``except`` clauses)."""

    path: str
    line: int
    mapped: list[str]  # class keys, row order
    tags: list[str]
    handled: set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ConfigSchema:
    """One module holding ``_SECTION_TYPES``: its dataclasses, which fields
    nest another dataclass (sections), and the registration dict."""

    path: str
    registered: set[str]
    registry_line: int
    # (owner class, field name, annotation class name, line) for fields
    # whose annotation names a sibling dataclass
    section_fields: list[tuple[str, str, str, int]]
    # (owner class, field name, line) for every plain field
    plain_fields: list[tuple[str, str, int]]


class ContractModel:
    """All four contract surfaces of one Project, extracted once."""

    def __init__(self, project):
        self.project = project
        self.headers_sent: dict[str, list[Site]] = {}
        self.headers_parsed: dict[str, list[Site]] = {}
        self.error_map: Optional[ErrorMap] = None
        self.metric_literals: dict[str, list[Site]] = {}  # full literal names
        self.metric_families: dict[str, list[Site]] = {}  # f-string prefixes
        self.prom_families: Optional[set[str]] = None
        self.prom_families_site: Optional[Site] = None
        self.config: Optional[ConfigSchema] = None
        self.attr_reads: set[str] = set()  # attr names read outside config
        self._doc_cache: dict[str, Optional[str]] = {}
        self._doc_names: dict[str, set[str]] = {}
        self._extract()

    # -- doc taxonomy -------------------------------------------------------

    def doc_for(self, path: str) -> Optional[str]:
        """The ``docs/OBSERVABILITY.md`` governing ``path``, found by walking
        up from its directory (nearest wins, so fixture trees carry their
        own taxonomy); None when there is none to check against."""
        d = os.path.dirname(os.path.abspath(path))
        chain = []
        for _ in range(_MAX_WALK_UP):
            if d in self._doc_cache:
                found = self._doc_cache[d]
                break
            chain.append(d)
            cand = os.path.join(d, _DOC_RELPATH)
            if os.path.isfile(cand):
                found = cand
                break
            parent = os.path.dirname(d)
            if parent == d:
                found = None
                break
            d = parent
        else:
            found = None
        for c in chain:
            self._doc_cache[c] = found
        return found

    def doc_names(self, doc_path: str) -> set[str]:
        """Normalized dotted names documented in the taxonomy: each
        backticked token keeps its leading plain segments (placeholder
        segments like ``<class>`` mark the name as a labeled family —
        the truncated prefix is what code-side names are matched against).

        The taxonomy elides siblings — ``serve.netchaos.connections`` /
        ``.blackholed`` / ``.resets`` — and appended suffixes —
        ``serve.shed_deadline (+ `.<class>`)``. A token starting with ``.``
        expands against the most recent full name on the same line, both as
        a sibling (last segment replaced) and as an extension (appended);
        the union over-approximates, which only ever WIDENS the documented
        set — safe for a coverage check."""
        got = self._doc_names.get(doc_path)
        if got is not None:
            return got
        names: set[str] = set()
        try:
            with open(doc_path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            text = ""
        for line in text.splitlines():
            base = None  # last full dotted name seen on this line
            for m in _DOC_TOKEN_RE.finditer(line):
                tok = m.group(1)
                if tok.startswith("."):
                    if base is None:
                        continue
                    expansions = [base + tok]
                    parent = base.rsplit(".", 1)[0]
                    if "." in base:
                        expansions.append(parent + tok)
                else:
                    expansions = [tok]
                for full in expansions:
                    segs = []
                    for seg in full.split("."):
                        if not _PLAIN_SEG_RE.match(seg):
                            break
                        segs.append(seg)
                    if len(segs) >= 2:
                        names.add(".".join(segs))
                if not tok.startswith("."):
                    base = tok
        self._doc_names[doc_path] = names
        return names

    def documented(self, name: str, doc_path: str) -> bool:
        """A code-side metric name (or family prefix) is documented when the
        taxonomy carries it, any dotted prefix of it (a doc row naming the
        family covers every per-label sample), or an extension of it (a doc
        row enumerating samples covers the family)."""
        names = self.doc_names(doc_path)
        if name in names:
            return True
        parts = name.split(".")
        for i in range(2, len(parts)):
            if ".".join(parts[:i]) in names:
                return True
        prefix = name + "."
        return any(n.startswith(prefix) for n in names)

    # -- extraction ---------------------------------------------------------

    def _extract(self) -> None:
        cfg_candidates: list = []
        # one pass over every file's node cache: contract literals come from
        # package code, attr reads from everywhere (the config module's own
        # reads are dropped once it is known — after the loop)
        per_file_attrs: dict[str, set[str]] = {}
        for src in self.project.files:
            if src.tree is None:
                continue
            per_file_attrs[src.path] = self._scan_file(src, is_package_code(src.path))
        for src in self.project.files:
            if src.tree is None or not is_package_code(src.path):
                continue
            for st in src.tree.body:
                if (isinstance(st, ast.Assign) and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Name)):
                    tname, value = st.targets[0].id, st.value
                elif (isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name)
                        and st.value is not None):
                    tname, value = st.target.id, st.value
                else:
                    continue
                if tname == "_ERROR_MAP" and self.error_map is None:
                    self.error_map = self._read_error_map(src, value, st.lineno)
                elif tname == "PROM_LABEL_FAMILIES" and isinstance(value, ast.Dict):
                    self.prom_families = {
                        k.value for k in value.keys
                        if isinstance(k, ast.Constant) and isinstance(k.value, str)
                    }
                    self.prom_families_site = Site(src.path, st.lineno)
                elif tname == "_SECTION_TYPES" and isinstance(value, ast.Dict):
                    cfg_candidates.append((src, value, st.lineno))
        if self.error_map is not None:
            self._read_handled(self.error_map)
        if cfg_candidates:
            self.config = self._read_config(*cfg_candidates[0])
            cfg_path = self.config.path
        else:
            cfg_path = None
        for path, attrs in per_file_attrs.items():
            if path != cfg_path:
                self.attr_reads |= attrs

    def _scan_file(self, src, pkg: bool) -> set[str]:
        """One walk of ``src``'s node cache: records this file's contract
        literals (package code only) and returns its attribute-read names."""
        attrs: set[str] = set()
        for node in src.nodes:
            if isinstance(node, ast.Attribute):
                attrs.add(node.attr)
                continue
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Name)
                    and f.id in ("getattr", "hasattr")
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)
                ):
                    attrs.add(node.args[1].value)
                elif pkg and isinstance(f, ast.Attribute):
                    attr = f.attr
                    arg0 = node.args[0] if node.args else None
                    if attr in _SEND_METHODS or attr in _PARSE_METHODS:
                        if isinstance(arg0, ast.Constant) and isinstance(arg0.value, str) \
                                and _HEADER_RE.match(arg0.value):
                            book = (self.headers_sent if attr in _SEND_METHODS
                                    else self.headers_parsed)
                            self._hit(book, arg0.value, src, node)
                    if attr in _METRIC_METHODS and arg0 is not None:
                        self._metric_arg(src, arg0)
                continue
            if not pkg:
                continue
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                            and _HEADER_RE.match(k.value):
                        self._hit(self.headers_sent, k.value, src, k)
            elif isinstance(node, ast.Subscript):
                if (
                    isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                    and _HEADER_RE.match(node.slice.value)
                ):
                    book = (self.headers_sent if isinstance(node.ctx, (ast.Store, ast.Del))
                            else self.headers_parsed)
                    self._hit(book, node.slice.value, src, node)
        return attrs

    @staticmethod
    def _hit(book: dict[str, list[Site]], name: str, src, node) -> None:
        book.setdefault(name, []).append(Site(src.path, node.lineno))

    # -- metrics ------------------------------------------------------------

    def _metric_arg(self, src, arg: ast.expr) -> None:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if "." in arg.value:
                self._hit(self.metric_literals, arg.value, src, arg)
            return
        if not isinstance(arg, ast.JoinedStr):
            return  # a plain variable: opaque, contributes nothing
        prefix = ""
        for part in arg.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix += part.value
                continue
            if isinstance(part, ast.FormattedValue) and isinstance(part.value, ast.Name):
                const = self._module_str_const(src, part.value.id)
                if const is not None:
                    prefix += const
                    continue
            break  # first unresolvable substitution ends the literal prefix
        # a family is a dotted prefix ending at a label substitution:
        # f"serve.bucket_hits.{b}" -> "serve.bucket_hits". A one-segment
        # prefix (f"device.{name}...") is opaque — never a guess.
        if prefix.endswith(".") and "." in prefix[:-1]:
            self._hit(self.metric_families, prefix[:-1], src, arg)

    def _module_str_const(self, src, name: str) -> Optional[str]:
        """Chase a bare name to a module-level string constant (possibly
        imported from a sibling module): ``f"{ROUTER_LATENCY}.{cls}"``."""
        mi = self.project.symbols.by_path.get(src.path)
        for _ in range(4):
            if mi is None:
                return None
            got = self.project.symbols.resolve_member(mi, name)
            if got is None or got[0] != "assign":
                return None
            _, expr, mi2 = got
            if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
                return expr.value
            if isinstance(expr, ast.Name):
                mi, name = mi2, expr.id
                continue
            return None
        return None

    # -- error map ----------------------------------------------------------

    def _read_error_map(self, src, value: ast.expr, lineno: int) -> Optional[ErrorMap]:
        if not isinstance(value, (ast.List, ast.Tuple)):
            return None
        mapped: list[str] = []
        tags: list[str] = []
        for row in value.elts:
            if not isinstance(row, (ast.Tuple, ast.List)) or len(row.elts) < 3:
                continue
            key = self._class_key(src, row.elts[0])
            tag = row.elts[2]
            if key is not None:
                mapped.append(key)
            if isinstance(tag, ast.Constant) and isinstance(tag.value, str):
                tags.append(tag.value)
        return ErrorMap(src.path, lineno, mapped, tags)

    def _read_handled(self, em: ErrorMap) -> None:
        src = next((s for s in self.project.files if s.path == em.path), None)
        if src is None:
            return
        for node in src.nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"
                and len(node.args) == 2
            ):
                elts = (node.args[1].elts if isinstance(node.args[1], ast.Tuple)
                        else [node.args[1]])
                for e in elts:
                    key = self._class_key(src, e)
                    # exception classes are CamelCase: a lowercase external
                    # "name" is a loop variable over the map, not a class
                    if key is not None and key.rsplit(".", 1)[-1][:1].isupper():
                        em.handled.add(key)
            elif isinstance(node, ast.ExceptHandler) and node.type is not None:
                elts = (node.type.elts if isinstance(node.type, ast.Tuple)
                        else [node.type])
                for e in elts:
                    key = self._class_key(src, e)
                    if key is not None and key.rsplit(".", 1)[-1] not in (
                            "Exception", "BaseException"):
                        em.handled.add(key)

    def _class_key(self, src, expr: ast.expr) -> Optional[str]:
        cg = self.project.callgraph
        t = cg.resolve_expr(src, expr, cg.enclosing_scope(src, expr))
        if t is not None and t.kind == "class":
            return t.cls.qualname
        return qualified_name(expr, src.aliases)

    # -- config schema ------------------------------------------------------

    def _read_config(self, src, value: ast.Dict, lineno: int) -> ConfigSchema:
        registered = {
            k.value for k in value.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }
        local_classes = {
            n.name for n in src.tree.body
            if isinstance(n, ast.ClassDef) and self._is_dataclass(src, n)
        }
        section_fields: list[tuple[str, str, str, int]] = []
        plain_fields: list[tuple[str, str, int]] = []
        for n in src.tree.body:
            if not (isinstance(n, ast.ClassDef) and n.name in local_classes):
                continue
            for f in n.body:
                if not (isinstance(f, ast.AnnAssign) and isinstance(f.target, ast.Name)):
                    continue
                ann = f.annotation
                ann_name = ann.id if isinstance(ann, ast.Name) else (
                    ann.value if isinstance(ann, ast.Constant)
                    and isinstance(ann.value, str) else None
                )
                if ann_name in local_classes:
                    section_fields.append((n.name, f.target.id, ann_name, f.lineno))
                else:
                    plain_fields.append((n.name, f.target.id, f.lineno))
        return ConfigSchema(src.path, registered, lineno, section_fields, plain_fields)

    @staticmethod
    def _is_dataclass(src, node: ast.ClassDef) -> bool:
        for dec in node.decorator_list:
            q = qualified_name(dec.func if isinstance(dec, ast.Call) else dec, src.aliases)
            if q and q.rsplit(".", 1)[-1] == "dataclass":
                return True
        return False

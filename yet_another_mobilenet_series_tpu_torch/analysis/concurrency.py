# Copy of yet_another_mobilenet_series_tpu/analysis/concurrency.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Concurrency model: thread roots, lock domains, and where shared state
lives — the interprocedural substrate for YAMT019/020/021
(rules_concurrency.py, docs/LINT.md "Concurrency rules").

Three cooperating pieces, all pure AST like the rest of the layer:

- **Thread roots.** Every ``threading.Thread(target=...)`` call in the
  project is a root: the target resolves through the call graph (plain
  names, ``self._method``, instances, nested defs — the shapes YAMT011
  parses file-locally, here resolved project-wide), and a ``lambda`` target
  roots every call its body makes. Each spawn SITE is its own region — two
  spawns of the same function are two regions — plus one synthetic ``main``
  region holding every entry-point function (a def no resolved in-package
  call site reaches: public API, HTTP handlers, module-level code).

- **Lock-domain summaries.** Per function, a linear walk tracks which locks
  are held (``with self._lock:`` / ``LOCK.acquire()``/``.release()``; locks
  are ``threading.Lock``/``RLock``/``Condition`` attributes or module
  globals, keyed by the ROOT class of an inheritance family so a base-class
  lock and a subclass use of it are the same token) around three kinds of
  event: ``self``-attribute reads/writes (mutating method calls like
  ``.append``/``.update`` count as writes), lock acquisitions, and
  known-blocking calls. Summaries propagate through resolved calls to
  fixpoint exactly like summaries.py: a caller holding ``A`` absorbs its
  callee's events with ``A`` added to their held-sets, so a blocking call
  three frames down still knows every lock above it. Events keep their own
  (path, line): findings land in the file containing the hazard.

- **Region attribution.** Events are attributed from the TOP of each region
  (the root target's summary / each main entry's summary), never from the
  middle — a helper that reads an attribute lock-free but is only ever
  called under a lock must inherit that lock, and only top-down propagation
  carries it. A function reached from two regions appears in both, with the
  held-sets each path actually provides.

Honest degradation, matching the framework's no-false-positive bar: opaque
call targets contribute nothing; a lock the model cannot name (aliased
through a local, stored in a container) simply is not tracked — every
widening is toward silence, not noise. Known blind spots are documented in
docs/LINT.md. ``__init__``/``__post_init__`` bodies are excluded from
attribute events (writes there happen-before any thread start), and
``threading.Event``/``queue.Queue``/``collections.deque``-typed attributes
are exempt shared state (their methods are the synchronization).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Optional

from .core import qualified_name
from .symbols import ClassInfo, FunctionInfo

MAIN_REGION = "main"

# lockable primitives the held-set tracks (Semaphores are resource counters
# with far-apart acquire/release pairs, not critical sections — excluded)
_LOCK_TYPES = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
}
# attribute types that ARE synchronization (or are internally synchronized):
# cross-thread access to them is the sanctioned mechanism, not a race
_SYNC_SAFE_TYPES = {
    *_LOCK_TYPES,
    "threading.Event",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "threading.Barrier",
    "threading.Thread",
    "threading.local",
    "queue.Queue",
    "queue.SimpleQueue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
    "collections.deque",
}
_QUEUE_TYPES = {"queue.Queue", "queue.LifoQueue", "queue.PriorityQueue", "queue.SimpleQueue"}

# method calls on an attribute that mutate the container in place
_MUT_METHODS = {
    "append", "appendleft", "add", "extend", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "sort", "reverse",
}

# known-blocking calls by resolved qualified name
_BLOCKING_QUALS = {
    "time.sleep",
    "socket.create_connection",
    "urllib.request.urlopen",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "jax.block_until_ready",
    "jax.device_get",
    "torch.cuda.synchronize",
}
# known-blocking method names on ANY receiver (strong signals; `.compile()`
# is the executable compile — `re.compile` is excluded by qualified name).
# torch's host syncs: Event/Stream.synchronize(), and .item()/.cpu()/
# .tolist(), which wait for the card to reach the tensor they read
_BLOCKING_ATTRS = {"compile", "result", "getresponse", "recv", "accept", "sendall",
                   "synchronize", "item", "cpu", "tolist"}
_NOT_BLOCKING_QUALS = {"re.compile", "sre_compile.compile"}

_INIT_METHODS = {"__init__", "__post_init__", "__new__"}

_MAX_HELDSETS = 6  # per event site; extras are dropped (toward silence)
_MAX_ROUNDS = 12


def is_package_code(path: str) -> bool:
    """Same scope gate as YAMT007/011/012: a dir holding ``__init__.py``."""
    return os.path.exists(os.path.join(os.path.dirname(path), "__init__.py"))


@dataclasses.dataclass(frozen=True)
class ThreadRoot:
    """One ``threading.Thread(target=...)`` spawn site = one region."""

    region: str  # "path:line" — stable id
    target: FunctionInfo
    path: str
    line: int
    spawner_cls: Optional[str] = None  # qualname of the class spawning it
    spawner_family: Optional[str] = None  # family root of that class
    # (path, first line, last line) of the function containing the spawn:
    # its own accesses happen-before start() / after join(), not racily
    spawn_span: Optional[tuple] = None

    @property
    def label(self) -> str:
        return f"thread '{self.target.name}' (started at {os.path.basename(self.path)}:{self.line})"


class FnConc:
    """One function's lock-domain summary (own events + resolved callees').

    Each dict maps an event site to the set of possible held-lock frozensets
    observed on paths reaching it:

    - ``accesses``: (family, attr, kind 'r'|'w', path, line) -> held-sets
    - ``acquires``: (lock_token, path, line) -> held-sets at the acquire
    - ``blocking``: (description, path, line) -> held-sets
    """

    __slots__ = ("accesses", "acquires", "blocking")

    def __init__(self):
        self.accesses: dict[tuple, set[frozenset]] = {}
        self.acquires: dict[tuple, set[frozenset]] = {}
        self.blocking: dict[tuple, set[frozenset]] = {}

    def _add(self, table: dict, key: tuple, held: frozenset) -> None:
        hs = table.setdefault(key, set())
        if held not in hs and len(hs) < _MAX_HELDSETS:
            hs.add(held)

    def absorb(self, callee: "FnConc", held: frozenset) -> None:
        """Merge a callee's events, with the caller's held locks added."""
        for mine, theirs in (
            (self.accesses, callee.accesses),
            (self.acquires, callee.acquires),
            (self.blocking, callee.blocking),
        ):
            for key, heldsets in theirs.items():
                for h in heldsets:
                    self._add(mine, key, h | held)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, FnConc)
            and self.accesses == other.accesses
            and self.acquires == other.acquires
            and self.blocking == other.blocking
        )

    def copy(self) -> "FnConc":
        c = FnConc()
        c.accesses = {k: set(v) for k, v in self.accesses.items()}
        c.acquires = {k: set(v) for k, v in self.acquires.items()}
        c.blocking = {k: set(v) for k, v in self.blocking.items()}
        return c


@dataclasses.dataclass
class _ScanCtx:
    """Per-function facts needed while walking its body."""

    src: object
    mi: object
    fi: Optional[FunctionInfo]  # None for module-level pseudo-bodies
    self_name: Optional[str]
    family: Optional[str]  # family-root qualname when fi is a method


class ConcurrencyModel:
    """Built once per Project (``project.concurrency``); read by the rules."""

    def __init__(self, project):
        self.project = project
        self.symbols = project.symbols
        self.cg = project.callgraph
        project.summaries  # force the PRNG/returns fixpoint: sharper resolution

        self.family_root: dict[str, str] = {}  # class qualname -> root qualname
        self.family_attrs: dict[str, dict[str, Optional[ast.expr]]] = {}
        self._family_aliases: dict[str, dict] = {}  # root -> defining aliases
        self.lock_types: dict[str, str] = {}  # token -> Lock|RLock|Condition
        self.roots: list[ThreadRoot] = []
        self.regions: dict[str, Optional[ThreadRoot]] = {MAIN_REGION: None}
        self.summaries: dict[str, FnConc] = {}
        self.main_entries: list[str] = []

        self._locals: dict[str, FnConc] = {}
        self._calls: dict[str, list[tuple[str, frozenset]]] = {}
        self._called: set[str] = set()

        self._build_families()
        self._scan_all()
        self._find_thread_roots()
        self._fixpoint()
        self._pick_main_entries()

    # -- class families ------------------------------------------------------

    def _build_families(self) -> None:
        """Map every project class to the topmost project base of its
        inheritance chain, and merge ``attr_assigns`` across the family so a
        base-class lock/queue keeps one identity in every subclass."""
        classes: dict[str, ClassInfo] = {}
        for mi in self.symbols.modules.values():
            classes.update({ci.qualname: ci for ci in mi.classes.values()})

        parent: dict[str, str] = {}
        for ci in classes.values():
            for base in ci.node.bases:
                t = self.cg.resolve_expr(ci.module.src, base, None)
                if t is not None and t.kind == "class" and t.cls.qualname in classes:
                    parent[ci.qualname] = t.cls.qualname
                    break  # single-inheritance chains only; first project base wins
        for q in classes:
            root, seen = q, {q}
            while root in parent and parent[root] not in seen:
                root = parent[root]
                seen.add(root)
            self.family_root[q] = root

        for q, ci in classes.items():
            root = self.family_root[q]
            attrs = self.family_attrs.setdefault(root, {})
            self._family_aliases.setdefault(root, classes[root].module.src.aliases)
            for attr, rhs in ci.attr_assigns.items():
                if attr in attrs:
                    prev = attrs[attr]
                    if prev is None or rhs is None or ast.dump(prev) != ast.dump(rhs):
                        attrs[attr] = None  # family members disagree: opaque
                else:
                    attrs[attr] = rhs

        # lock tokens: sync-typed family attributes + module-level globals
        for root, attrs in self.family_attrs.items():
            aliases = self._family_aliases[root]
            for attr, rhs in attrs.items():
                kind = self._sync_kind(rhs, aliases)
                if kind in _LOCK_TYPES.values():
                    self.lock_types[f"{root}.{attr}"] = kind
        for mi in self.symbols.modules.values():
            for name, rhs in mi.assigns.items():
                kind = self._sync_kind(rhs, mi.src.aliases)
                if kind in _LOCK_TYPES.values():
                    self.lock_types[f"{mi.name}.{name}"] = kind

    @staticmethod
    def _sync_kind(rhs: Optional[ast.expr], aliases) -> Optional[str]:
        """'Lock'/'RLock'/'Condition', another _SYNC_SAFE_TYPES tail, or None."""
        if not isinstance(rhs, ast.Call):
            return None
        q = qualified_name(rhs.func, aliases)
        if q in _LOCK_TYPES:
            return _LOCK_TYPES[q]
        if q in _SYNC_SAFE_TYPES:
            return q.rsplit(".", 1)[-1]
        return None

    def attr_is_sync_safe(self, family: str, attr: str) -> bool:
        rhs = self.family_attrs.get(family, {}).get(attr)
        aliases = self._family_aliases.get(family, {})
        return self._sync_kind(rhs, aliases) is not None

    def attr_type_tail(self, family: str, attr: str) -> Optional[str]:
        rhs = self.family_attrs.get(family, {}).get(attr)
        if not isinstance(rhs, ast.Call):
            return None
        q = qualified_name(rhs.func, self._family_aliases.get(family, {}))
        return q if q else None

    # -- local scans ---------------------------------------------------------

    def _scan_all(self) -> None:
        for fi in self.symbols.by_node.values():
            ctx = self._ctx_for(fi)
            facts, calls = self._scan_body(ctx, fi.node.body)
            self._locals[fi.qualname] = facts
            self._calls[fi.qualname] = calls
        # module-level code is a main entry in its own right (singleton
        # construction, registration calls)
        for mi in self.symbols.modules.values():
            ctx = _ScanCtx(mi.src, mi, None, None, None)
            body = [
                st for st in mi.src.tree.body
                if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            ]
            q = f"{mi.name}.<module>"
            facts, calls = self._scan_body(ctx, body)
            self._locals[q] = facts
            self._calls[q] = calls

    def _ctx_for(self, fi: FunctionInfo) -> _ScanCtx:
        self_name = None
        family = None
        if fi.cls is not None and fi.pos_params:
            self_name = fi.pos_params[0]
            family = self.family_root.get(fi.cls.qualname, fi.cls.qualname)
        return _ScanCtx(fi.module.src, fi.module, fi, self_name, family)

    def _scan_body(self, ctx: _ScanCtx, body: list) -> tuple[FnConc, list]:
        facts = FnConc()
        calls: list[tuple[str, frozenset]] = []
        self._walk_block(ctx, body, set(), facts, calls)
        return facts, calls

    def _walk_block(self, ctx, stmts, held: set, facts, calls) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # separate scopes, scanned on their own
            if isinstance(st, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in st.items:
                    self._scan_exprs(ctx, item.context_expr, held, facts, calls)
                    tok = self._lock_token(ctx, item.context_expr)
                    if tok is not None:
                        facts._add(facts.acquires, (tok, ctx.src.path, item.context_expr.lineno), frozenset(held))
                        acquired.append(tok)
                self._walk_block(ctx, st.body, held | set(acquired), facts, calls)
            elif isinstance(st, ast.If):
                self._scan_exprs(ctx, st.test, held, facts, calls)
                self._walk_block(ctx, st.body, set(held), facts, calls)
                self._walk_block(ctx, st.orelse, set(held), facts, calls)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                self._scan_exprs(ctx, st.iter, held, facts, calls)
                self._walk_block(ctx, st.body, set(held), facts, calls)
                self._walk_block(ctx, st.orelse, set(held), facts, calls)
            elif isinstance(st, ast.While):
                self._scan_exprs(ctx, st.test, held, facts, calls)
                self._walk_block(ctx, st.body, set(held), facts, calls)
            elif isinstance(st, ast.Try):
                # body/else/finally share the live held set so the
                # acquire-then-try/finally-release idiom tracks exactly;
                # handlers run with a snapshot
                self._walk_block(ctx, st.body, held, facts, calls)
                for h in st.handlers:
                    self._walk_block(ctx, h.body, set(held), facts, calls)
                self._walk_block(ctx, st.orelse, held, facts, calls)
                self._walk_block(ctx, st.finalbody, held, facts, calls)
            else:
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        self._scan_exprs(ctx, child, held, facts, calls)
                # assignment/del targets are attribute WRITES
                if isinstance(st, ast.Assign):
                    for t in st.targets:
                        self._record_store(ctx, t, held, facts)
                elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                    self._record_store(ctx, st.target, held, facts)
                elif isinstance(st, ast.Delete):
                    for t in st.targets:
                        self._record_store(ctx, t, held, facts)

    # -- expression scanning -------------------------------------------------

    def _scan_exprs(self, ctx, expr, held: set, facts, calls) -> None:
        """Scan one expression tree: calls (lock ops, blocking, callees) and
        self-attribute loads. Lambda bodies are deferred work — they run
        later, under whatever locks the call site then holds — so the walk
        prunes them rather than crediting them with the current held-set."""
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                self._scan_call(ctx, node, held, facts, calls)
            elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                self._record_access(ctx, node, "r", held, facts)
            stack.extend(ast.iter_child_nodes(node))

    def _scan_call(self, ctx, call: ast.Call, held: set, facts, calls) -> None:
        src = ctx.src
        q = qualified_name(call.func, src.aliases)

        # lock method ops mutate the linear held-set
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("acquire", "release"):
            tok = self._lock_token(ctx, call.func.value)
            if tok is not None:
                if call.func.attr == "acquire":
                    facts._add(facts.acquires, (tok, src.path, call.lineno), frozenset(held))
                    held.add(tok)
                else:
                    held.discard(tok)
                return

        blocking = self._blocking_desc(ctx, call, q)
        if blocking is not None:
            desc, released = blocking
            eff = frozenset(held - released)
            facts._add(facts.blocking, (desc, src.path, call.lineno), eff)

        # mutating method call on a self attribute = a write
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _MUT_METHODS
            and isinstance(call.func.value, ast.Attribute)
        ):
            self._record_access(ctx, call.func.value, "w", held, facts)

        # resolved callee edge for the fixpoint
        scope = ctx.fi.node if ctx.fi is not None else None
        target = self.cg.resolve_call(src, call, scope)
        if target is not None:
            fi = None
            if target.kind == "function":
                fi = target.func
            elif target.kind == "jit" and target.inner is not None and target.inner.kind == "function":
                fi = target.inner.func
            if fi is not None:
                calls.append((fi.qualname, frozenset(held)))

    def _blocking_desc(self, ctx, call: ast.Call, q) -> Optional[tuple[str, frozenset]]:
        """(description, locks-released-by-the-call) for a known-blocking
        call, else None. ``Condition.wait`` releases its own lock."""
        if q in _NOT_BLOCKING_QUALS:
            return None
        if q in _BLOCKING_QUALS:
            return (f"{q}(...)", frozenset())
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        recv = call.func.value
        if attr in _BLOCKING_ATTRS:
            return (f".{attr}()", frozenset())
        if attr == "wait":
            tok = self._lock_token(ctx, recv)
            if tok is not None:  # Condition.wait drops the condition's lock
                return (".wait()", frozenset({tok}))
            return (".wait()", frozenset())
        if attr == "join":
            # only a Thread-typed self attribute (str.join/os.path.join noise)
            fam_attr = self._self_attr(ctx, recv)
            if fam_attr is not None and self.attr_type_tail(*fam_attr) == "threading.Thread":
                return (".join()", frozenset())
            return None
        if attr == "get":
            fam_attr = self._self_attr(ctx, recv)
            if fam_attr is not None and self.attr_type_tail(*fam_attr) in _QUEUE_TYPES:
                if any(kw.arg == "block" and isinstance(kw.value, ast.Constant)
                       and kw.value.value is False for kw in call.keywords):
                    return None
                return ("queue .get()", frozenset())
        return None

    def _self_attr(self, ctx, expr) -> Optional[tuple[str, str]]:
        """(family, attr) when ``expr`` is ``self.<attr>`` in a method."""
        if (
            ctx.self_name is not None
            and isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == ctx.self_name
        ):
            return (ctx.family, expr.attr)
        return None

    def _lock_token(self, ctx, expr) -> Optional[str]:
        fam_attr = self._self_attr(ctx, expr)
        if fam_attr is not None:
            tok = f"{fam_attr[0]}.{fam_attr[1]}"
            return tok if tok in self.lock_types else None
        if isinstance(expr, ast.Name):
            tok = f"{ctx.mi.name}.{expr.id}"
            return tok if tok in self.lock_types else None
        return None

    def _record_store(self, ctx, target, held: set, facts) -> None:
        # self.x = ... / self.x[k] = ... / tuple targets
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._record_store(ctx, el, held, facts)
            return
        if isinstance(target, ast.Starred):
            self._record_store(ctx, target.value, held, facts)
            return
        if isinstance(target, ast.Subscript):
            target = target.value  # a subscript store mutates the container
        if isinstance(target, ast.Attribute):
            self._record_access(ctx, target, "w", held, facts)

    def _record_access(self, ctx, attr_node: ast.Attribute, kind: str, held: set, facts) -> None:
        fam_attr = self._self_attr(ctx, attr_node)
        if fam_attr is None:
            return
        if ctx.fi is not None and ctx.fi.name in _INIT_METHODS:
            return  # construction happens-before every thread start
        family, attr = fam_attr
        if f"{family}.{attr}" in self.lock_types or self.attr_is_sync_safe(family, attr):
            return  # the attribute IS the synchronization
        facts._add(
            facts.accesses, (family, attr, kind, ctx.src.path, attr_node.lineno), frozenset(held)
        )

    # -- thread roots --------------------------------------------------------

    def _find_thread_roots(self) -> None:
        for src in self.project.files:
            if src.tree is None:
                continue
            for node in src.nodes:
                if not isinstance(node, ast.Call):
                    continue
                if qualified_name(node.func, src.aliases) != "threading.Thread":
                    continue
                target = next((kw.value for kw in node.keywords if kw.arg == "target"), None)
                if target is None:
                    continue
                scope = self.cg.enclosing_scope(src, node)
                spawner = self.symbols.by_node.get(id(scope)) if scope is not None else None
                cls_q = spawner.cls.qualname if spawner is not None and spawner.cls is not None else None
                fam_q = self.family_root.get(cls_q) if cls_q is not None else None
                span = None
                if scope is not None:
                    span = (src.path, scope.lineno, getattr(scope, "end_lineno", scope.lineno))
                region = f"{src.path}:{node.lineno}"
                for fi in self._root_targets(src, target, scope):
                    root = ThreadRoot(region, fi, src.path, node.lineno, cls_q, fam_q, span)
                    self.roots.append(root)
                    self.regions[region] = root

    def _root_targets(self, src, target: ast.expr, scope) -> list[FunctionInfo]:
        """FunctionInfos a Thread target expression can enter: the resolved
        function, or — for a lambda — every resolved call in its body."""
        if isinstance(target, ast.Lambda):
            out = []
            for node in src.subtree(target.body):
                if isinstance(node, ast.Call):
                    t = self.cg.resolve_call(src, node, scope)
                    if t is not None and t.kind == "function":
                        out.append(t.func)
            return out
        t = self.cg.resolve_expr(src, target, scope)
        if t is not None and t.kind == "function":
            return [t.func]
        return []

    # -- fixpoint + attribution ----------------------------------------------

    def _fixpoint(self) -> None:
        self.summaries = {q: f.copy() for q, f in self._locals.items()}
        for _ in range(_MAX_ROUNDS):
            changed = False
            for q, calls in self._calls.items():
                s = self.summaries[q]
                before = s.copy()
                for callee_q, held in calls:
                    callee = self.summaries.get(callee_q)
                    if callee is not None and callee_q != q:
                        s.absorb(callee, held)
                changed |= s != before
            if not changed:
                break

    def _pick_main_entries(self) -> None:
        """Entry points of the synthetic ``main`` region: functions no
        resolved in-package call reaches (public API, handlers, callbacks)
        plus every module's top-level body. Thread targets and constructors
        are excluded — their events belong to their own region / to
        happens-before setup."""
        called = {callee for calls in self._calls.values() for callee, _ in calls}
        root_targets = {r.target.qualname for r in self.roots}
        for q in self._locals:
            if q.endswith(".<module>"):
                self.main_entries.append(q)
                continue
            if q in called or q in root_targets:
                continue
            name = q.rsplit(".", 1)[-1]
            if name in _INIT_METHODS:
                continue
            self.main_entries.append(q)

    # -- derived views for the rules ----------------------------------------

    def entry_summaries(self):
        """Yield (region_id, root_or_None, FnConc) for every region top."""
        for root in self.roots:
            s = self.summaries.get(root.target.qualname)
            if s is not None:
                yield root.region, root, s
        for q in self.main_entries:
            yield MAIN_REGION, None, self.summaries[q]

    def attr_events(self) -> dict[tuple[str, str], list]:
        """(family, attr) -> [(region, root, kind, path, line, heldsets)],
        attributed top-down from every region entry."""
        out: dict[tuple[str, str], list] = {}
        for region, root, s in self.entry_summaries():
            for (family, attr, kind, path, line), heldsets in s.accesses.items():
                out.setdefault((family, attr), []).append(
                    (region, root, kind, path, line, frozenset(heldsets))
                )
        return out

    def acquire_regions(self) -> dict[str, set[str]]:
        """lock token -> region ids whose code acquires it."""
        out: dict[str, set[str]] = {}
        for region, _root, s in self.entry_summaries():
            for (tok, _path, _line), _heldsets in s.acquires.items():
                out.setdefault(tok, set()).add(region)
        return out

    def lock_edges(self) -> tuple[dict[tuple[str, str], tuple[str, int]], dict[str, tuple[str, int]]]:
        """(ordered-edges, self-edges): ``A -> B`` when B is acquired while A
        is held (any function's summary — held-sets already carry caller
        context), with one witness site each. Self-edges only for
        non-reentrant Locks."""
        edges: dict[tuple[str, str], tuple[str, int]] = {}
        selfedges: dict[str, tuple[str, int]] = {}
        for s in self.summaries.values():
            for (tok, path, line), heldsets in s.acquires.items():
                for h in heldsets:
                    for a in h:
                        if a == tok:
                            if self.lock_types.get(tok) == "Lock":
                                selfedges.setdefault(tok, (path, line))
                        else:
                            edges.setdefault((a, tok), (path, line))
        return edges, selfedges

    def blocking_sites(self) -> dict[tuple[str, str, int], set[frozenset]]:
        """(desc, path, line) -> union of held-sets across every summary."""
        out: dict[tuple[str, str, int], set[frozenset]] = {}
        for s in self.summaries.values():
            for key, heldsets in s.blocking.items():
                out.setdefault(key, set()).update(heldsets)
        return out


def short_lock(token: str) -> str:
    """'pkg.mod.Class._lock' -> 'Class._lock' for messages."""
    parts = token.rsplit(".", 2)
    return ".".join(parts[-2:]) if len(parts) >= 2 else token

# Copy of yet_another_mobilenet_series_tpu/analysis/rules_concurrency.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Concurrency rules (YAMT019-021) on top of the thread-root/lock-domain
model in concurrency.py. All three are project rules: the hazards only
exist across function (and usually file) boundaries, and each finding lands
in the file containing the hazardous line so suppressions live next to the
code they document.

Scope matches YAMT011: package code only (a dir with ``__init__.py``) —
scripts and tests make throwaway threads whose lifetime is the process.
"""

from __future__ import annotations

from .concurrency import MAIN_REGION, is_package_code, short_lock
from .core import Finding, Project, Rule, register


def _no_common_lock(heldsets_a, heldsets_b) -> bool:
    """True when NO path pair protects both sides with a shared lock. Any
    overlapping pair silences the finding (toward silence on mixed paths)."""
    return not any(a & b for a in heldsets_a for b in heldsets_b)


def _mutually_exclusive(root_a, root_b) -> bool:
    """Thread roots spawned by DIFFERENT classes of the SAME inheritance
    family never coexist on one instance (a base-class loop and the subclass
    loop that replaces it): conflicts between them are not real."""
    return (
        root_a is not None
        and root_b is not None
        and root_a.spawner_cls != root_b.spawner_cls
        and root_a.spawner_family is not None
        and root_a.spawner_family == root_b.spawner_family
    )


def _region_label(region: str, root) -> str:
    return "main-thread code" if region == MAIN_REGION else root.label


def _setup_teardown(event, other_root) -> bool:
    """True when a main-region event lies inside the very function that
    spawns the other side's thread: writes there happen-before ``start()``
    (or follow ``join()``), the YAMT011-sanctioned setup/teardown shape."""
    if event[0] != MAIN_REGION or other_root is None or other_root.spawn_span is None:
        return False
    path, lo, hi = other_root.spawn_span
    return event[3] == path and lo <= event[4] <= hi


@register
class CrossThreadSharedState(Rule):
    id = "YAMT019"
    name = "cross-thread-shared-state"
    description = (
        "an attribute of a shared object is written in one thread region and "
        "read/written in another with no common lock held"
    )

    def check_project(self, project: Project) -> list[Finding]:
        model = project.concurrency
        out: list[Finding] = []
        for (family, attr), events in sorted(model.attr_events().items()):
            writes = [e for e in events if e[2] == "w"]
            if not writes:
                continue
            hit = None
            for w in writes:
                for e in events:
                    if e[0] == w[0]:
                        continue  # same region: program order, not a race
                    if w[0] == MAIN_REGION and e[0] == MAIN_REGION:
                        continue
                    if _mutually_exclusive(w[1], e[1]):
                        continue
                    if _setup_teardown(w, e[1]) or _setup_teardown(e, w[1]):
                        continue
                    if not _no_common_lock(w[5], e[5]):
                        continue
                    # prefer a thread-region write as the reported site
                    if hit is None or (hit[0][0] == MAIN_REGION and w[0] != MAIN_REGION):
                        hit = (w, e)
            if hit is None:
                continue
            w, e = hit
            if not is_package_code(w[3]):
                continue
            verb = "written" if e[2] == "w" else "read"
            out.append(
                Finding(
                    w[3], w[4], 0, self.id,
                    f"attribute '{attr}' of {family.rsplit('.', 1)[-1]} is written in "
                    f"{_region_label(w[0], w[1])} and {verb} in {_region_label(e[0], e[1])} "
                    f"(at {e[3]}:{e[4]}) with no common lock held; protect both sides with "
                    "one lock, or suppress with the lock-free idiom's reason (docs/LINT.md)",
                )
            )
        return out


@register
class LockOrderCycle(Rule):
    id = "YAMT020"
    name = "lock-order-cycle"
    description = "two locks are acquired in opposite orders on different paths (deadlock)"

    def check_project(self, project: Project) -> list[Finding]:
        model = project.concurrency
        edges, selfedges = model.lock_edges()
        out: list[Finding] = []

        for tok, (path, line) in sorted(selfedges.items()):
            if not is_package_code(path):
                continue
            out.append(
                Finding(
                    path, line, 0, self.id,
                    f"non-reentrant lock '{short_lock(tok)}' is acquired on a path that "
                    "already holds it: this self-deadlocks; use RLock or restructure "
                    "so the locked region never re-enters",
                )
            )

        # cycle detection on the acquired-while-holding graph: an edge A -> B
        # closes a cycle when some path of edges leads B back to A. Report
        # each cycle once, at the lexically smallest witness edge.
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        reported: set[frozenset] = set()
        for (a, b), (path, line) in sorted(edges.items()):
            back = self._path(adj, b, a)  # [b, ..., a]
            if back is None:
                continue
            nodes = [a] + back[:-1]  # the distinct locks of the cycle
            key = frozenset(nodes)
            if key in reported or not is_package_code(path):
                continue
            reported.add(key)
            chain = " -> ".join(short_lock(t) for t in nodes + [a])
            opath, oline = edges[(back[-2], a)]
            out.append(
                Finding(
                    path, line, 0, self.id,
                    f"lock-order cycle: '{chain}'; the closing edge "
                    f"'{short_lock(back[-2])} -> {short_lock(a)}' is at {opath}:{oline}; "
                    "pick one acquisition order and use it everywhere",
                )
            )
        return out

    @staticmethod
    def _path(adj, start, goal):
        """Edge path [start, ..., goal] through ``adj``, or None."""
        stack, seen = [(start, [start])], {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in sorted(adj.get(node, ())):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


@register
class BlockingUnderContendedLock(Rule):
    id = "YAMT021"
    name = "blocking-under-contended-lock"
    description = (
        "a known-blocking call runs while holding a lock that other "
        "thread/main regions also take"
    )

    def check_project(self, project: Project) -> list[Finding]:
        model = project.concurrency
        acquire_regions = model.acquire_regions()
        out: list[Finding] = []
        for (desc, path, line), heldsets in sorted(model.blocking_sites().items()):
            if not is_package_code(path):
                continue
            contended = sorted(
                {
                    tok
                    for hs in heldsets
                    for tok in hs
                    if len(acquire_regions.get(tok, ())) >= 2
                }
            )
            if not contended:
                continue
            tok = contended[0]
            n = len(acquire_regions[tok])
            out.append(
                Finding(
                    path, line, 0, self.id,
                    f"blocking call {desc} runs while holding '{short_lock(tok)}', which "
                    f"{n} thread/main regions contend for: every waiter stalls behind this "
                    "call; move the slow work outside the lock (pre-compute, then take the "
                    "lock to publish) or suppress with the reason the stall is intended",
                )
            )
        return out

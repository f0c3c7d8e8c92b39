"""SPMD-contract rules: the torch twin of YAMT003 and a copy of YAMT004
(yet_another_mobilenet_series_tpu/analysis/rules_spmd.py).

YAMT003 — a ``torch.distributed`` collective, barrier or point-to-point call
with no explicit group in package code. The JAX package's collectives name a
mesh axis, and the rule checks the name against the mesh's constants. torch
names no axis: a call with no ``group=`` runs over the default world group,
whatever mesh the caller built. The port's groups come from
``parallel/mesh.py`` (``Mesh.group``), and a call that drops its group
silently widens a collective meant for one mesh to every rank of the
process group (or, once ranks split into groups, deadlocks). The group is
explicit when it is passed by keyword (``group=``, ``None`` included: that
is the caller saying "the world") or at its positional index.

YAMT004 — field-tuple/dataclass drift, as in the JAX package. A
``FOO_BAR_FIELDS = (...)`` tuple is this codebase's idiom for "the
checkpoint layout of dataclass FooBar" (train/steps.py
``TRAIN_STATE_FIELDS`` <-> ``TrainState``). Adding a dataclass field without
updating the tuple silently drops state from every checkpoint; this rule pins
the two together across files.
"""

from __future__ import annotations

import ast

from .concurrency import is_package_code
from .core import Finding, Project, Rule, SourceFile, qualified_name, register

# torch.distributed call -> positional index of its group argument
COLLECTIVES: dict[str, int] = {
    "all_reduce": 2,
    "all_reduce_coalesced": 2,
    "all_gather": 2,
    "all_gather_into_tensor": 2,
    "all_gather_object": 2,
    "all_gather_coalesced": 2,
    "reduce": 3,
    "reduce_scatter": 3,
    "reduce_scatter_tensor": 3,
    "broadcast": 2,
    "broadcast_object_list": 2,
    "all_to_all": 2,
    "all_to_all_single": 4,
    "gather": 3,
    "gather_object": 3,
    "scatter": 3,
    "scatter_object_list": 3,
    "barrier": 0,
    "monitored_barrier": 0,
    "send": 2,
    "recv": 2,
    "isend": 2,
    "irecv": 2,
}


@register
class CollectiveGroup(Rule):
    id = "YAMT003"
    name = "collective-without-group"
    description = (
        "a torch.distributed collective, barrier or send/recv with no explicit group= in "
        "package code: it runs over the default world group, not the mesh's "
        "(parallel/mesh.py Mesh.group is the port's ground truth)"
    )

    def check_file(self, src: SourceFile, project: Project) -> list[Finding]:
        if not is_package_code(src.path):
            return []
        findings: list[Finding] = []
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            q = qualified_name(node.func, src.aliases) or ""
            if not q.startswith("torch.distributed.") or q.count(".") != 2:
                continue
            fn = q.rsplit(".", 1)[-1]
            idx = COLLECTIVES.get(fn)
            if idx is None:
                continue
            if any(kw.arg in ("group", None) for kw in node.keywords) or len(node.args) > idx:
                continue
            findings.append(Finding(
                src.path, node.lineno, node.col_offset, self.id,
                f"torch.distributed.{fn} with no group=: it runs over the default world group; "
                "pass the mesh's group (parallel/mesh.py Mesh.group), or group=None to mean "
                "the world",
            ))
        return findings


def _camel(upper_snake: str) -> str:
    return "".join(w.capitalize() for w in upper_snake.split("_"))


def _is_dataclass(node: ast.ClassDef, aliases) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        q = qualified_name(target, aliases) or ""
        if "dataclass" in q.rsplit(".", 1)[-1]:
            return True
    return False


def _class_fields(node: ast.ClassDef) -> list[str]:
    return [st.target.id for st in node.body if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name)]


@register
class FieldTupleDrift(Rule):
    id = "YAMT004"
    name = "field-tuple-drift"
    description = (
        "a FOO_FIELDS tuple (checkpoint layout) that does not exactly match the "
        "fields of the Foo dataclass it mirrors (train/steps.py TRAIN_STATE_FIELDS contract)"
    )

    def check_project(self, project: Project) -> list[Finding]:
        # same-file class wins over a same-named class elsewhere in the tree
        by_file: dict[str, dict[str, list[str]]] = {}
        classes: dict[str, list[str]] = {}
        for src in project.files:
            local = by_file.setdefault(src.path, {})
            for node in src.nodes:
                if isinstance(node, ast.ClassDef) and _is_dataclass(node, src.aliases):
                    local.setdefault(node.name, _class_fields(node))
                    classes.setdefault(node.name, _class_fields(node))

        findings: list[Finding] = []
        for src in project.files:
            for node in src.tree.body:
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.endswith("_FIELDS")
                    and isinstance(node.value, (ast.Tuple, ast.List))
                ):
                    continue
                tname = node.targets[0].id
                elts = node.value.elts
                if not all(isinstance(e, ast.Constant) and isinstance(e.value, str) for e in elts):
                    continue
                listed = [e.value for e in elts]
                cls_name = _camel(tname[: -len("_FIELDS")])
                actual = by_file[src.path].get(cls_name, classes.get(cls_name))
                if actual is None or listed == actual:
                    continue
                missing = [f for f in actual if f not in listed]
                extra = [f for f in listed if f not in actual]
                detail = []
                if missing:
                    detail.append(f"missing {missing}")
                if extra:
                    detail.append(f"extra {extra}")
                if not detail:
                    detail.append(f"order differs (dataclass order: {actual})")
                findings.append(
                    Finding(
                        src.path, node.lineno, node.col_offset, self.id,
                        f"{tname} does not match dataclass {cls_name} fields: " + "; ".join(detail),
                    )
                )
        return findings

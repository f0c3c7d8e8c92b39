# Copy of yet_another_mobilenet_series_tpu/analysis/rules_config.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""YAMT005 — config-key drift between apps/*.yml and config.py.

config.py's strict ``_build`` rejects unknown keys — but only when the yml is
actually LOADED, i.e. a typo in an experiment file costs a failed cluster
launch (or worse, sits in an app nobody has run since the schema changed).
This rule replays the same strict check statically: every key in every
``.yml`` under the linted tree must name a field of the Config schema parsed
out of the project's ``config.py`` (sections one level deep, matching
``_build``'s dataclass dispatch). ``_base_`` is the inheritance key and is
exempt.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Finding, Project, Rule, register
from .rules_spmd import _class_fields, _is_dataclass


def _config_schema(project: Project):
    """Parse the project's config.py into {'': {top field: section name|None},
    section name: [field, ...]}. None when the project has no config.py with
    a Config dataclass."""
    for src in project.files:
        if os.path.basename(src.path) != "config.py":
            continue
        dataclasses = {
            node.name: node
            for node in src.nodes
            if isinstance(node, ast.ClassDef) and _is_dataclass(node, src.aliases)
        }
        root = dataclasses.get("Config")
        if root is None:
            continue
        sections: dict[str, list[str]] = {
            name: _class_fields(node) for name, node in dataclasses.items()
        }
        top: dict[str, str | None] = {}
        for st in root.body:
            if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
                ann = st.annotation
                ann_name = ann.id if isinstance(ann, ast.Name) else (
                    ann.value if isinstance(ann, ast.Constant) and isinstance(ann.value, str) else None
                )
                top[st.target.id] = ann_name if ann_name in sections else None
        return top, sections
    return None


def _key_line(lines: list[str], key: str, start: int = 0, stop: int | None = None, indented: bool = False) -> int:
    """1-based line of the first `key:` occurrence in [start, stop)."""
    pat = re.compile((r"^\s+" if indented else r"^") + re.escape(key) + r"\s*:")
    for i in range(start, stop if stop is not None else len(lines)):
        if pat.match(lines[i]):
            return i + 1
    return start + 1


@register
class ConfigKeyDrift(Rule):
    id = "YAMT005"
    name = "config-key-drift"
    description = (
        "a key in an apps/*.yml experiment file that no config.py dataclass field "
        "accepts — the static version of config._build's unknown-key error"
    )

    def check_project(self, project: Project) -> list[Finding]:
        schema = _config_schema(project)
        if schema is None or not project.yml_files:
            return []
        top, sections = schema
        import yaml

        findings: list[Finding] = []
        for path in project.yml_files:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                data = yaml.safe_load(text)
            except yaml.YAMLError as e:
                findings.append(Finding(path, 1, 0, self.id, f"unparseable YAML: {e}"))
                continue
            if not isinstance(data, dict):
                continue
            lines = text.splitlines()
            for key, value in data.items():
                if key == "_base_":
                    continue
                if key not in top:
                    line = _key_line(lines, str(key))
                    findings.append(
                        Finding(
                            path, line, 0, self.id,
                            f"unknown config key '{key}' (valid sections/fields: {sorted(top)})",
                        )
                    )
                    continue
                section = top[key]
                if section is None or not isinstance(value, dict):
                    continue
                valid = sections[section]
                sec_line = _key_line(lines, str(key))
                next_top = next(
                    (i for i in range(sec_line, len(lines)) if re.match(r"^[A-Za-z_]", lines[i])),
                    len(lines),
                )
                for sub in value:
                    if sub not in valid:
                        line = _key_line(lines, str(sub), sec_line, next_top, indented=True)
                        findings.append(
                            Finding(
                                path, line, 0, self.id,
                                f"unknown key '{key}.{sub}' (valid {section} fields: {sorted(valid)})",
                            )
                        )
        return findings

# Copy of yet_another_mobilenet_series_tpu/analysis/rules_contracts.py
# (the port's analyzer: pure-stdlib AST, no torch or jax import)
"""Wire-contract rules (YAMT022-025) on top of contracts.py and
exceptions.py (docs/LINT.md "Contract rules").

All four are project rules: each contract has a sending side and a
receiving side in different files (often different PROCESSES), so no
single-file check can see the drift. Scope matches YAMT019-021: package
code only (a dir with ``__init__.py``).
"""

from __future__ import annotations

from .concurrency import is_package_code
from .contracts import Site
from .core import Finding, Project, Rule, register


@register
class UnmappedEscapingException(Rule):
    id = "YAMT022"
    name = "unmapped-escaping-exception"
    description = (
        "a typed project exception can escape a serve submit path with no "
        "_ERROR_MAP entry: the verdict degrades to a generic 500 crossing the tier"
    )

    def check_project(self, project: Project) -> list[Finding]:
        em = project.contracts.error_map
        if em is None:
            return []
        exc_model = project.exceptions
        covered = list(dict.fromkeys(em.mapped)) + sorted(em.handled)
        out: list[Finding] = []
        seen: set[tuple[str, str]] = set()
        for mi in project.symbols.modules.values():
            if not is_package_code(mi.src.path):
                continue
            for ci in mi.classes.values():
                fi = ci.methods.get("submit")
                if fi is None:
                    continue
                for key in sorted(exc_model.escape_set(fi.qualname)):
                    if key not in exc_model.classes:
                        continue  # external types: out of this contract
                    # covered when it IS (or may be) a subtype of a mapped
                    # or hand-dispatched class — uncertainty stays silent
                    if any(exc_model.is_subtype(key, c) is not False for c in covered):
                        continue
                    if (fi.qualname, key) in seen:
                        continue
                    seen.add((fi.qualname, key))
                    exc_cls = exc_model.classes[key]
                    out.append(
                        Finding(
                            mi.src.path, fi.node.lineno, 0, self.id,
                            f"{exc_cls.name} (defined at {exc_cls.module.src.path}:"
                            f"{exc_cls.node.lineno}) can escape {ci.name}.submit but has "
                            f"no _ERROR_MAP entry ({em.path}:{em.line}): the frontend "
                            "degrades it to a generic 500 and the typed verdict is lost "
                            "crossing the tier; add a row (or catch it on the submit "
                            "path), or suppress with the sanctioned-idiom reason "
                            "(docs/LINT.md)",
                        )
                    )
        return out


@register
class WireHeaderDrift(Rule):
    id = "YAMT023"
    name = "wire-header-drift"
    description = (
        "a custom wire header is sent with no receiving-side parse, or parsed "
        "but never sent (dead parse)"
    )

    def check_project(self, project: Project) -> list[Finding]:
        c = project.contracts
        if not c.headers_sent and not c.headers_parsed:
            return []
        out: list[Finding] = []
        for name in sorted(set(c.headers_sent) - set(c.headers_parsed)):
            site = min(c.headers_sent[name], key=lambda s: (s.path, s.line))
            out.append(
                Finding(
                    site.path, site.line, 0, self.id,
                    f"header '{name}' is sent here but no receiving side parses it "
                    "(no headers.get/getheader/subscript read anywhere in the "
                    "package): the bytes cross the wire and die; parse it on the "
                    "receiving tier or stop sending it",
                )
            )
        for name in sorted(set(c.headers_parsed) - set(c.headers_sent)):
            site = min(c.headers_parsed[name], key=lambda s: (s.path, s.line))
            out.append(
                Finding(
                    site.path, site.line, 0, self.id,
                    f"header '{name}' is parsed here but no sending side ever sets "
                    "it: a dead parse that reads as a live contract; set it on the "
                    "sending tier or delete the parse",
                )
            )
        return out


@register
class MetricDrift(Rule):
    id = "YAMT024"
    name = "metric-drift"
    description = (
        "a registry metric name is emitted but absent from the OBSERVABILITY.md "
        "taxonomy, or a dotted per-label family is missing from PROM_LABEL_FAMILIES"
    )

    def check_project(self, project: Project) -> list[Finding]:
        c = project.contracts
        out: list[Finding] = []

        def first(sites: list[Site]) -> Site:
            return min(sites, key=lambda s: (s.path, s.line))

        fams = c.prom_families or set()
        for name in sorted(c.metric_literals):
            site = first(c.metric_literals[name])
            doc = c.doc_for(site.path)
            if doc is None:
                continue
            # a literal that samples a registered family ("fleet.slo_burn_
            # rate.short") is judged by its family's doc row, not its own
            fam = next(
                (f for f in fams if name.startswith(f + ".")), None)
            if not c.documented(fam or name, doc):
                out.append(
                    Finding(
                        site.path, site.line, 0, self.id,
                        f"metric '{name}' is emitted here but absent from the "
                        f"{_rel(doc)} taxonomy: an operator reading the docs never "
                        "learns it exists; add a taxonomy row (or rename to a "
                        "documented name)",
                    )
                )
        for fam in sorted(c.metric_families):
            site = first(c.metric_families[fam])
            if c.prom_families is not None and fam not in c.prom_families:
                out.append(
                    Finding(
                        site.path, site.line, 0, self.id,
                        f"per-label metric family '{fam}.<label>' is emitted here "
                        "but missing from PROM_LABEL_FAMILIES (obs/registry.py): "
                        "every sample renders as its own unlabeled series on "
                        "/metrics instead of one labeled family; register the "
                        "family prefix with its label name",
                    )
                )
            doc = c.doc_for(site.path)
            if doc is not None and not c.documented(fam, doc):
                out.append(
                    Finding(
                        site.path, site.line, 0, self.id,
                        f"metric family '{fam}.<label>' is emitted here but absent "
                        f"from the {_rel(doc)} taxonomy; add a taxonomy row",
                    )
                )
        return out


@register
class ConfigDrift(Rule):
    id = "YAMT025"
    name = "config-drift"
    description = (
        "a config dataclass section is not registered in _SECTION_TYPES, or a "
        "config field is never read by package code"
    )

    def check_project(self, project: Project) -> list[Finding]:
        schema = project.contracts.config
        if schema is None:
            return []
        out: list[Finding] = []
        for owner, field, ann, line in schema.section_fields:
            if ann in schema.registered:
                continue
            out.append(
                Finding(
                    schema.path, line, 0, self.id,
                    f"config section '{owner}.{field}: {ann}' is not registered in "
                    f"_SECTION_TYPES ({schema.path}:{schema.registry_line}): every "
                    f"dotted override of a {ann} field raises TypeError at build "
                    "time; add the class to _SECTION_TYPES",
                )
            )
        reads = project.contracts.attr_reads
        for owner, field, line in schema.plain_fields:
            if field in reads:
                continue
            out.append(
                Finding(
                    schema.path, line, 0, self.id,
                    f"config field '{owner}.{field}' is never read by package code "
                    "(no attribute access or getattr anywhere outside the schema "
                    "module): dead configuration that reads as a live knob; wire "
                    "it up or delete it, or suppress with the consumer's location "
                    "if it is read outside the package (docs/LINT.md)",
                )
            )
        return out


def _rel(path: str) -> str:
    parts = path.replace("\\", "/").split("/")
    return "/".join(parts[-2:])

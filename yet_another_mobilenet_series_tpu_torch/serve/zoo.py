# Copy of yet_another_mobilenet_series_tpu/serve/zoo.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Multi-model zoo: N named InferenceBundles behind one serving process.

Every process used to serve exactly one bundle; the ROADMAP's north star
(efficientnet_b0 + mobilenet_v3_small + AtomNAS-searched exports behind one
front door, FLASH/LANA-style cheap-model-first cascading as the dominant
cost lever) needs a **zoo**: one engine holding several named models, each
with its own AOT ladder keyed ``(model, bucket, image_size, K)``
(serve/engine.py) while sharing the slot pool, the dispatch path, and the
admission edge (per-model quotas, serve/admission.py).

:class:`ModelZoo` is the configuration spine of that subsystem: it loads
and names the bundles from a ``serve.zoo`` config block
(config.ZooConfig), resolves the default tenant, carries per-model quotas
and image-size ladders, and produces the kwargs the engine, the admission
controller, and the lease registration each need. The ON-WIRE identity is
the ``X-Model`` header (serve/frontend.py -> RequestContext.model ->
batcher (model, shape) grouping -> engine tenant dispatch); the FLEET
identity is the lease advertisement ``{model_name: digest}``
(:meth:`lease_models`), which the router uses for model-aware placement
(route only to replicas advertising the request's model) and for the
mixed-version refusal: two replicas claiming one model name with different
content digests (serve/export.py ``bundle_digest``) is a registration
error, not a silent lottery over which weights answer.

Config spec grammar (all plain strings so they ride ``--serve.zoo.*``
CLI overrides; see config.ZooConfig):

- ``models``:       ``"small=/b/small,big=/b/big"`` — name=bundle-dir pairs
- ``placement``:    ``"small|big;big"`` — ';'-separated per-slot groups of
                    '|'-joined names; fleet slot i serves group
                    ``i % len(groups)`` (cli/fleet.py spawns each slot with
                    a models= subset override)
- ``quotas``:       ``"small=64,big=16"`` — per-model in-system caps
- ``image_sizes``:  ``"small=160|192,big=224"`` — per-model warm ladders

This module is import-light (no jax at module scope): the jax-free fleet
supervisor (cli/fleet.py) uses the parsers for placement without paying —
or breaking on — a jax import; bundle loading is deferred to
:meth:`ModelZoo.from_config`.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def _valid_name(name: str) -> bool:
    return bool(name) and name.replace("-", "").replace("_", "").isalnum()


def parse_models(spec: str) -> dict[str, str]:
    """``"small=/b/small,big=/b/big"`` -> ``{"small": "/b/small", ...}``.
    Names must be ``[A-Za-z0-9_-]`` (they become metric-family components);
    duplicates and empty entries are errors, order is preserved (the first
    name is the default tenant unless ``zoo.default`` overrides)."""
    out: dict[str, str] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, sep, path = part.partition("=")
        name, path = name.strip(), path.strip()
        if not sep or not path:
            raise ValueError(f"zoo.models entry {part!r} is not name=/bundle/dir")
        if not _valid_name(name):
            raise ValueError(f"zoo model name {name!r} must be non-empty [A-Za-z0-9_-]")
        if name in out:
            raise ValueError(f"zoo model {name!r} named twice")
        out[name] = path
    return out


def parse_placement(spec: str, models: Sequence[str]) -> list[tuple[str, ...]]:
    """``"small|big;big"`` -> ``[("small", "big"), ("big",)]``. Every name
    must be a configured model, every configured model must appear in at
    least one group (an unplaced model would be unroutable), and no group
    may be empty. Empty spec -> one group serving everything (no sharding)."""
    models = tuple(models)
    if not spec.strip():
        return [models]
    groups: list[tuple[str, ...]] = []
    for chunk in spec.split(";"):
        names = tuple(n.strip() for n in chunk.split("|") if n.strip())
        if not names:
            raise ValueError(f"zoo.placement has an empty slot group in {spec!r}")
        for n in names:
            if n not in models:
                raise ValueError(f"zoo.placement names unknown model {n!r}; configured: {models}")
        groups.append(names)
    placed = {n for g in groups for n in g}
    missing = [m for m in models if m not in placed]
    if missing:
        raise ValueError(f"zoo.placement leaves {missing} on no slot — they would be unroutable")
    return groups


def slot_models(groups: Sequence[Sequence[str]], slot: int) -> tuple[str, ...]:
    """The model subset fleet slot ``slot`` serves: placement groups repeat
    cyclically over slots, so 2 groups on a 4-replica fleet give each group
    two replicas."""
    return tuple(groups[slot % len(groups)])


def slot_overrides(zc, slot: int) -> list[str]:
    """The per-slot replica argv overrides cli/fleet.py appends under
    model-sharded placement: the slot's ``models=`` subset, with quotas /
    image_sizes / default filtered to it (a replica config naming a model
    it does not load is a validation error by design) and ``placement``
    cleared (a replica serves its whole assignment)."""
    paths = parse_models(zc.models)
    groups = parse_placement(zc.placement, list(paths))
    names = slot_models(groups, slot)
    quotas = {n: v for n, v in parse_quotas(zc.quotas).items() if n in names}
    sizes = {n: v for n, v in parse_image_sizes(zc.image_sizes).items() if n in names}
    default = zc.default if zc.default in names else names[0]
    return [
        "serve.zoo.models=" + ",".join(f"{n}={paths[n]}" for n in names),
        "serve.zoo.placement=",
        f"serve.zoo.default={default}",
        "serve.zoo.quotas=" + ",".join(f"{n}={v}" for n, v in quotas.items()),
        "serve.zoo.image_sizes=" + ",".join(
            f"{n}=" + "|".join(str(s) for s in v) for n, v in sizes.items()),
    ]


def _parse_per_model(spec: str, what: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, sep, val = part.partition("=")
        name, val = name.strip(), val.strip()
        if not sep or not val:
            raise ValueError(f"zoo.{what} entry {part!r} is not name=value")
        if name in out:
            raise ValueError(f"zoo.{what} names {name!r} twice")
        out[name] = val
    return out


def parse_quotas(spec: str) -> dict[str, int]:
    """``"small=64,big=16"`` -> per-model in-system caps (admission)."""
    out = {}
    for name, val in _parse_per_model(spec, "quotas").items():
        quota = int(val)
        if quota < 1:
            raise ValueError(f"zoo quota for {name!r} must be >= 1, got {quota}")
        out[name] = quota
    return out


def parse_image_sizes(spec: str) -> dict[str, tuple[int, ...]]:
    """``"small=160|192,big=224"`` -> per-model warm image-size ladders."""
    out = {}
    for name, val in _parse_per_model(spec, "image_sizes").items():
        sizes = tuple(sorted({int(s) for s in val.split("|") if s.strip()}))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"zoo image sizes for {name!r} must be positive, got {val!r}")
        out[name] = sizes
    return out


class ModelZoo:
    """The loaded tenant set of one serving process.

    Holds name -> :class:`~.export.InferenceBundle`, the default tenant,
    per-model quotas and image-size ladders, and each bundle's content
    digest. The engine/admission/lease layers each take their slice via
    :meth:`engine_kwargs` / :meth:`admission_kwargs` / :meth:`lease_models`
    — the zoo is configuration, not a dispatch path.
    """

    def __init__(
        self,
        bundles: Mapping[str, "object"],
        *,
        default: str | None = None,
        quotas: Mapping[str, int] | None = None,
        image_sizes: Mapping[str, Sequence[int]] | None = None,
    ):
        if not bundles:
            raise ValueError("a ModelZoo needs at least one model")
        for name in bundles:
            if not _valid_name(name):
                raise ValueError(f"zoo model name {name!r} must be non-empty [A-Za-z0-9_-]")
        self._bundles = dict(bundles)
        self._default = default or next(iter(self._bundles))
        if self._default not in self._bundles:
            raise ValueError(
                f"zoo.default {self._default!r} not among models {tuple(self._bundles)}")
        for scope, mapping in (("quotas", quotas), ("image_sizes", image_sizes)):
            for name in (mapping or {}):
                if name not in self._bundles:
                    raise ValueError(f"zoo.{scope} names unknown model {name!r}")
        self._quotas = dict(quotas or {})
        self._image_sizes = {k: tuple(v) for k, v in (image_sizes or {}).items()}

    # -- identity ------------------------------------------------------------

    @property
    def models(self) -> tuple[str, ...]:
        return tuple(self._bundles)

    @property
    def default(self) -> str:
        return self._default

    @property
    def bundles(self) -> dict:
        return dict(self._bundles)

    def bundle(self, name: str):
        return self._bundles[name]

    def digests(self) -> dict[str, str | None]:
        """name -> stamped content digest (None for a pre-zoo bundle)."""
        return {name: b.meta.get("digest") for name, b in self._bundles.items()}

    # -- per-layer kwargs ----------------------------------------------------

    def engine_kwargs(self) -> dict:
        """The multi-tenant slice of InferenceEngine's constructor."""
        return {
            "models": dict(self._bundles),
            "default_model": self._default,
            "model_image_sizes": dict(self._image_sizes),
        }

    def admission_kwargs(self) -> dict:
        """The zoo slice of AdmissionController.from_config."""
        return {
            "models": self.models,
            "default_model": self._default,
            "model_quotas": dict(self._quotas),
        }

    def lease_models(self) -> dict[str, str]:
        """The lease advertisement: name -> digest ('' when unstamped). The
        router keys placement on the names and refuses a registration whose
        digest conflicts with another live replica's for the same name."""
        return {name: (d or "") for name, d in self.digests().items()}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, zc) -> "ModelZoo":
        """Load a zoo from a config.ZooConfig block. Each bundle loads (and
        digest-verifies, serve/export.py) from its directory; a bundle
        stamped with a model_name DIFFERENT from its configured name is
        refused — an alias pointing at the wrong artifact is exactly the
        identity confusion the stamp exists to catch."""
        from .export import load_bundle  # deferred: keeps this module jax-free

        paths = parse_models(zc.models)
        if not paths:
            raise ValueError("serve.zoo.models is empty; nothing to serve")
        bundles = {}
        for name, path in paths.items():
            b = load_bundle(path)
            stamped = b.meta.get("model_name")
            if stamped is not None and stamped != name:
                raise ValueError(
                    f"bundle at {path!r} is stamped model_name={stamped!r} but configured "
                    f"as {name!r}; aliasing a bundle across names defeats the digest identity"
                )
            bundles[name] = b
        return cls(
            bundles,
            default=zc.default or None,
            quotas=parse_quotas(zc.quotas),
            image_sizes=parse_image_sizes(zc.image_sizes),
        )

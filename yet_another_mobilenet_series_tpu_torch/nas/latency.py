# Copy of yet_another_mobilenet_series_tpu/nas/latency.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Measured-latency lookup table for latency-aware NAS (ROADMAP item 3).

The AtomNAS penalty weights each expanded channel ("atom") by its FLOPs
cost — but FLOPs is a poor proxy for measured latency (PAPERS.md: FLASH
arXiv 2108.00568, LANA arXiv 2107.10624): a 7x7 depthwise group and a 1x1
matmul column with equal MACs cost very different wall time on real
hardware. This module is the CONSUMER side of the measured alternative:
``scripts/latency_table.py`` benches every distinct block configuration of a
network at several expanded-channel widths through the serving AOT path and
writes a ``LATENCY_TABLE_*.json`` artifact (bench-contract shape,
provenance-stamped); :class:`LatencyTable` loads it and turns the
measurements into per-atom cost vectors via the FLASH/LANA recipe — fit
latency as a linear function of alive expanded channels and take the SLOPE
(seconds per atom) as each atom's marginal cost.

Keying: a block's measurement is looked up by its structural signature —
(in_channels, out_channels, expanded_channels, kernel_sizes, stride,
se_channels, input image size) via :func:`block_key`. The table is built FOR
a network (or a superset of its blocks), so a missing key is a hard error:
silently falling back to FLOPs would quietly un-measure the search
objective. ``nas/penalty.py`` selects this path with
``prune.cost="latency_table"`` + ``prune.latency_table=<path>`` (flag-gated;
the FLOPs default is untouched).

The per-atom slope is uniform across a block's atoms: the measurement prunes
whole width fractions, which removes channels from every kernel branch
proportionally, so the slope is the blended marginal channel cost. A
per-BRANCH slope (prune one kernel group at a time) is the natural
refinement once real-hardware tables exist — the artifact schema already
carries the kernel layout for it.
"""

from __future__ import annotations

import json

import numpy as np

from ..models.specs import Network
from ..ops.blocks import InvertedResidual


def block_key(spec: InvertedResidual, image_size: int, expanded: int | None = None) -> str:
    """Canonical signature of one measurable block configuration. ``expanded``
    overrides the spec's expanded width (the bench measures several widths of
    the SAME block family under one family key, so the family key uses the
    full width while each measurement row records its own alive channels)."""
    e = spec.expanded_channels if expanded is None else expanded
    k = ".".join(str(int(x)) for x in spec.kernel_sizes)
    return (
        f"in{spec.in_channels}_out{spec.out_channels}_e{e}_k{k}"
        f"_s{spec.stride}_se{spec.se_channels}_hw{image_size}"
    )


def block_input_sizes(net: Network, image_size: int | None = None) -> list[int]:
    """Input spatial resolution of every block — the ``hw`` half of each
    block's table key (same stride arithmetic as utils/profiling.py)."""
    hw = image_size or net.image_size
    hw = (hw - 1) // net.stem.stride + 1
    sizes = []
    for blk in net.blocks:
        sizes.append(hw)
        hw = (hw - 1) // blk.stride + 1
    return sizes


class LatencyTable:
    """Loaded ``LATENCY_TABLE_*.json``: family key -> (alive channel ladder,
    measured latency ladder), plus the artifact's provenance block."""

    def __init__(self, entries: dict[str, dict], provenance: dict | None = None):
        if not entries:
            raise ValueError("latency table has no entries")
        self.entries = entries
        self.provenance = dict(provenance or {})
        for key, e in entries.items():
            ch, lat = np.asarray(e["alive_channels"], np.float64), np.asarray(e["latency_s"], np.float64)
            if ch.shape != lat.shape or ch.size < 2:
                raise ValueError(f"table entry {key!r} needs >=2 (channels, latency) pairs")
            if np.any(lat <= 0):
                raise ValueError(f"table entry {key!r} has non-positive latency")

    @classmethod
    def load(cls, path: str) -> "LatencyTable":
        with open(path) as f:
            doc = json.load(f)
        entries = {e["key"]: e for e in doc.get("entries", [])}
        return cls(entries, provenance=doc.get("provenance"))

    def _entry(self, spec: InvertedResidual, image_size: int) -> dict:
        key = block_key(spec, image_size)
        e = self.entries.get(key)
        if e is None:
            raise KeyError(
                f"no latency measurement for block {key!r}; regenerate the table "
                f"with scripts/latency_table.py for this network/image size "
                f"(table has {len(self.entries)} entries)"
            )
        return e

    def block_latency(self, spec: InvertedResidual, image_size: int) -> float:
        """Measured per-image latency (seconds) at full width, interpolated
        on the alive-channel ladder."""
        e = self._entry(spec, image_size)
        ch = np.asarray(e["alive_channels"], np.float64)
        lat = np.asarray(e["latency_s"], np.float64)
        order = np.argsort(ch)
        return float(np.interp(spec.expanded_channels, ch[order], lat[order]))

    def atom_cost(self, spec: InvertedResidual, image_size: int) -> np.ndarray:
        """Per-atom marginal latency (seconds per expanded channel): the
        least-squares slope of measured latency vs alive channels, floored at
        a tiny positive fraction of the mean per-channel latency so a noisy
        flat measurement cannot zero (or invert) the penalty pressure."""
        e = self._entry(spec, image_size)
        ch = np.asarray(e["alive_channels"], np.float64)
        lat = np.asarray(e["latency_s"], np.float64)
        slope = float(np.polyfit(ch, lat, 1)[0])
        floor = 1e-3 * float(np.mean(lat / ch))
        return np.full(spec.expanded_channels, max(slope, floor), np.float64)

    def atom_cost_table(self, net: Network, blocks: set[int] | None = None,
                        image_size: int | None = None) -> tuple[dict[int, np.ndarray], float]:
        """({block index: per-atom seconds vector}, total measured block
        latency at full width) for ``net`` — the measured twin of
        utils/profiling.py's MACs table; the total is the normalizer
        ``prune.normalize_cost`` divides by (resolution-independent rho)."""
        sizes = block_input_sizes(net, image_size)
        costs: dict[int, np.ndarray] = {}
        total = 0.0
        for i, blk in enumerate(net.blocks):
            total += self.block_latency(blk, sizes[i])
            if blocks is None or i in blocks:
                costs[i] = self.atom_cost(blk, sizes[i])
        return costs, total

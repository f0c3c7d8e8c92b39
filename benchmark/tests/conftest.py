"""Fixtures of the benchmark's own tests: a checkout in miniature (the benchmark's files, its cells
at 32x32 images, small batches and few requests, each configuration at its published widths),
and the card's look, made inside a test and never while a module is imported."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# what the miniature cells change: every width stays the paper's
TINY_CONFIG = {"data.image_size": 32, "model.num_classes": 10}
TINY_TRAFFIC = {
    "train_b512": {"batch": 8, "pool_batches": 4, "trace_steps": 2},
    "train_b256": {"batch": 8, "pool_batches": 4, "trace_steps": 2},
    "serve_bulk": {"clients": 2, "min_images": 2, "max_images": 70, "count": 8, "pool_rows": 128, "trace_seconds": 1},
}


def make_tiny_root(dest: Path, *, compute_dtype: str = "float32", limits: dict | None = None) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dest`` with the miniature cells;
    ``limits`` (cell -> {name: limit}) replaces those cells' limits."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest)
    for conf in (dest / "benchmark" / "configs").glob("*.json"):
        doc = json.loads(conf.read_text())
        for dotted, value in TINY_CONFIG.items():
            section, key = dotted.split(".")
            doc[section][key] = value
        doc["train"]["compute_dtype"] = compute_dtype
        conf.write_text(json.dumps(doc))
    for name, changes in TINY_TRAFFIC.items():
        path = dest / "benchmark" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **changes}))
    for cell, lim in (limits or {}).items():
        path = dest / "benchmark" / "workloads" / f"{cell}.json"
        doc = json.loads(path.read_text())
        doc["limits"] = lim
        path.write_text(json.dumps(doc))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


@pytest.fixture
def needs_card():
    """The repository's card tests skip here; this one decides inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures and checks on the card)")
    return torch.device("cuda", 0)

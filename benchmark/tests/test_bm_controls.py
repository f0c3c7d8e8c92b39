"""The controls of ``correct``: the plain reference put in the program's place, in the precision
just below the configuration's, has to come out as not correct.

On the card (skipped here): each cell at its own size, one seed, against the committed limits;
``python3 -m benchmark.calibrate`` reads the same on a dozen seeds. On the CPU: the miniature
training cells, where the FP8 control and the half-batch fault read far above the float32
program (TF32 does not exist on the CPU, so the serving control is the card's alone)."""

from __future__ import annotations

import importlib

import pytest
import torch

from benchmark.frozen.trace import Spans
from benchmark.run import ROOT, Tracer, load_cell

CELLS = [w["name"] for w in __import__("json").loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run_cell(cell, seed, device, seconds):
    kind = importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")
    runner = kind.Runner(cell, seed, device, Spans(False))
    runner.setup()
    runner.window(seconds, Tracer(False, device, None))
    runner.release()
    return runner


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_committed_limit_on_the_card(name, needs_card):
    cell = load_cell(name)
    runner = _run_cell(cell, 2**31 + 1001, needs_card, 3.0)
    control = runner.control()
    limits = cell.spec["limits"]
    assert any(v["value"] > limits[k] for k, v in control.items() if k in limits), control


@pytest.mark.parametrize("name", ["mobilenet_v3_large.train_b512", "efficientnet_b0.train_b256"])
def test_the_fp8_control_and_the_half_batch_read_far_above_the_program(name, tiny_root):
    runner = _run_cell(load_cell(name, tiny_root), 33, torch.device("cpu"), 0.0)
    program = runner.check()
    for numbers in (runner.control(), runner.faults()["half_batch"]):
        assert max(numbers[k]["value"] / max(program[k]["value"], 1e-12) for k in numbers) > 100

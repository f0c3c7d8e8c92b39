"""The plain reference held against the port on the CPU, at the papers' widths, 32x32 images and a
small batch, in float32: the same drawn weights give the same layout, noise, eval forward,
served (folded, K1's plain path) forward and three train steps. The reference imports nothing of
the port; this test imports both."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.frozen import costs
from benchmark.reference import compare, nets
from benchmark.reference import train as ref_train

from .conftest import REPO

ARCHS = ("mobilenet_v3_large", "efficientnet_b0")
MODEL = {
    "mobilenet_v3_large": {"arch": "mobilenet_v3_large", "width_mult": 1.0, "num_classes": 10, "dropout": 0.2,
                           "bn_momentum": 0.1, "bn_eps": 1e-5},
    "efficientnet_b0": {"arch": "efficientnet_b0", "width_mult": 1.0, "num_classes": 10, "dropout": 0.2,
                        "bn_momentum": 0.01, "bn_eps": 1e-3, "drop_connect": 0.2},
}


def _port_net(name, image_size=32):
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    return get_model(ModelConfig(**MODEL[name]), image_size=image_size)


@pytest.mark.parametrize("name", ARCHS)
def test_the_drawn_layout_is_the_ports_at_published_widths(name):
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree

    params, state = _full_net(name).init(torch.Generator().manual_seed(0))
    arch = nets.from_config(dict(MODEL[name], num_classes=1000))
    assert {k: tuple(v.shape) for k, v in flatten_tree(params).items()} == nets.param_shapes(arch)
    drawn_p, drawn_s = inputs.weights(arch, 3, "cpu")
    assert {k: tuple(v.shape) for k, v in flatten_tree(state).items()} == {k: tuple(v.shape) for k, v in drawn_s.items()}
    assert set(drawn_p) == set(nets.param_shapes(arch))


@pytest.mark.parametrize("name,macs", [("mobilenet_v3_large", 219), ("efficientnet_b0", 386)])
def test_the_frozen_mac_count_is_the_ports_profile(name, macs):
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

    arch = nets.from_config(dict(MODEL[name], num_classes=1000))
    counted = costs.forward_macs(arch, 224)
    assert counted == profile_network(_full_net(name), 224).total_macs
    assert round(counted / 1e6) in range(macs - 2, macs + 3)


def _full_net(name):
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    return get_model(ModelConfig(**dict(MODEL[name], num_classes=1000)), image_size=224)


@pytest.mark.parametrize("name", ARCHS)
def test_the_noise_is_drawn_as_the_step_draws_it(name):
    net, arch = _port_net(name), nets.from_config(MODEL[name])
    ours = nets.draw_noise(arch, torch.Generator().manual_seed(5), 6, "cpu")
    theirs = net.draw_noise(torch.Generator().manual_seed(5), 6, "cpu")
    assert set(ours["drop_path"]) == set(theirs["drop_path"])
    for k, v in ours["drop_path"].items():
        assert torch.equal(v, theirs["drop_path"][k])
    assert torch.equal(ours["dropout"], theirs["dropout"])


@pytest.mark.parametrize("name", ARCHS)
def test_eval_forward_and_the_folded_served_forward_agree_with_the_reference(name):
    from yet_another_mobilenet_series_tpu_torch.serve.export import apply_folded, fold_network, prepare_folded

    net, arch = _port_net(name), nets.from_config(MODEL[name])
    params, state = inputs.weights(arch, 11, "cpu")
    x = inputs.images(11, "eval", 3, 32, "cpu")
    ref = nets.forward(arch, params, state, x)
    port = net.apply(inputs.nest(params), inputs.nest(state), x)
    folded = prepare_folded(net, fold_network(net, inputs.nest(params), inputs.nest(state)), device="cpu")
    served = apply_folded(net, folded, x)
    assert ref.std() > 0.1  # the drawn statistics keep the logits apart
    for got in (port, served):
        gap, _ = compare.logit_gap(got.numpy(), ref.numpy())
        assert gap < 1e-4


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_agree_with_the_port_in_float32(name, tiny_root):
    """The cell's own runner, run at float32 on the CPU: every number the check compares is at
    float32 rounding."""
    import importlib

    from benchmark.frozen.trace import Spans
    from benchmark.run import Tracer, load_cell

    cell = load_cell(f"{name}.{'train_b512' if name.startswith('mobilenet') else 'train_b256'}", tiny_root)
    kind = importlib.import_module("benchmark.traffic.train")
    runner = kind.Runner(cell, 21, torch.device("cpu"), Spans(False))
    runner.setup()
    runner.window(0.0, Tracer(False, torch.device("cpu"), None))
    runner.release()
    numbers = runner.check()
    assert numbers["loss"]["value"] < 1e-5
    assert numbers["grad"]["value"] < 1e-3
    assert numbers["change"]["value"] < 1e-2
    assert numbers["bn_stats"]["value"] < 1e-4
    assert numbers["ema"]["value"] < 2e-3  # a shadow near 1 moved by about 1e-5 a step
    assert numbers["ema_stats"]["value"] < 1e-2


def test_the_lr_is_the_recipes_at_the_start_step():
    from yet_another_mobilenet_series_tpu_torch.config import ScheduleConfig
    from yet_another_mobilenet_series_tpu_torch.train.schedules import make_lr_schedule

    cfg = {"optim": {"rmsprop_decay": 0.9, "rmsprop_eps": 2e-3, "momentum": 0.9, "weight_decay": 1e-5,
                     "label_smoothing": 0.1},
           "schedule": {"base_lr": 0.064, "scale_by_batch": True, "warmup_epochs": 5.0, "decay_rate": 0.963,
                        "decay_epochs": 3.0},
           "ema": {"decay": 0.9999}, "run": {"start_step": 12510}, "data": {"num_train_examples": 1281167}}
    recipe = ref_train.Recipe.from_config(cfg, 512)
    lr_fn = make_lr_schedule(ScheduleConfig(**cfg["schedule"]), 512, 1281167 // 512, 350)
    for step in (0, 100, 12509, 12510, 20000, 40000):
        assert abs(recipe.lr(step) - float(lr_fn(step))) <= 1e-7 * max(recipe.lr(step), 1e-3)
    assert recipe.lr(12510) == pytest.approx(0.128)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.nets, benchmark.reference.train, benchmark.reference.lowp, "
            "benchmark.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True).stdout
    top = set(eval(out))
    assert not top & {"yet_another_mobilenet_series_tpu_torch", "yet_another_mobilenet_series_tpu", "jax", "jaxlib"}


def test_the_logit_gap_is_by_the_worst_row():
    ref = np.ones((3, 4))
    prog = ref.copy()
    prog[2, 1] += 0.5
    assert compare.logit_gap(prog, ref) == (0.5, 2)

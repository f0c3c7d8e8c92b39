"""The five families that the port's other tests only build (MobileNetV1,
MNASNet-A1, EfficientNet-B0, EfficientNet-Lite0 and the AtomNAS-C+SE
supernet) against the JAX package, on the CPU: the eval-form logits and the
folded bundle served through the port's engine.

Each net is built at its published width from its shipped config (the
apps; EfficientNet-Lite0 has none and takes the arch's defaults) at 64 px.
The weights are made with numpy in the JAX layouts, their tree's keys and
shapes from ``jax.eval_shape`` of the JAX init (no init runs), carried into
the port by models/convert.py; BN running statistics come from a seed.
Eval logits are held to tests/test_torch_parity.py's float32 bar (rtol
1e-4, atol 1e-5); a bundle exported by the JAX package, served by the
port's ``InferenceEngine``, to JAX's ``apply_folded`` at FOLD_ATOL
(tests/test_serve.py). The training forward, the gradients and the SE
search are tests/test_torch_port_families_train.py.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.config import parse_cli as jax_parse_cli
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

from test_torch_port_models import _jax_tree, _jax_weights_with_seeded_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps")
JAX_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu", "apps")
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py's float32 forward bar
FOLD_ATOL = 1e-4  # tests/test_serve.py: folded logits vs the reference forward
SIZE, BATCH = 64, 2
# each family's shipped config (None: the arch's defaults)
FAMILIES = {"mobilenet_v1": "mobilenet_v1", "mnasnet_a1": "mnasnet_a1_v4_8", "efficientnet_b0": "efficientnet_b0",
            "efficientnet_lite0": None, "atomnas_supernet_se": "atomnas_c_se"}


def model_configs(arch, **overrides):
    """(JAX ModelConfig, port ModelConfig) of ``arch`` as its app ships it."""
    app = FAMILIES[arch]
    argv = [f"model.{k}={v}" for k, v in overrides.items()]
    if app is None:
        return (jax_parse_cli([f"model.arch={arch}", *argv]).model, parse_cli([f"model.arch={arch}", *argv]).model)
    return (jax_parse_cli([f"app:{os.path.join(JAX_APPS, app + '.yml')}", *argv]).model,
            parse_cli([f"app:{os.path.join(PORT_APPS, app + '.yml')}", *argv]).model)


def family_nets(arch, image_size=SIZE, **overrides):
    jcfg, pcfg = model_configs(arch, **overrides)
    assert isinstance(jcfg, JaxModelConfig) and isinstance(pcfg, ModelConfig) and pcfg.arch == arch
    return jax_get_model(jcfg, image_size=image_size), get_model(pcfg, image_size=image_size)


def images(seed, n=BATCH, size=SIZE):
    return np.random.RandomState(seed).normal(0, 1, (n, size, size, 3)).astype(np.float32)


def test_the_families_are_what_their_configs_ship():
    """The parts these nets add to the zoo's tested ones: MobileNetV1's
    blocks without an expand conv and with an activation after the project
    conv, SE gates (sigmoid) with relu (MNASNet-A1, C+SE) or swish
    (EfficientNet-B0) inside, swish, the drop_connect ramp, and C+SE's
    three-way branches at the pinned stem/head widths."""
    nets = {arch: family_nets(arch)[1] for arch in FAMILIES}
    v1 = nets["mobilenet_v1"].blocks
    assert not any(b.has_expand or b.has_residual or b.se_channels for b in v1)
    assert {(b.active_fn, b.project_act) for b in v1} == {("relu", "relu")}
    se = {arch: {(b.active_fn, b.se_gate_fn, b.se_inner_act) for b in net.blocks if b.se_channels}
          for arch, net in nets.items()}
    assert se["mnasnet_a1"] == {("relu", "sigmoid", "relu")}
    assert se["efficientnet_b0"] == {("swish", "sigmoid", "swish")}
    assert se["atomnas_supernet_se"] == {("swish", "sigmoid", "relu")}
    assert not se["efficientnet_lite0"] and not se["mobilenet_v1"]
    assert max(b.drop_path for b in nets["efficientnet_b0"].blocks) > 0
    cse = nets["atomnas_supernet_se"]
    assert cse.stem.out_channels == 32 and cse.head.out_channels == 1280
    assert any(len(b.group_channels) == 3 for b in cse.blocks)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_eval_logits_match_jax(arch):
    jnet, pnet = family_nets(arch)
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=21)
    x = images(22)
    want, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=False))(_jax_tree(params), _jax_tree(state),
                                                                        jnp.asarray(x))
    with torch.inference_mode():
        got = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x))
    assert got.shape == (BATCH, 1000) and np.abs(np.asarray(want)).max() > 1e-3  # the bar compares real numbers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_jax_bundle_served_by_the_port_engine_matches_jax_apply_folded(tmp_path, arch):
    jnet, pnet = family_nets(arch)
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=23)
    out = str(tmp_path / arch)
    jax_export.export_bundle(jnet, _jax_tree(params), _jax_tree(state), out, model_name=arch)
    bundle = export.load_bundle(out)  # verifies the digest JAX stamped
    assert bundle.net == pnet and bundle.model_name == arch
    jb = jax_export.load_bundle(out)
    x = images(24)
    want = np.asarray(jax.jit(lambda p, x: jax_export.apply_folded(jb.net, p, x))(jb.params, jnp.asarray(x)))
    engine = InferenceEngine(bundle, device="cpu", buckets=(1, BATCH))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(engine.predict(x), want, atol=FOLD_ATOL, rtol=0)
    np.testing.assert_allclose(engine.predict(x[:1]), want[:1], atol=FOLD_ATOL, rtol=0)  # bucket 1

"""The port's models (models/specs.py, zoo.py, serialize.py, convert.py) and
eval forward against the JAX package's, on the CPU.

Both packages build networks from the same spec grammar and tables; weights
made on one side are carried to the other by models/convert.py, and the
eval-form logits are held to tests/test_torch_parity.py's float32 bar
(rtol 1e-4, atol 1e-5). BN running statistics are drawn from a seed with
models/specs.py random_bn_state, which keeps the activations of order one
through the depth, so the bar compares real numbers and not zeros.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.serialize import network_to_dict as jax_to_dict
from yet_another_mobilenet_series_tpu.models.zoo import ARCHS as JAX_ARCHS
from yet_another_mobilenet_series_tpu.ops.layers import make_divisible as jax_make_divisible
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.serialize import (
    network_from_dict, network_to_dict, spec_is_inference)
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.models.zoo import ARCHS
from yet_another_mobilenet_series_tpu_torch.ops.layers import make_divisible

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_parity.py's float32 forward bar

TINY_SPECS = [
    {"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
    {"t": 3, "c": 16, "n": 2, "s": 2, "act": "hswish"},
]


def _both(arch="mobilenet_v2", width=1.0, image_size=224, **kw):
    jnet = jax_get_model(JaxModelConfig(arch=arch, width_mult=width, **kw), image_size=image_size)
    pnet = get_model(ModelConfig(arch=arch, width_mult=width, **kw), image_size=image_size)
    return jnet, pnet


def _jax_tree(flat_np):
    """'/'-keyed numpy arrays -> the nested jnp tree the JAX package applies."""
    out = {}
    for path, v in flat_np.items():
        *parents, leaf = path.split("/")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = jnp.asarray(v)
    return out


def numpy_params(jnet, seed):
    """Parameters in the JAX layouts made with numpy from a seed, at the
    scale of the JAX package's own init (kaiming fan_out convs, N(0, 0.01)
    dense, U(+-1/sqrt(fan_in)) SE), with non-trivial BN affines and biases
    so every term of the forward is exercised. The tree's keys and shapes
    come from the JAX package's init, traced without running it."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))[0]
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(p.key for p in path)
        shape = tuple(s.shape)
        if len(shape) == 4:
            a = rng.normal(0, np.sqrt(2.0 / (shape[0] * shape[1] * shape[3])), shape)
        elif len(shape) == 2:
            bound = 1.0 / np.sqrt(shape[0])
            a = rng.uniform(-bound, bound, shape) if "/se/" in key else rng.normal(0, 0.01, shape)
        elif key.endswith("gamma"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # BN beta, biases
            a = rng.normal(0, 0.05, shape)
        out[key] = a.astype(np.float32)
    return out


def _jax_weights_with_seeded_stats(jnet, pnet, seed):
    """numpy-made params + the port's seeded BN state, both as '/'-keyed
    numpy arrays in the JAX layouts."""
    state = convert.to_jax(random_bn_state(pnet, torch.Generator().manual_seed(seed)))
    return numpy_params(jnet, seed), state


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
@pytest.mark.parametrize("width", [0.5, 1.0])
def test_network_to_dict_and_param_count_match_jax(arch, width):
    jnet, pnet = _both(arch, width)
    assert network_to_dict(pnet) == jax_to_dict(jnet)
    assert network_to_dict(pnet, inference=True) == jax_to_dict(jnet, inference=True)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))
    params, state = pnet.init(torch.Generator().manual_seed(0))
    for jax_tree, port_tree in zip(shapes, (params, state)):
        want = {"/".join(p.key for p in path): tuple(s.shape)
                for path, s in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
        got = {k: v.shape for k, v in convert.to_jax(port_tree).items()}
        assert got == want  # same keys, same shapes after the layout map
        assert sum(int(np.prod(s)) for s in got.values()) == sum(int(np.prod(s)) for s in want.values())


def test_arch_tables_are_the_jax_tables():
    assert set(ARCHS) == set(JAX_ARCHS)
    for name, arch in ARCHS.items():
        ja = JAX_ARCHS[name]
        assert arch.block_specs == ja.block_specs
        assert {f: getattr(arch, f) for f in arch.__dataclass_fields__} == \
            {f: getattr(ja, f) for f in ja.__dataclass_fields__}


@pytest.mark.parametrize("v", [3.0, 7.9, 16 * 0.35, 96 * 1.3, 1000.0, 0.1])
def test_make_divisible_matches_jax(v):
    assert make_divisible(v) == jax_make_divisible(v)
    assert make_divisible(v, 4) == jax_make_divisible(v, 4)


def test_serialize_round_trip_and_jax_payload():
    jnet, pnet = _both("atomnas_supernet_se", 0.5)
    payload = jax_to_dict(jnet, inference=True)
    back = network_from_dict(payload)
    assert back == pnet
    assert spec_is_inference(payload) and not spec_is_inference(network_to_dict(pnet))
    v1 = dict(network_to_dict(pnet))
    v1["schema"] = 1
    del v1["inference"]
    assert network_from_dict(v1) == pnet
    with pytest.raises(ValueError, match="schema"):
        network_from_dict({**v1, "schema": 3})


def test_convert_round_trip_and_layouts():
    rng = np.random.RandomState(0)
    flat = {"stem/conv/w": rng.normal(size=(3, 3, 3, 16)).astype(np.float32),
            "blocks/0/dw0_k5/w": rng.normal(size=(5, 5, 1, 24)).astype(np.float32),
            "classifier/w": rng.normal(size=(32, 10)).astype(np.float32),
            "classifier/b": rng.normal(size=(10,)).astype(np.float32)}
    tree = convert.from_jax(flat)
    assert tuple(tree["stem"]["conv"]["w"].shape) == (16, 3, 3, 3)  # OIHW
    assert tuple(tree["blocks"]["0"]["dw0_k5"]["w"].shape) == (24, 1, 5, 5)
    assert tuple(tree["classifier"]["w"].shape) == (32, 10)  # kept (in, out)
    taps = convert.depthwise_taps(tree["blocks"]["0"]["dw0_k5"]["w"])
    assert taps.is_contiguous() and tuple(taps.shape) == (5, 5, 24)
    np.testing.assert_array_equal(taps.numpy(), flat["blocks/0/dw0_k5/w"][:, :, 0, :])
    back = convert.to_jax(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    with pytest.raises(ValueError, match="depthwise"):
        convert.depthwise_taps(tree["stem"]["conv"]["w"])


def _tiny(image_size=24):
    kw = dict(num_classes=10, block_specs=TINY_SPECS, dropout=0.0)
    return _both("mobilenet_v2", 1.0, image_size, **kw)


@pytest.mark.parametrize("use_mask", [False, True])
def test_tiny_eval_logits_jax_weights_in_port(use_mask):
    jnet, pnet = _tiny()
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=1)
    x = np.random.RandomState(2).normal(0, 1, (3, 24, 24, 3)).astype(np.float32)
    masks_np = None
    if use_mask:
        m0 = np.ones(pnet.blocks[0].expanded_channels, np.float32)
        m0[::4] = 0.0
        masks_np = {0: m0, 2: np.zeros(pnet.blocks[2].expanded_channels, np.float32)}
    jax_masks = None if masks_np is None else {k: jnp.asarray(v) for k, v in masks_np.items()}
    want, _ = jax.jit(lambda p, s, x, m: jnet.apply(p, s, x, train=False, masks=m))(
        _jax_tree(params), _jax_tree(state), jnp.asarray(x), jax_masks)
    got = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x),
                     masks=None if masks_np is None else {k: torch.from_numpy(v) for k, v in masks_np.items()})
    assert np.abs(np.asarray(want)).max() > 1e-2  # the bar compares real numbers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_tiny_eval_logits_port_weights_in_jax():
    jnet, pnet = _tiny()
    gen = torch.Generator().manual_seed(3)
    params, _ = pnet.init(gen)
    state = random_bn_state(pnet, gen)
    x = np.random.RandomState(4).normal(0, 1, (2, 24, 24, 3)).astype(np.float32)
    got = pnet.apply(params, state, torch.from_numpy(x))
    want, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=False))(
        _jax_tree(convert.to_jax(params)), _jax_tree(convert.to_jax(state)), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mbv3_large_eval_logits_match_jax():
    """MobileNetV3-Large 1.0 at 224, batch 1: the slice's model, JAX weights
    carried into the port by models/convert.py."""
    jnet, pnet = _both("mobilenet_v3_large", 1.0, 224)
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=5)
    x = np.random.RandomState(6).normal(0, 1, (1, 224, 224, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=False))(_jax_tree(params), _jax_tree(state),
                                                                        jnp.asarray(x))
    with torch.inference_mode():
        got = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x))
    assert got.shape == (1, 1000) and np.abs(np.asarray(want)).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bn_mode", ["exact", "fused_vjp", "compute_sdot"])
def test_tiny_train_forward_matches_jax(bn_mode):
    """The training forward (batch statistics, new BN state) of the tiny
    AtomNAS-branch net on JAX weights, at the float32 bar; the eval-form
    tests above hold train=False."""
    jnet, pnet = _tiny()
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=7)
    x = np.random.RandomState(8).normal(0, 1, (4, 24, 24, 3)).astype(np.float32)
    want, want_s = jnet.apply(_jax_tree(params), _jax_tree(state), jnp.asarray(x), train=True, bn_mode=bn_mode)
    got, got_s = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x), train=True,
                            bn_mode=bn_mode)
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_flat = {k: np.asarray(v) for k, v in convert.flatten_tree(want_s).items()}
    for k, v in convert.to_jax(got_s).items():
        np.testing.assert_allclose(v, want_flat[k], rtol=RTOL, atol=ATOL, err_msg=k)

"""The port's quantized serving (serve/quant.py, int8 pairs in serve/export.py,
the uint8 wire of serve/engine.py), on the CPU.

Within the port the JAX package's tests/test_quant.py invariants are
mirrored bitwise on tiny nets: the shift-free u8 wire equals the f32 wire fed
``normalize_reference`` pixels across fused K and both staging modes, the
wire moves a quarter of the bytes, and int8 export is deterministic,
per-output-channel, gated and round-trips through disk. Across packages the
numpy helpers agree bit for bit, int8 bundles cross-load in both directions
with the same digest and logits within FOLD_ATOL, and the u8 wire of the
two engines agrees.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.serve import engine as jax_engine
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.serve import quant as jax_quant
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, QuantConfig
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export, quant
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.serve.pipeline import PipelinedBatcher

from test_torch_port_serve import FOLD_ATOL, _jax_tree, _weights

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
WIRE_ATOL = QuantConfig().wire_atol
SPECS = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25}, {"t": 3, "c": 16, "n": 2, "s": 2}]


def _net():
    return get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, block_specs=SPECS, dropout=0.0),
                     image_size=24)


def _jax_net():
    return jax_get_model(JaxModelConfig(arch="mobilenet_v2", num_classes=10, block_specs=SPECS, dropout=0.0),
                         image_size=24)


def _folded(seed=0):
    """(net, port-layout fold, JAX-layout fold as numpy) of seeded weights."""
    net = _net()
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    folded = export.fold_network(net, params, random_bn_state(net, gen))
    return net, folded, convert.unflatten_tree(convert.to_jax(folded))


@pytest.fixture(scope="module")
def folded():
    return _folded()


@pytest.fixture(scope="module")
def bundle(folded):
    net, f, _ = folded
    return export.InferenceBundle(net=net, params=f, meta={})


def _raw(n, size=24, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def _calib(n=16, seed=3):
    return quant.normalize_reference(_raw(n, seed=seed), IMAGENET_MEAN, IMAGENET_STD)


def _engines(bundle, *, mean=None, std=None, overlap=False, fuse=(2, 4)):
    """(f32-wire, u8-wire) engine pair sharing one bundle and structure."""
    common = dict(device="cpu", buckets=(2, 4), image_size=24, fuse_ladder=fuse, overlap_staging=overlap)
    return (InferenceEngine(bundle, **common),
            InferenceEngine(bundle, wire="uint8", wire_mean=mean, wire_std=std, **common))


# ---------------------------------------------------------------------------
# the uint8 wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_wire_u8_bitwise_shift_free(bundle, k, overlap):
    e_f32, e_u8 = _engines(bundle, overlap=overlap)
    assert e_u8.wire_parity_exact
    raw = _raw(k * 4, seed=k)
    handle = e_u8.predict_async(raw)
    assert handle.dispatches == 1
    got = handle.result()
    assert got.dtype == np.float32
    assert np.array_equal(got, e_f32.predict(quant.normalize_reference(raw)))


@pytest.mark.parametrize("k", [1, 2])
def test_wire_u8_imagenet_norm_delta_gated(bundle, k):
    e_f32, e_u8 = _engines(bundle, mean=IMAGENET_MEAN, std=IMAGENET_STD)
    assert not e_u8.wire_parity_exact
    raw = _raw(k * 4, seed=10 + k)
    ref = e_f32.predict(quant.normalize_reference(raw, IMAGENET_MEAN, IMAGENET_STD))
    assert float(np.max(np.abs(e_u8.predict(raw) - ref))) <= WIRE_ATOL


def test_wire_u8_padded_small_buckets(bundle):
    e_f32, e_u8 = _engines(bundle)
    for n in (1, 3, 5):
        raw = _raw(n, seed=20 + n)
        assert np.array_equal(e_u8.predict(raw), e_f32.predict(quant.normalize_reference(raw)))


def test_wire_u8_float_inputs_round_not_truncate(bundle):
    _, e_u8 = _engines(bundle)
    raw = _raw(2, seed=30)
    assert np.array_equal(e_u8.predict(raw.astype(np.float64) + 0.4), e_u8.predict(raw))
    clipped = np.full((2, 24, 24, 3), -7.0, np.float32)
    assert np.array_equal(e_u8.predict(clipped), e_u8.predict(np.zeros((2, 24, 24, 3), np.uint8)))


def test_wire_u8_h2d_bytes_quarter(bundle):
    e_f32, e_u8 = _engines(bundle)
    raw = _raw(4, seed=40)
    reg = get_registry()
    s0 = reg.snapshot().get("serve.h2d_bytes", 0)
    e_u8.predict(raw)
    s1 = reg.snapshot().get("serve.h2d_bytes", 0)
    e_f32.predict(quant.normalize_reference(raw))
    s2 = reg.snapshot().get("serve.h2d_bytes", 0)
    assert s1 - s0 == 4 * 24 * 24 * 3 and s2 - s1 == 4 * (s1 - s0)


def test_wire_u8_overlap_slot_reuse(bundle):
    e_f32, e_u8 = _engines(bundle, overlap=True)
    batches = [_raw(3, seed=60 + i) for i in range(6)]
    handles = [e_u8.predict_async(r) for r in batches]
    for raw, h in zip(batches, handles):
        assert np.array_equal(h.result(), e_f32.predict(quant.normalize_reference(raw)))


def test_wire_u8_through_pipelined_batcher(bundle):
    e_f32, e_u8 = _engines(bundle)
    batcher = PipelinedBatcher(e_u8, max_batch=4, max_wait_ms=5.0).start()
    try:
        assert batcher._wire_dtype == np.uint8
        raw = _raw(6, seed=70)
        rows = np.stack([f.result(timeout=30) for f in [batcher.submit(raw[i]) for i in range(6)]])
    finally:
        batcher.stop()
    assert np.array_equal(rows, e_f32.predict(quant.normalize_reference(raw)))


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------


def test_int8_quantize_deterministic(folded):
    net, _, jf = folded
    calib = _calib()
    q1, r1 = quant.calibrate_and_quantize(net, jf, calib, top1_min=0.5, device="cpu")
    q2, r2 = quant.calibrate_and_quantize(net, jf, calib, top1_min=0.5, device="cpu")
    f1, f2 = convert.flatten_tree(q1), convert.flatten_tree(q2)
    assert f1.keys() == f2.keys() and all(np.array_equal(f1[k], f2[k]) for k in f1)
    assert r1["calib"]["activation_ranges"] == r2["calib"]["activation_ranges"]
    assert r1["top1_agreement"] == r2["top1_agreement"]


def test_int8_scales_per_output_channel(folded):
    _, _, jf = folded
    q, n = quant.quantize_folded(jf)
    assert n >= 8
    flat, orig = convert.flatten_tree(q), convert.flatten_tree(jf)
    qkeys = [k for k in flat if k.endswith("/w_q")]
    assert qkeys and not any("/se/" in k for k in qkeys)
    for k in qkeys:
        base = k[: -len("/w_q")]
        w_q, scale = flat[k], flat[base + "/w_scale"]
        assert w_q.dtype == np.int8 and scale.dtype == np.float32 and scale.shape == (w_q.shape[-1],)
        assert np.abs(w_q).max() <= 127
        step = scale.reshape((1,) * (w_q.ndim - 1) + (-1,))
        assert np.max(np.abs(quant.dequantize_array(w_q, scale) - orig[base + "/w"]) / step) <= 0.5 + 1e-6


def test_int8_gate_refuses_bad_agreement(folded):
    net, _, jf = folded
    with pytest.raises(quant.QuantParityError, match="top-1 agreement"):
        quant.calibrate_and_quantize(net, jf, _calib(), top1_min=1.0 + 1e-9, device="cpu")


def test_int8_export_roundtrip(tmp_path):
    """export_bundle(quant_weights='int8') -> load_bundle round-trips the
    ints, the scales and the provenance; the loaded bundle serves bitwise
    like the in-memory quantized tree."""
    net = _net()
    gen = torch.Generator().manual_seed(7)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    calib = _calib()
    out = export.export_bundle(net, params, state, str(tmp_path / "b"), quant_weights="int8",
                               calib_images=calib, int8_top1_min=0.5, device="cpu")
    loaded = export.load_bundle(out)
    q = loaded.quant
    assert q["weights"] == "int8" and q["scheme"] == "per_output_channel_symmetric"
    assert 0.5 <= q["top1_agreement"] <= 1.0 and q["top1_min"] == 0.5
    assert q["bytes_int8"] < 0.5 * q["bytes_f32"] and q["calib"]["images"] == calib.shape[0]
    assert q["calib"]["activation_ranges"] and loaded.weights == "int8"
    flat = convert.flatten_tree(loaded.params)
    assert all(flat[k].dtype == torch.int8 for k in flat if k.endswith("/w_q"))
    mem, _ = quant.quantize_folded(convert.unflatten_tree(convert.to_jax(export.fold_network(net, params, state))))
    x = torch.from_numpy(_calib(4, seed=9))
    a = export.apply_folded(net, export.prepare_folded(net, loaded.params, device="cpu"), x)
    b = export.apply_folded(net, export.prepare_folded(net, convert.from_jax(convert.flatten_tree(mem)), device="cpu"), x)
    assert torch.equal(a, b)


def test_int8_top1_agreement_on_heldout(folded):
    net, f, jf = folded
    q, report = quant.calibrate_and_quantize(net, jf, _calib(), top1_min=0.5, device="cpu")
    x = torch.from_numpy(_calib(24, seed=99))
    ref = export.apply_folded(net, export.prepare_folded(net, f, device="cpu"), x).numpy()
    got = export.apply_folded(net, export.prepare_folded(net, convert.from_jax(convert.flatten_tree(q)), device="cpu"), x).numpy()
    assert float(np.mean(np.argmax(got, -1) == np.argmax(ref, -1))) >= report["top1_min"]


def test_int8_forward_equals_its_dequantized_f32_forward(folded):
    """The device tree stays int8 and the forward dequantizes it: bitwise
    the forward of the dequantized f32 tree, in f32 and bf16."""
    net, _, jf = folded
    q, _ = quant.quantize_folded(jf)
    flat = convert.flatten_tree(q)
    deq = {}
    for k, v in flat.items():
        if k.endswith("/w_q"):  # a/w_q + a/w_scale -> a/w
            deq[k[:-2]] = quant.dequantize_array(v, flat[k[:-1] + "scale"])
        elif not k.endswith("/w_scale"):
            deq[k] = v
    x = _calib(6, seed=5)
    for dtype in ("float32", "bfloat16"):
        e_q = InferenceEngine(export.InferenceBundle(net, convert.from_jax(convert.flatten_tree(q)), {}),
                              device="cpu", buckets=(4,), compute_dtype=dtype)
        e_d = InferenceEngine(export.InferenceBundle(net, convert.from_jax(deq), {}), device="cpu", buckets=(4,),
                              compute_dtype=dtype)
        assert e_q.weights == "int8" and e_d.weights == "float32"
        assert e_q._params["stem"]["w_q"].dtype == torch.int8
        assert np.array_equal(e_q.predict(x), e_d.predict(x)), dtype


def test_int8_u8_wire_fused_overlap_compose(folded, bundle):
    net, _, jf = folded
    q, report = quant.calibrate_and_quantize(net, jf, _calib(), top1_min=0.5, device="cpu")
    b_q = export.InferenceBundle(net=net, params=convert.from_jax(convert.flatten_tree(q)), meta={"quant": report})
    common = dict(device="cpu", buckets=(2, 4), image_size=24, wire="uint8", wire_mean=IMAGENET_MEAN,
                  wire_std=IMAGENET_STD)
    e_chained = InferenceEngine(b_q, **common)
    e_full = InferenceEngine(b_q, fuse_ladder=(2, 4), overlap_staging=True, staging_slots=2, **common)
    assert e_full.quant_mode == "wire=uint8,weights=int8"
    raw = _raw(8, seed=80)
    ref_q = e_chained.predict(raw)
    h = e_full.predict_async(raw)
    assert h.dispatches == 1
    assert np.array_equal(h.result(), ref_q)
    ref = InferenceEngine(bundle, device="cpu", buckets=(2, 4), image_size=24).predict(
        quant.normalize_reference(raw, IMAGENET_MEAN, IMAGENET_STD))
    assert float(np.mean(np.argmax(ref_q, -1) == np.argmax(ref, -1))) >= report["top1_min"]


def test_denorm_constants_identity_and_validation():
    scale, shift = quant.denorm_constants(None, None)
    assert np.allclose(scale, np.float32(1.0 / 255.0)) and quant.shift_free(shift)
    assert not quant.shift_free(quant.denorm_constants(IMAGENET_MEAN, IMAGENET_STD)[1])
    with pytest.raises(ValueError, match="positive"):
        quant.denorm_constants(None, (0.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="3-channel"):
        quant.denorm_constants((0.5,), None)
    with pytest.raises(ValueError, match="wire"):
        quant.wire_np_dtype("int4")


def test_quantize_zero_channel_never_divides_by_zero():
    w = np.zeros((3, 3, 4, 8), np.float32)
    w[..., :4] = np.random.RandomState(0).normal(0, 1, (3, 3, 4, 4))
    w_q, scale = quant.quantize_array_int8(w)
    assert np.all(scale[4:] == 1.0) and np.all(w_q[..., 4:] == 0)
    assert np.isfinite(quant.dequantize_array(w_q, scale)).all()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def test_numpy_helpers_match_the_jax_package_bitwise(folded):
    _, _, jf = folded
    for mean, std in ((None, None), (IMAGENET_MEAN, IMAGENET_STD)):
        for a, b in zip(quant.denorm_constants(mean, std), jax_quant.denorm_constants(mean, std)):
            assert np.array_equal(a, b)
        raw = _raw(2, seed=1)
        assert np.array_equal(quant.normalize_reference(raw, mean, std), jax_quant.normalize_reference(raw, mean, std))
    mine, n = quant.quantize_folded(jf)
    theirs, m = jax_quant.quantize_folded(jf)
    a, b = convert.flatten_tree(mine), jax_export.flatten_tree(theirs)
    assert n == m and a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert quant.tree_nbytes(mine) == jax_quant.tree_nbytes(theirs)


def _jax_bundle_dir(tmp_path, int8=True):
    jnet, pnet = _jax_net(), _net()
    params, state = _weights(jnet, pnet, seed=11)
    out = str(tmp_path / "jax_int8")
    jax_export.export_bundle(jnet, _jax_tree(params), _jax_tree(state), out, model_name="q",
                             quant_weights="int8" if int8 else "float32", calib_images=_calib(), int8_top1_min=0.5)
    return out


def test_jax_int8_bundle_loads_in_port(tmp_path):
    out = _jax_bundle_dir(tmp_path)
    bundle = export.load_bundle(out)  # verifies the digest JAX stamped
    assert bundle.digest == json.load(open(os.path.join(out, "meta.json")))["digest"]
    assert bundle.weights == "int8" and bundle.quant["weights"] == "int8"
    jb = jax_export.load_bundle(out)
    x = _calib(5, seed=2)
    want = jax_export.apply_folded(jb.net, jb.params, jnp.asarray(x))
    got = InferenceEngine(bundle, device="cpu", buckets=(4,)).predict(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=FOLD_ATOL, rtol=0)


def test_port_int8_bundle_loads_in_jax(tmp_path):
    net = _net()
    gen = torch.Generator().manual_seed(13)
    params, _ = net.init(gen)
    out = export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / "b"), quant_weights="int8",
                               calib_images=_calib(), int8_top1_min=0.5, model_name="q8", device="cpu")
    jb = jax_export.load_bundle(out)  # JAX re-derives and verifies the port's digest
    mine = export.load_bundle(out)
    assert jb.digest == mine.digest and jb.quant["quantized_tensors"] == mine.quant["quantized_tensors"]
    assert any(k.endswith("/w_q") for k in jax_export.flatten_tree(jb.params))
    x = _calib(5, seed=4)
    want = jax.jit(lambda p, x: jax_export.apply_folded(jb.net, p, x))(jb.params, jnp.asarray(x))
    got = InferenceEngine(mine, device="cpu", buckets=(4,)).predict(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=FOLD_ATOL, rtol=0)


def test_port_calibration_report_matches_jax(tmp_path, folded):
    """The port's gated pass over one JAX-layout fold: the same quantized
    tree, byte accounting and stage names as the JAX package's, ranges and
    delta within float32 forward differences."""
    net, _, jf = folded
    jnet = _jax_net()
    calib = _calib()
    q, mine = quant.calibrate_and_quantize(net, jf, calib, top1_min=0.5, device="cpu")
    qj, theirs = jax_quant.calibrate_and_quantize(jnet, jax.tree.map(jnp.asarray, jf), calib, top1_min=0.5)
    a, b = convert.flatten_tree(q), jax_export.flatten_tree(qj)
    assert all(np.array_equal(a[k], np.asarray(b[k])) for k in a)
    for key in ("quantized_tensors", "bytes_f32", "bytes_int8", "scheme", "weights"):
        assert mine[key] == theirs[key], key
    assert mine["calib"]["activation_ranges"].keys() == theirs["calib"]["activation_ranges"].keys()
    for k, (lo, hi) in mine["calib"]["activation_ranges"].items():
        np.testing.assert_allclose([lo, hi], theirs["calib"]["activation_ranges"][k], atol=FOLD_ATOL * 10, rtol=1e-4)
    assert mine["top1_agreement"] == theirs["top1_agreement"]


@pytest.mark.parametrize("mean,std", [(None, None), (IMAGENET_MEAN, IMAGENET_STD)])
def test_u8_wire_port_vs_jax(tmp_path, mean, std):
    out = _jax_bundle_dir(tmp_path, int8=False)
    raw = _raw(6, seed=8)
    common = dict(buckets=(2, 4), image_size=24, wire="uint8", wire_mean=mean, wire_std=std)
    want = jax_engine.InferenceEngine(jax_export.load_bundle(out), fuse_ladder=(2,), **common).predict(raw)
    got = InferenceEngine(export.load_bundle(out), device="cpu", fuse_ladder=(2,), **common).predict(raw)
    np.testing.assert_allclose(got, want, atol=FOLD_ATOL, rtol=0)

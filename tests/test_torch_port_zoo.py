"""The port's model zoo (serve/zoo.py, the multi-tenant serve/engine.py, the
bundle identity of serve/export.py) against the JAX package's, on the CPU.

- Bundle identity: the digest is the same string in both packages for the
  same bundle, each package loads the other's stamped bundle (f32 and
  int8), and both refuse a tampered one.
- ``ModelZoo.from_config`` over the port's loader refuses an alias.
- The port's two-tenant engine (an int8 tenant beside an f32 one) matches
  the JAX two-tenant engine per tenant within FOLD_ATOL
  (tests/test_serve.py's bar), and its own single-bundle engines bitwise.
- Per-model off-ladder LRU with no cross-eviction, the ``_m<name>`` cost
  keys, and staging-slot reuse under model churn, bitwise with a clean
  drain (the port's mirrors of tests/test_zoo.py:196, :228 and :553).
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.config import ZooConfig as JaxZooConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.serve.engine import InferenceEngine as JaxEngine
from yet_another_mobilenet_series_tpu.serve.zoo import ModelZoo as JaxModelZoo
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, ZooConfig
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs import device as obs_device
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.admission import UnknownModel
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.serve.pipeline import PipelinedBatcher
from yet_another_mobilenet_series_tpu_torch.serve.zoo import ModelZoo

from test_torch_port_models import numpy_params
from test_torch_port_serve import _jax_tree

FOLD_ATOL = 1e-4  # tests/test_serve.py: folded logits vs the reference forward
SIZE = 24
SMALL_SPECS = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5]}, {"t": 2, "c": 16, "n": 1, "s": 2}]
BIG_SPECS = [{"t": 3, "c": 16, "n": 2, "s": 2}, {"t": 4, "c": 24, "n": 1, "s": 2, "se": 0.25}]


def _cfg(specs, num_classes):
    return dict(arch="mobilenet_v2", num_classes=num_classes, block_specs=specs, dropout=0.0)


def _images(seed, n, size=SIZE):
    return np.random.RandomState(seed).normal(0, 1, (n, size, size, 3)).astype(np.float32)


def _port_export(tmp_path, name, *, seed, specs=SMALL_SPECS, num_classes=10, **kw):
    net = get_model(ModelConfig(**_cfg(specs, num_classes)), image_size=SIZE)
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    return export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / name), device="cpu", **kw)


def _jax_export(tmp_path, name, *, seed, specs, num_classes, **kw):
    """A bundle exported by the JAX package from numpy-made params and
    non-trivial BN statistics (positive variances)."""
    jnet = jax_get_model(JaxModelConfig(**_cfg(specs, num_classes)), image_size=SIZE)
    params = numpy_params(jnet, seed)
    rng = np.random.RandomState(seed + 100)
    state = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))[1]
    flat_state = {}
    for path, s in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = "/".join(p.key for p in path)
        a = rng.uniform(0.5, 1.5, s.shape) if key.endswith("var") else rng.normal(0, 0.1, s.shape)
        flat_state[key] = a.astype(np.float32)
    return jax_export.export_bundle(jnet, _jax_tree(params), _jax_tree(flat_state), str(tmp_path / name), **kw)


def _files(bundle_dir):
    with open(os.path.join(bundle_dir, "spec.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(bundle_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(bundle_dir, "meta.json")) as f:
        meta = json.load(f)
    return spec, flat, meta


def _tamper(bundle_dir):
    npz = os.path.join(bundle_dir, "weights.npz")
    flat = dict(np.load(npz))
    key = sorted(k for k in flat if flat[k].dtype == np.float32)[0]
    flat[key] = flat[key] + 1.0
    np.savez(npz, **flat)


# ---------------------------------------------------------------------------
# bundle identity across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["float32", "int8"])
def test_digest_is_the_same_string_in_both_packages_and_each_loads_the_others(tmp_path, weights):
    kw = dict(quant_weights="int8", calib_images=_images(9, 8), int8_top1_min=0.0) if weights == "int8" else {}
    port_dir = _port_export(tmp_path, "port", seed=0, model_name="small", **kw)
    jax_dir = _jax_export(tmp_path, "jax", seed=1, specs=SMALL_SPECS, num_classes=10, model_name="small", **kw)
    for d in (port_dir, jax_dir):
        spec, flat, meta = _files(d)
        assert meta["model_name"] == "small"
        assert any(k.endswith("/w_q") for k in flat) == (weights == "int8")
        assert export.bundle_digest(spec, flat) == jax_export.bundle_digest(spec, flat) == meta["digest"]
        pb, jb = export.load_bundle(d), jax_export.load_bundle(d)
        assert pb.digest == jb.digest == meta["digest"] and len(pb.digest) == 16
        assert pb.model_name == jb.model_name == "small" and pb.weights == weights
    for d in (port_dir, jax_dir):
        _tamper(d)
        with pytest.raises(export.BundleDigestMismatch):
            export.load_bundle(d)
        with pytest.raises(jax_export.BundleDigestMismatch):
            jax_export.load_bundle(d)


def test_zoo_from_config_on_port_bundles_refuses_aliases(tmp_path):
    s = _port_export(tmp_path, "s", seed=0, model_name="small")
    b = _port_export(tmp_path, "b", seed=7, specs=BIG_SPECS, num_classes=7, model_name="big")
    zoo = ModelZoo.from_config(ZooConfig(models=f"small={s},big={b}", default="big", quotas="small=8",
                                         image_sizes="small=24|32"))
    assert zoo.models == ("small", "big") and zoo.default == "big"
    assert isinstance(zoo.bundle("small"), export.InferenceBundle)
    digests = zoo.digests()
    assert digests["small"] and digests["small"] != digests["big"]
    assert zoo.lease_models() == digests
    assert zoo.admission_kwargs()["model_quotas"] == {"small": 8}
    assert zoo.engine_kwargs()["model_image_sizes"] == {"small": (24, 32)}
    with pytest.raises(ValueError, match="stamped model_name"):
        ModelZoo.from_config(ZooConfig(models=f"huge={s}"))
    with pytest.raises(ValueError, match="not among models"):
        ModelZoo.from_config(ZooConfig(models=f"small={s}", default="nope"))


# ---------------------------------------------------------------------------
# the multi-tenant engine
# ---------------------------------------------------------------------------


def test_two_tenant_engine_matches_jax_per_tenant_and_its_single_engines_bitwise(tmp_path):
    small = _jax_export(tmp_path, "small", seed=3, specs=SMALL_SPECS, num_classes=10, model_name="small",
                        quant_weights="int8", calib_images=_images(8, 8), int8_top1_min=0.0)
    big = _jax_export(tmp_path, "big", seed=4, specs=BIG_SPECS, num_classes=7, model_name="big")
    spec = f"small={small},big={big}"
    get_registry().reset()
    pzoo = ModelZoo.from_config(ZooConfig(models=spec))
    eng = InferenceEngine(**pzoo.engine_kwargs(), device="cpu", buckets=(1, 2), fuse_ladder=(2,))
    eng.warmup()
    jzoo = JaxModelZoo.from_config(JaxZooConfig(models=spec))
    jeng = JaxEngine(**jzoo.engine_kwargs(), buckets=(1, 2), fuse_ladder=(2,))
    assert eng.models == jeng.models == ("small", "big") and eng.default_model == "small"
    assert eng.model_weights("small") == jeng.model_weights("small") == "int8"
    assert eng.model_weights("big") == "float32"
    x = _images(5, 5)  # 5 rows: one fused K=2 piece and a bucket-1 tail
    for model, classes in (("small", 10), ("big", 7)):
        got, want = eng.predict(x, model=model), np.asarray(jeng.predict(x, model=model))
        assert got.shape == (5, classes) and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, atol=FOLD_ATOL, rtol=0)
        single = InferenceEngine(pzoo.bundle(model), device="cpu", buckets=(1, 2), fuse_ladder=(2,))
        np.testing.assert_array_equal(got, single.predict(x))
        np.testing.assert_array_equal(eng.predict(x[:1], model=model), single.predict(x[:1]))
    np.testing.assert_array_equal(eng.predict(x), eng.predict(x, model="small"))  # the default tenant
    with pytest.raises(UnknownModel) as e:
        eng.predict(x, model="nope")
    assert set(e.value.served) == {"small", "big"}
    assert ("small", 2, SIZE, 2) in eng._compiled and ("big", 2, SIZE, 1) in eng._compiled
    snap = get_registry().snapshot()
    assert snap["serve.infer_images.small"] == 5 + 1 + 2 * 5 and snap["serve.infer_images.big"] == 5 + 1


def test_cost_keys_carry_the_tenant(tmp_path):
    s = export.load_bundle(_port_export(tmp_path, "s", seed=0, model_name="small"))
    b = export.load_bundle(_port_export(tmp_path, "b", seed=7, specs=BIG_SPECS, num_classes=7, model_name="big",
                                        quant_weights="int8", calib_images=_images(1, 8), int8_top1_min=0.0))
    get_registry().reset()
    eng = InferenceEngine(models={"small": s, "big": b}, device="cpu", buckets=(1,), ring_slots=2)
    eng.warmup()
    keys = set(obs_device.compile_report())
    assert {f"serve_b1_s{SIZE}_k1_msmall", f"serve_b1_s{SIZE}_ring2_msmall", f"serve_b1_s{SIZE}_k1_w8_mbig",
            f"serve_b1_s{SIZE}_ring2_w8_mbig"} <= keys
    report = obs_device.compile_report()[f"serve_b1_s{SIZE}_k1_w8_mbig"]
    assert report["flops"] == obs_device.forward_cost(b.net, SIZE)["flops"] and report["compile_seconds"] >= 0
    # a single-bundle engine's keys keep no tenant suffix
    InferenceEngine(s, device="cpu", buckets=(1,)).warmup()
    assert f"serve_b1_s{SIZE}_k1" in obs_device.compile_report()
    # a dispatch counts its own tenant's cost
    reg = get_registry()
    f0 = reg.snapshot().get("serve.dispatched_flops", 0)
    eng.predict(_images(2, 1), model="big")
    assert reg.snapshot()["serve.dispatched_flops"] - f0 == obs_device.flops_for(f"serve_b1_s{SIZE}_k1_w8_mbig")
    ring = eng.ring_dispatch([eng.ring_stage(_images(3, 1))], model="big").result()
    np.testing.assert_array_equal(ring, eng.predict(_images(3, 1), model="big"))
    assert reg.snapshot()["serve.ring_dispatches.big"] == 1


def test_offladder_lru_is_per_model_no_cross_eviction(tmp_path):
    s = export.load_bundle(_port_export(tmp_path, "s", seed=0, model_name="small"))
    b = export.load_bundle(_port_export(tmp_path, "b", seed=7, model_name="big"))
    get_registry().reset()
    eng = InferenceEngine(models={"small": s, "big": b}, device="cpu", buckets=(2,), offladder_cache=2,
                          overlap_staging=True)
    eng.warmup()

    def sizes(model):
        return sorted(k[2] for k in eng._compiled if k[0] == model and k[2] != SIZE)

    for size in (8, 12, 16, 20):  # a churn burst on "small" only
        assert eng.predict(np.zeros((1, size, size, 3), np.float32), model="small").shape == (1, 10)
    assert sizes("small") == [16, 20] and get_registry().snapshot()["serve.evicted_executables"] == 2
    assert ("big", 2, SIZE, 1) in eng._compiled
    for size in (8, 16):  # big's churn lives in big's own slice
        eng.predict(np.zeros((1, size, size, 3), np.float32), model="big")
    assert sizes("small") == [16, 20] and sizes("big") == [8, 16]
    eng.predict(np.zeros((1, 26, 26, 3), np.float32), model="small")  # evicts small's 16
    eng.predict(np.zeros((1, 28, 28, 3), np.float32), model="small")  # evicts small's 20
    assert ("small", 2, 16, 1) not in eng._compiled and ("big", 2, 16, 1) in eng._compiled
    assert (2, 16, 1) in eng._staging  # big still holds the geometry
    assert (2, 20, 1) not in eng._staging  # no tenant holds 20 any more
    x = _images(6, 1, 16)
    np.testing.assert_array_equal(eng.predict(x, model="big"),
                                  InferenceEngine(b, device="cpu", buckets=(2,), image_size=16).predict(x))


def test_staging_slot_reuse_under_model_churn_bitwise_and_clean_drain(tmp_path):
    a = export.load_bundle(_port_export(tmp_path, "a", seed=0, model_name="a"))
    b = export.load_bundle(_port_export(tmp_path, "b", seed=7, specs=BIG_SPECS, num_classes=7, model_name="b"))
    get_registry().reset()
    eng = InferenceEngine(models={"a": a, "b": b}, model_image_sizes={"a": (24, 32), "b": (24,)}, device="cpu",
                          buckets=(2,), overlap_staging=True, staging_slots=1)
    eng.warmup()
    ref_a = InferenceEngine(a, device="cpu", buckets=(2,), image_size=24, image_sizes=(24, 32))
    ref_b = InferenceEngine(b, device="cpu", buckets=(2,), image_size=24)
    eng.predict(np.zeros((1, 24, 24, 3), np.float32), model="a")  # one slot, shared by both tenants
    assert len(eng._staging[(2, 24, 1)].slots) == 1
    rng = np.random.RandomState(11)
    plan = []
    for i in range(12):
        model = "a" if i % 2 == 0 else "b"
        size = 32 if (model == "a" and i % 4 == 0) else 24
        x = rng.normal(0, 1, (1, size, size, 3)).astype(np.float32)
        plan.append((model, x[0], (ref_a if model == "a" else ref_b).predict(x)[0]))
    batcher = PipelinedBatcher(eng, max_batch=2, max_wait_ms=1.0, max_inflight=2, drain_timeout_s=10.0)
    batcher.start()
    try:
        futs = [batcher.submit(img, model=model) for model, img, _ in plan]
        for (_, _, ref), f in zip(plan, futs):
            np.testing.assert_array_equal(f.result(timeout=30), ref)
    finally:
        batcher.stop(drain=True)
    assert batcher.inflight() == 0
    assert set(eng._staging) == {(2, 24, 1), (2, 32, 1)}
    x = rng.normal(0, 1, (1, 24, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(eng.predict(x, model="a"), ref_a.predict(x))
    np.testing.assert_array_equal(eng.predict(x, model="b"), ref_b.predict(x))


def test_engine_refuses_a_bad_tenant_set(tmp_path):
    s = export.load_bundle(_port_export(tmp_path, "s", seed=0))
    with pytest.raises(ValueError, match="either bundle= or models="):
        InferenceEngine(s, models={"a": s}, device="cpu")
    with pytest.raises(ValueError, match="must be non-empty"):
        InferenceEngine(models={"a b": s}, device="cpu")
    with pytest.raises(ValueError, match="not among loaded models"):
        InferenceEngine(models={"a": s}, default_model="b", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        InferenceEngine(models={"a": s}, model_image_sizes={"b": (16,)}, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        InferenceEngine(s, device="cpu", mesh=object())

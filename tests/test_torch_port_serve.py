"""The port's serving slice (serve/export.py, serve/engine.py, cli/serve.py)
against the JAX package's, on the CPU.

Bundles cross between the packages in both directions: the format on disk
is common, the digests verify on both sides, and the folded logits agree
within FOLD_ATOL (tests/test_serve.py's bar). The engine's own invariants
(bitwise bucket padding, predict == predict_async().result(), the image-size
ladder, the once-latch, refusal of what is not ported) are pinned within
the port, and the CLI serves a tiny bundle through the pipelined batcher
with ``--device cpu`` and the shipped config as shipped. The fused, overlap,
ring and quantized paths have their own files
(tests/test_torch_port_dispatch.py, tests/test_torch_port_quant.py).
"""

import json
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

from test_torch_port_models import numpy_params

FOLD_ATOL = 1e-4  # tests/test_serve.py: folded logits vs the reference forward
# Independent folds compute w * (gamma * rsqrt(var + eps)) in float32. XLA's
# and torch's rsqrt are each within 1 ulp of exact (2 ulps apart, measured
# over 1e6 values), the two products round once each, and a product at the
# bottom of its binade counts relative errors in units twice as fine: up to
# 6 ulps of the folded weight. A folded bias beta - mean * scale can cancel,
# so its bound is in units of the larger of its two terms.
FOLD_W_MAX_ULP = 6
FOLD_B_TERM_ULPS = 8
APP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")

TINY_SPECS = [
    {"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
    {"t": 3, "c": 16, "n": 2, "s": 2},
]


def _nets(arch="mobilenet_v2", image_size=24, **kw):
    if arch == "mobilenet_v2":
        kw = dict(num_classes=10, block_specs=TINY_SPECS, dropout=0.0, **kw)
    return (jax_get_model(JaxModelConfig(arch=arch, **kw), image_size=image_size),
            get_model(ModelConfig(arch=arch, **kw), image_size=image_size))


def _jax_tree(flat):
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = jnp.asarray(v)
    return out


def _weights(jnet, pnet, seed):
    """numpy-made params + seeded BN state, '/'-keyed, JAX layouts."""
    return numpy_params(jnet, seed), convert.to_jax(random_bn_state(pnet, torch.Generator().manual_seed(seed)))


def _port_bundle(tmp_path, seed=0, name="bundle"):
    _, pnet = _nets()
    gen = torch.Generator().manual_seed(seed)
    params, _ = pnet.init(gen)
    state = random_bn_state(pnet, gen)
    out = str(tmp_path / name)
    export.export_bundle(pnet, params, state, out, model_name="tiny")
    return export.load_bundle(out)


def _images(seed, n, size=24):
    return np.random.RandomState(seed).normal(0, 1, (n, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# fold + bundles across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,size", [("mobilenet_v2", 24), ("mobilenet_v3_large", 224)])
def test_jax_bundle_loads_in_port_and_matches_jax_apply_folded(tmp_path, arch, size):
    jnet, pnet = _nets(arch, size)
    params, state = _weights(jnet, pnet, seed=1)
    out = str(tmp_path / "jax_bundle")
    jax_export.export_bundle(jnet, _jax_tree(params), _jax_tree(state), out, model_name="m")
    bundle = export.load_bundle(out)  # verifies the digest JAX stamped
    assert bundle.net == pnet and bundle.digest == json.load(open(os.path.join(out, "meta.json")))["digest"]
    x = _images(2, 2, size)
    jb = jax_export.load_bundle(out)
    want = jax.jit(lambda p, x: jax_export.apply_folded(jb.net, p, x))(jb.params, jnp.asarray(x))
    got = InferenceEngine(bundle, device="cpu", buckets=(2,)).predict(x)
    assert np.abs(np.asarray(want)).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), atol=FOLD_ATOL, rtol=0)


def test_port_bundle_loads_in_jax_and_matches(tmp_path):
    bundle = _port_bundle(tmp_path)
    out = str(tmp_path / "bundle")
    jb = jax_export.load_bundle(out)  # JAX re-derives and verifies the port's digest
    assert jb.digest == bundle.digest and jb.model_name == "tiny"
    x = _images(3, 4)
    want = jax_export.apply_folded(jb.net, jb.params, jnp.asarray(x))
    params = export.prepare_folded(bundle.net, bundle.params, device="cpu")
    got = export.apply_folded(bundle.net, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FOLD_ATOL, rtol=0)


def _bias_terms(net, params, state, key):
    """|beta| + |mean * scale| (float64) behind a folded bias ``key``."""
    parts = key.split("/")
    off, g = 0, None
    if parts[0] in ("stem", "head"):
        bn = f"{parts[0]}/bn"
        eps = getattr(net, parts[0]).bn_eps
    else:
        blk = net.blocks[int(parts[1])]
        eps = blk.bn_eps
        if parts[2].startswith("dw"):
            bn = f"blocks/{parts[1]}/dw_bn"
            off, g = next((o, gg) for bi, k, gg, o in blk._branches() if parts[2] == f"dw{bi}_k{k}")
        else:
            bn = f"blocks/{parts[1]}/{parts[2]}_bn"
    gamma, beta = params[f"{bn}/gamma"], params[f"{bn}/beta"]
    mean, var = state[f"{bn}/mean"], state[f"{bn}/var"]
    terms = np.abs(beta.astype(np.float64)) + np.abs(mean * gamma / np.sqrt(var.astype(np.float64) + eps))
    return terms if g is None else terms[off: off + g]


def test_fold_matches_jax_fold_within_ulps():
    jnet, pnet = _nets()
    params, state = _weights(jnet, pnet, seed=7)
    want = jax_export.flatten_tree(jax_export.fold_network(jnet, _jax_tree(params), _jax_tree(state)))
    got = convert.to_jax(export.fold_network(pnet, convert.from_jax(params), convert.from_jax(state)))
    assert set(got) == set(want)
    for k in want:
        if "/se/" in k or k.startswith(("feature", "classifier")):
            np.testing.assert_array_equal(got[k], want[k])  # passed through the fold unchanged
        elif k.endswith("/w"):
            np.testing.assert_array_max_ulp(got[k], want[k], maxulp=FOLD_W_MAX_ULP)
        else:
            ulp = np.spacing(_bias_terms(pnet, params, state, k).astype(np.float32))
            assert np.all(np.abs(got[k].astype(np.float64) - want[k]) <= FOLD_B_TERM_ULPS * ulp), k


def test_fold_parity_with_the_eval_forward():
    _, pnet = _nets()
    gen = torch.Generator().manual_seed(5)
    params, _ = pnet.init(gen)
    state = random_bn_state(pnet, gen)
    x = torch.from_numpy(_images(6, 3))
    ref = pnet.apply(params, state, x)
    folded = export.fold_network(pnet, params, state)
    got = export.apply_folded(pnet, export.prepare_folded(pnet, folded, device="cpu"), x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=FOLD_ATOL, rtol=0)
    flat = convert.to_jax(folded)
    assert not any("bn" in k for k in flat) and any(k.endswith("/b") for k in flat)


def test_prepare_folded_holds_the_kernel_operands(tmp_path):
    bundle = _port_bundle(tmp_path)
    prepared = export.prepare_folded(bundle.net, bundle.params, device="cpu", compute_dtype=torch.bfloat16)
    blk = bundle.net.blocks[0]
    for bi, k, g, _ in blk._branches():
        p = prepared["blocks"]["0"][f"dw{bi}_k{k}"]
        assert set(p) == {"taps", "b", "ones"}
        assert p["taps"].shape == (k, k, g) and p["taps"].dtype == torch.float32 and p["taps"].is_contiguous()
    assert prepared["stem"]["w"].dtype == torch.bfloat16
    assert prepared["classifier"]["w"].dtype == torch.float32


def test_export_and_load_refuse_what_is_not_ported(tmp_path):
    _, pnet = _nets()
    gen = torch.Generator().manual_seed(0)
    params, _ = pnet.init(gen)
    state = random_bn_state(pnet, gen)
    # dead atoms are no longer refused: the rematerialisation surgery
    # hard-applies them before the fold
    dead = {0: torch.tensor([0.0] + [1.0] * (pnet.blocks[0].expanded_channels - 1))}
    pruned = export.load_bundle(export.export_bundle(pnet, params, state, str(tmp_path / "m"), masks=dead))
    assert pruned.net.blocks[0].expanded_channels == pnet.blocks[0].expanded_channels - 1
    assert pruned.meta["prune"]["atoms_after"] == pruned.meta["prune"]["atoms_before"] - 1
    with pytest.raises(ValueError, match="calibration batch"):
        export.export_bundle(pnet, params, state, str(tmp_path / "q"), quant_weights="int8")
    with pytest.raises(ValueError, match="quant_weights"):
        export.export_bundle(pnet, params, state, str(tmp_path / "q"), quant_weights="int4")
    live = {0: torch.ones(pnet.blocks[0].expanded_channels)}
    out = export.export_bundle(pnet, params, state, str(tmp_path / "ok"), masks=live)
    # a hand-edited weight fails the digest
    with np.load(os.path.join(out, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    flat["classifier/b"] = flat["classifier/b"] + 1.0
    np.savez(os.path.join(out, "weights.npz"), **flat)
    with pytest.raises(export.BundleDigestMismatch):
        export.load_bundle(out)
    # a training-shaped spec is not a bundle
    spec_path = os.path.join(out, "spec.json")
    spec = json.load(open(spec_path))
    spec["inference"] = False
    json.dump(spec, open(spec_path, "w"))
    with pytest.raises(ValueError, match="not an inference bundle"):
        export.load_bundle(out)


# ---------------------------------------------------------------------------
# engine invariants, within the port
# ---------------------------------------------------------------------------


def test_engine_bucket_padding_bitwise(tmp_path):
    eng = InferenceEngine(_port_bundle(tmp_path), device="cpu", buckets=(2, 4), image_size=24)
    eng.warmup()
    x = _images(0, 4)
    full = eng.predict(x)  # exact bucket, no padding
    np.testing.assert_array_equal(eng.predict(x[:3]), full[:3])  # 3 -> padded to 4
    two = eng.predict(x[:2])
    np.testing.assert_array_equal(eng.predict(x[:1]), two[:1])  # 1 -> padded to 2
    seven = eng.predict(np.concatenate([x, x[:3]]))  # > max bucket: chunks of 4
    assert seven.shape == (7, 10)
    np.testing.assert_array_equal(seven[:4], full)
    np.testing.assert_array_equal(seven[4:], full[:3])


def test_engine_async_matches_sync_bitwise(tmp_path):
    eng = InferenceEngine(_port_bundle(tmp_path), device="cpu", buckets=(2, 4), image_size=24)
    x, y = _images(7, 10), _images(8, 7)
    sync_x, sync_y = eng.predict(x.copy()), eng.predict(y.copy())
    hx, hy = eng.predict_async(x), eng.predict_async(y)
    # two padded dispatches share the (4, 24) staging buffer while hx/hy wait
    hz1, hz2 = eng.predict_async(x[:3]), eng.predict_async(y[:3])
    np.testing.assert_array_equal(hy.result(), sync_y)
    np.testing.assert_array_equal(hx.result(), sync_x)
    np.testing.assert_array_equal(hz1.result(), sync_x[:3])
    np.testing.assert_array_equal(hz2.result(), sync_y[:3])
    assert hx.result() is hx.result() and hx.dispatches == 3


def test_engine_image_size_ladder(tmp_path):
    eng = InferenceEngine(_port_bundle(tmp_path), device="cpu", buckets=(2, 4), image_size=24,
                          image_sizes=(24, 32), offladder_cache=1)
    assert eng.image_sizes == (24, 32)
    reg = get_registry()
    before = reg.snapshot().get("serve.compile_seconds.count", 0)
    eng.warmup()  # one forward per (bucket, size) of the ladder
    assert reg.snapshot()["serve.compile_seconds.count"] - before == 4
    for n, s in [(1, 24), (3, 32), (4, 32), (2, 24), (7, 32)]:
        assert eng.predict(_images(n, n, s)).shape == (n, 10)
    evicted = reg.snapshot().get("serve.evicted_executables", 0)
    for s in (16, 20):  # off the ladder: served, staging kept in a bounded LRU
        assert eng.predict(_images(1, 3, s)).shape == (3, 10)
    assert (4, 20, 1) in eng._staging and (4, 16, 1) not in eng._staging
    assert reg.snapshot()["serve.evicted_executables"] - evicted == 1
    with pytest.raises(ValueError, match="expects"):
        eng.predict(np.zeros((2, 24, 32, 3), np.float32))  # non-square
    with pytest.raises(ValueError, match="empty"):
        eng.predict(np.zeros((0, 24, 24, 3), np.float32))


def test_engine_staging_buffer_is_reused(tmp_path):
    eng = InferenceEngine(_port_bundle(tmp_path), device="cpu", buckets=(4,), image_size=24)
    eng.predict(_images(1, 3))
    pool = eng._staging[(4, 24, 1)]
    buf = pool.slots[0].buf
    eng.predict(_images(2, 2))
    assert eng._staging[(4, 24, 1)] is pool and pool.slots[0].buf is buf
    assert not buf[2:].any()  # only the pad rows were re-zeroed, and they are


def test_pending_prediction_once_latch_under_threads(tmp_path):
    eng = InferenceEngine(_port_bundle(tmp_path), device="cpu", buckets=(2, 4), image_size=24)
    x = _images(23, 10)
    ref = eng.predict(x.copy())
    reg = get_registry()
    h = eng.predict_async(x)
    before = reg.snapshot()["serve.run_seconds.count"]
    outs = [None] * 8
    barrier = threading.Barrier(8)

    def grab(i):
        barrier.wait()
        outs[i] = h.result()

    threads = [threading.Thread(target=grab, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert all(o is outs[0] for o in outs)  # one sync; everyone shares the cache
    np.testing.assert_array_equal(outs[0], ref)
    assert reg.snapshot()["serve.run_seconds.count"] - before == 1


def test_engine_bf16_stays_within_the_jax_bf16_bar(tmp_path):
    """compute_dtype="bfloat16" runs the same path (bf16 convs, the kernel's
    plain version in bf16 here) and stays within the JAX engine's pinned
    BF16_PARITY_ATOL (0.35) of the float32 logits."""
    from yet_another_mobilenet_series_tpu.serve.engine import BF16_PARITY_ATOL

    bundle = _port_bundle(tmp_path)
    x = _images(9, 3)
    f32 = InferenceEngine(bundle, device="cpu", buckets=(4,)).predict(x)
    bf16 = InferenceEngine(bundle, device="cpu", buckets=(4,), compute_dtype="bfloat16").predict(x)
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    np.testing.assert_allclose(bf16, f32, atol=BF16_PARITY_ATOL, rtol=0)
    assert not np.array_equal(bf16, f32)  # it really computed in bf16


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "queue 1, item 8"),
    (dict(models="two"), "either bundle= or models="),
    (dict(compute_dtype="float16"), "compute_dtype"),
])
def test_engine_refuses_what_is_not_ported(tmp_path, kwargs, match):
    bundle = _port_bundle(tmp_path)
    if kwargs.get("models") == "two":  # a zoo is served (tests/test_torch_port_zoo.py); a bundle beside it is not
        kwargs = dict(models={"a": bundle, "b": bundle})
    with pytest.raises(ValueError, match=match):
        InferenceEngine(bundle, device="cpu", **kwargs)


def test_engine_asked_for_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the engine runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(_port_bundle(tmp_path))  # the default device is cuda


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_args(tmp_path, *extra):
    bundle = _port_bundle(tmp_path)
    return [f"app:{APP}", f"serve.bundle={tmp_path / 'bundle'}", "data.image_size=24",
            f"train.log_dir={tmp_path / 'log'}", *extra], bundle


@pytest.mark.parametrize("pipelined", [True, False])
def test_cli_serves_requests_on_the_cpu(tmp_path, pipelined):
    args, _ = _cli_args(tmp_path, "serve.requests=48", "serve.clients=4", f"serve.pipelined={str(pipelined).lower()}")
    result = serve_cli.main(args + ["--device", "cpu"])
    assert result["device"] == "cpu"
    assert result["completed"] == 48 and result["shed"] == 0 and result["rejected_full"] == 0
    # the shipped config as shipped: 3 buckets + the fused K=2 and K=4 keys
    assert result["warmup_forwards"] == 5 and 1 <= result["dispatches"] <= 48
    assert sorted(tuple(g["key"]) for g in result["graphs"]) == [(1, 24, 1), (8, 24, 1), (32, 24, 1), (32, 24, 2),
                                                                 (32, 24, 4)]
    # the CPU runs each key's body eagerly: there is no graph to replay
    assert result["replays"] == 0 and {g["kind"] for g in result["graphs"]} == {"k"}
    snap = json.load(open(tmp_path / "log" / "obs_registry.json"))
    assert snap["serve.infer_images"] >= 48


@pytest.mark.parametrize("override,kinds,captures", [
    ("serve.ring.enable=true", {"k", "ring"}, 6), ("serve.quant.wire=uint8", {"k"}, 5),
])
def test_cli_serves_ring_and_uint8_wire_on_the_cpu(tmp_path, override, kinds, captures):
    args, _ = _cli_args(tmp_path, "serve.requests=24", "serve.clients=4", override)
    result = serve_cli.main(args + ["--device", "cpu"])
    assert result["completed"] == 24 and result["shed"] == 0 and result["rejected_full"] == 0
    assert result["warmup_forwards"] == captures == len(result["graphs"])
    assert {g["kind"] for g in result["graphs"]} == kinds


@pytest.mark.parametrize("override,match", [
    ("serve.data_parallel=true", "not ported yet"),
    # the zoo, the front door and the faults are served (tests/test_torch_port_frontend.py);
    # the faults in front of a zoo are not (ROADMAP queue 3, F3)
    ("serve.faults.enable=true serve.zoo.models=a=/nowhere", "F3"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, override, match):
    args, _ = _cli_args(tmp_path, "serve.requests=1", *override.split())
    with pytest.raises(ValueError, match=match):
        serve_cli.main(args + ["--device=cpu"])


def test_parse_device():
    assert serve_cli.parse_device(["a=1", "--device", "cpu", "b=2"]) == (["a=1", "b=2"], "cpu")
    assert serve_cli.parse_device(["--device=cuda:0"]) == ([], "cuda:0")
    assert serve_cli.parse_device(["x=1"]) == (["x=1"], "cuda")
    with pytest.raises(ValueError, match="needs a value"):
        serve_cli.parse_device(["--device"])

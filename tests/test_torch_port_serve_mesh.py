"""The port's serving mesh (parallel/mesh.py ``make_serving_mesh``,
serve/engine.py ``mesh=``, cli/serve.py ``serve.data_parallel``) against the
JAX package's mesh engine, on the CPU.

One folded bundle, exported by the port and loaded by both packages, serves
the same seeded images through the port's engine on a CPU mesh of 2 and of
4 lanes and through the JAX engine on a JAX mesh of as many forced host
devices, at rtol/atol 1e-5 (tests/test_serve.py's mesh bar). Within the
port: the "not divisible" and ring refusals, no fence armed on a pool-owned
staging slot (the twin of tests/test_overlap.py's mesh test), the fused
ladder's fallback to the per-chunk path, a zoo on the mesh, the mesh's
devices, and the CLI's ``serve.data_parallel=true``.
"""

import os

import numpy as np
import pytest

import torch

from yet_another_mobilenet_series_tpu.parallel import mesh as jax_mesh
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.serve.engine import InferenceEngine as JaxEngine
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.parallel import ServingMesh, make_serving_mesh
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

from test_torch_port_serve import APP, _images, _port_bundle

MESH_TOL = 1e-5  # tests/test_serve.py: the data-parallel engine against the single-device one


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(port bundle, the same bundle loaded by the JAX package)."""
    tmp = tmp_path_factory.mktemp("mesh")
    port = _port_bundle(tmp)
    return port, jax_export.load_bundle(str(tmp / "bundle"))


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_engine_matches_the_jax_mesh_engine(bundles, n):
    port, jb = bundles
    buckets = (n, 2 * n)
    jax_eng = JaxEngine(jb, buckets=buckets, mesh=jax_mesh.make_mesh(n), donate_input=False, image_size=24)
    eng = InferenceEngine(port, buckets=buckets, mesh=make_serving_mesh(n, "cpu"), device="cpu", image_size=24)
    eng.warmup()
    assert all(g["lanes"] == n and g["key"][2] == 1 for g in eng.graph_report())
    for rows in (2 * n, n + 1, 3 * n + 1):  # a full bucket, a padded one, more than the biggest
        x = _images(rows, rows)
        want = jax_eng.predict(x)
        got = eng.predict(x)
        assert got.shape == want.shape == (rows, 10)
        np.testing.assert_allclose(got, want, rtol=MESH_TOL, atol=MESH_TOL)
    # the mesh of n against the port's single-device engine, bit for bit
    # here (the CPU's dense layers run row by row)
    x = _images(9, 2 * n)
    np.testing.assert_array_equal(eng.predict(x), InferenceEngine(port, buckets=buckets, device="cpu").predict(x))


def test_mesh_refusals_and_no_fence(bundles):
    port, _ = bundles
    mesh = make_serving_mesh(2, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine(port, buckets=(3, 4), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="requires mesh=None"):
        InferenceEngine(port, buckets=(4,), mesh=mesh, device="cpu", ring_slots=2)
    with pytest.raises(ValueError, match="ServingMesh"):
        InferenceEngine(port, buckets=(4,), mesh=object(), device="cpu")
    # overlap on a mesh is inert: padded (slot-pool) and exact dispatches
    # alike copy their rows before the dispatch returns, and no slot is fenced
    ov = InferenceEngine(port, buckets=(4,), mesh=mesh, device="cpu", image_size=24, overlap_staging=True,
                         staging_slots=2, fuse_ladder=(2,))
    plain = InferenceEngine(port, buckets=(4,), mesh=mesh, device="cpu", image_size=24)
    ov.warmup()
    # the fused ladder falls back to the per-chunk path: no fused key, one
    # dispatch per chunk
    assert sorted(g["key"] for g in ov.graph_report()) == [(4, 24, 1)]
    rng = np.random.RandomState(6)
    for n in (3, 4, 8):
        x = rng.normal(0, 1, (n, 24, 24, 3)).astype(np.float32)
        h = ov.predict_async(x)
        assert h.dispatches == -(-n // 4)
        np.testing.assert_array_equal(h.result(), plain.predict(x))
    assert ov._staging and all(s.fence is None for pool in ov._staging.values() for s in pool.slots)


def test_zoo_on_a_mesh(tmp_path):
    a = _port_bundle(tmp_path, seed=0, name="a")
    b = _port_bundle(tmp_path, seed=1, name="b")
    eng = InferenceEngine(models={"a": a, "b": b}, buckets=(2,), mesh=make_serving_mesh(2, "cpu"), device="cpu",
                          image_size=24)
    eng.warmup()
    x = _images(4, 3)
    for name, bundle in (("a", a), ("b", b)):
        # each tenant bit for bit its own single-bundle engine on the same mesh
        alone = InferenceEngine(bundle, buckets=(2,), mesh=make_serving_mesh(2, "cpu"), device="cpu")
        np.testing.assert_array_equal(eng.predict(x, model=name), alone.predict(x))
        np.testing.assert_allclose(eng.predict(x, model=name), InferenceEngine(bundle, buckets=(2,), device="cpu")
                                   .predict(x), rtol=MESH_TOL, atol=MESH_TOL)
    assert not np.allclose(eng.predict(x, model="a"), eng.predict(x, model="b"))


def test_serving_mesh_devices():
    assert make_serving_mesh(3, "cpu") == ServingMesh((torch.device("cpu"),) * 3)
    assert make_serving_mesh(0, "cpu").size == 1
    two = make_serving_mesh(devices=["cpu", "cpu"])
    assert two.devices == (torch.device("cpu"),) * 2
    assert make_serving_mesh(1, devices=["cpu", "cpu"]).size == 1
    with pytest.raises(ValueError, match="requested 3 devices, only 2 visible"):
        make_serving_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        make_serving_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # no CPU fallback for a cuda mesh
            make_serving_mesh(2, "cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            make_serving_mesh(devices=["cuda:0"])


def test_cli_serves_data_parallel_on_the_cpu(tmp_path):
    _port_bundle(tmp_path)
    args = [f"app:{APP}", f"serve.bundle={tmp_path / 'bundle'}", "data.image_size=24",
            f"train.log_dir={tmp_path / 'log'}", "serve.requests=24", "serve.clients=4", "serve.data_parallel=true",
            "dist.num_devices=2", "serve.buckets=[2,8,32]", "serve.ring.enable=true"]
    result = serve_cli.main(args + ["--device", "cpu"])
    assert result["mesh"] == ["cpu", "cpu"] and result["device"] == "cpu"
    assert result["completed"] == 24 and result["shed"] == 0 and result["rejected_full"] == 0
    # two lanes a bucket: no fused key (the shipped ladder falls back), no ring under the mesh
    assert sorted(tuple(g["key"]) for g in result["graphs"]) == [(2, 24, 1), (8, 24, 1), (32, 24, 1)]
    assert {g["kind"] for g in result["graphs"]} == {"k"} and {g["lanes"] for g in result["graphs"]} == {2}
    assert os.path.exists(tmp_path / "log" / "obs_registry.json")

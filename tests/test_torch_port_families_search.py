"""The SE search of the zoo's remaining families, and F3, on the CPU
against the JAX package.

- The SE search: the port's CLI runs ``apps/atomnas_c_se.yml`` (SE with a
  sigmoid gate, swish) cut to a tiny SE supernet, against the JAX package
  driven at the CLI's cadence (tests/test_torch_port_search.py's harness):
  the masks after each event, the rematerializations, the searched net with
  its SE reduce widths and the final state.
- F3 (ROADMAP queue 3), repaired in the port: ``cli/serve.py`` with
  ``serve.faults`` in front of a two-tenant zoo answers each request from
  the tenant it named, bit for bit, and counts the injected failures.
"""

import dataclasses
import os
import threading

import numpy as np

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import parse_cli as jax_parse_cli
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.serialize import network_to_dict as jax_network_to_dict
from yet_another_mobilenet_series_tpu.nas import masking as jmasking
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.serialize import network_to_dict
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.client import ReplicaClient
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

import test_torch_port_search as search_harness
from test_torch_port_frontend import _wait_addr
from test_torch_port_models import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the SE search
# ---------------------------------------------------------------------------

SE_APP = "atomnas_c_se"
# a t=1 block and a stride-2 pair with a residual, every one with SE; swish
# and the sigmoid gate come from the app's arch (atomnas_supernet_se)
SE_SPECS = [{"t": 1, "c": 8, "n": 1, "s": 1, "k": [3, 5], "se": 0.25},
            {"t": 3, "c": 8, "n": 2, "s": 2, "k": [3, 5, 7], "se": 0.25}]
# the shipped config cut as tests/test_torch_port_search.py cuts its own,
# and the app's stem/head pinned to the tiny widths; one device, so no SyncBN
# group and no sharded optimizer
SE_OVERRIDES = search_harness.OVERRIDES + ["dist.sync_bn=false", "dist.shard_optimizer=false",
                                           "model.stem_channels=8", "model.head_channels=32"]


def _se_configs(tmp_path):
    args = SE_OVERRIDES + [f"train.log_dir={tmp_path / 'se_search'}"]
    pc = parse_cli([f"app:{os.path.join(search_harness.PORT_APPS, SE_APP + '.yml')}", *args])
    jc = jax_parse_cli([f"app:{os.path.join(search_harness.JAX_APPS, SE_APP + '.yml')}", *args])
    return (dataclasses.replace(pc, model=dataclasses.replace(pc.model, block_specs=tuple(SE_SPECS))),
            dataclasses.replace(jc, model=dataclasses.replace(jc.model, block_specs=tuple(SE_SPECS))))


def test_se_search_event_rematerialization_and_se_widths_match_jax(tmp_path, monkeypatch):
    h = search_harness
    pc, jc = _se_configs(tmp_path)
    assert pc.model.arch == "atomnas_supernet_se" and pc.model.active_fn == "swish"
    jnet = jax_get_model(jc.model, h.IMAGE)
    assert all(b.se_channels and b.se_gate_fn == "sigmoid" and b.active_fn == "swish" for b in jnet.blocks)
    params = jax.tree.map(jnp.asarray, convert.unflatten_tree(numpy_params(jnet, 3)))
    lr = jsched.make_lr_schedule(jc.schedule, h.BATCH, h.STEPS_PER_EPOCH, h.EPOCHS)
    opt = joptim.make_optimizer(jc.optim, lr, params)
    jts0 = jsteps.init_train_state(jnet, jc, opt, jax.random.PRNGKey(0))
    jts0 = jts0.replace(params=params, opt_state=opt.init(params), ema_params=jax.tree.map(jnp.copy, params),
                        masks=jmasking.init_masks(jnet), rho_mult=jnp.ones((), jnp.float32))
    batches = h._batches(h.EPOCHS * h.STEPS_PER_EPOCH)
    port_events = []
    real_event = train_cli._prune_event

    def spy(trainer, ts, step_i, tracer):
        ts = real_event(trainer, ts, step_i, tracer)
        port_events.append((step_i, {k: v.numpy().copy() for k, v in ts.masks.items()}))
        return ts

    monkeypatch.setattr(train_cli.Trainer, "init_state", lambda self, seed: convert.train_state_from_jax(jts0))
    monkeypatch.setattr(train_cli.data_lib, "make_train_source", lambda *a, **k: (
        {"image": torch.from_numpy(x), "label": torch.from_numpy(y)} for x, y in batches))
    monkeypatch.setattr(train_cli, "_prune_event", spy)
    summary, pts, pnet = train_cli.train(pc, device="cpu")
    events, reports, jfinal, jts = h._jax_search(jc, jts0, batches)

    assert [s for s, _ in port_events] == [s for s, _ in events] == [1, 2, 3]
    for (step, mine), (_, theirs) in zip(port_events, events):
        assert set(mine) == set(theirs), step
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=f"masks after the event at step {step}")
    first = port_events[0][1]
    assert 0 < sum(m.sum() for m in first.values()) < sum(m.size for m in first.values())
    remats = summary["remats"]
    assert remats and [r["step"] for r in remats] == [s for s, _ in reports]
    for mine, (_, theirs) in zip(remats, reports):
        assert (mine["atoms_before"], mine["atoms_after"], mine["dropped_blocks"]) == \
               (theirs.atoms_before, theirs.atoms_after, theirs.dropped_blocks)
    # the searched net: every block's expanded width, branches and SE reduce
    # width as the JAX package's, and the SE weights at those shapes
    assert network_to_dict(pnet) == jax_network_to_dict(jfinal)
    assert [(b.expanded_channels, b.group_channels, b.se_channels) for b in pnet.blocks] == \
           [(b.expanded_channels, b.group_channels, b.se_channels) for b in jfinal.blocks]
    assert any(b.expanded_channels < b0.expanded_channels for b, b0 in zip(pnet.blocks, jnet.blocks))
    carried = convert.train_state_to_jax(pts, jts.opt_state)
    for field in ("params", "state", "opt_state", "ema_params", "ema_state"):
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, getattr(jts, field)))
        got = jax.tree_util.tree_leaves(carried[field])
        assert [a.shape for a in want] == [np.shape(b) for b in got], field
        worst = max(float((np.abs(a - b) / (1.0 + np.abs(a))).max()) for a, b in zip(want, got))
        assert worst < h.WEIGHT_TOL, (field, worst)
    se_keys = [k for k in convert.flatten_tree(pts.params) if "/se/" in k]
    assert se_keys and summary["steps"] == summary["finite_steps"] == h.EPOCHS * h.STEPS_PER_EPOCH


# ---------------------------------------------------------------------------
# F3: the fault injector in front of a zoo
# ---------------------------------------------------------------------------

ZOO_SIZE = 24
ZOO_SPECS = {"small": [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5]}],
             "big": [{"t": 3, "c": 16, "n": 2, "s": 2}, {"t": 4, "c": 24, "n": 1, "s": 2, "se": 0.25}]}
ZOO_CLASSES = {"small": 10, "big": 7}
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")


def _zoo_bundle(tmp_path, name, seed):
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=ZOO_CLASSES[name], block_specs=ZOO_SPECS[name],
                                dropout=0.0), image_size=ZOO_SIZE)
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    return export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / name), model_name=name,
                                device="cpu")


def test_f3_a_zoo_under_faults_answers_each_request_from_the_tenant_it_named(tmp_path):
    dirs = {"small": _zoo_bundle(tmp_path, "small", 0), "big": _zoo_bundle(tmp_path, "big", 1)}
    log_dir = str(tmp_path / "srv")
    cfg = parse_cli([f"app:{APP}", "serve.listen.enable=true", f"data.image_size={ZOO_SIZE}", "serve.buckets=[1]",
                     "serve.max_batch=1", "serve.drain_timeout_s=10", f"train.log_dir={log_dir}",
                     "serve.zoo.models=" + ",".join(f"{m}={d}" for m, d in dirs.items()),
                     "serve.faults.enable=true", "serve.faults.fail_first_n=2", "serve.faults.fail_at=result"])
    get_registry().reset()
    stop = threading.Event()
    out: dict = {}
    th = threading.Thread(target=lambda: out.update(serve_cli.run(cfg, device="cpu", stop_event=stop)))
    th.start()
    try:
        addr = _wait_addr(log_dir, th.is_alive)
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
        refs = {m: InferenceEngine(export.load_bundle(d), device="cpu", buckets=(1,)) for m, d in dirs.items()}
        x = np.random.RandomState(5).normal(0, 1, (3, ZOO_SIZE, ZOO_SIZE, 3)).astype(np.float32)
        try:
            for i in range(3):
                for model in ("big", "small"):
                    got = client.predict(x[i], model=model)
                    assert got.shape == (ZOO_CLASSES[model],), (model, got.shape)
                    np.testing.assert_array_equal(got, refs[model].predict(x[i: i + 1])[0])
                # no X-Model: the zoo's default (its first) tenant
                np.testing.assert_array_equal(client.predict(x[i]), refs["small"].predict(x[i: i + 1])[0])
        finally:
            client.close()
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive()
    snap = get_registry().snapshot()
    # the first request of the round rode two injected failures and their retries
    assert snap["serve.faults.failures"] == 2 and snap["serve.retries"] == 2
    assert snap["serve.model_requests.big"] == 3 and snap["serve.model_requests.small"] == 6

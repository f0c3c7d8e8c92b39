"""The AtomNAS search through the port's training CLI (cli/train.py with
``prune.enable``), its export with dead masks (serve/export.py) and the
retrain of the searched network, on the CPU, against the JAX package.

The port's CLI runs the shipped ``apps/atomnas_a_search.yml`` on a tiny
supernet; its initial state and its batches are the ones the JAX side
takes (the two packages draw weights and data from different generators).
The JAX side is driven through ``train/steps.py``, ``nas/masking.py`` and
``nas/rematerialize.py`` at the CLI's cadence: the event after every
``mask_interval``-th step up to the stop step, a rematerialization at each
``remat_epochs`` boundary that found dead atoms, a last one at the end.
The masks after each event, the rematerializations and the searched
architecture must be equal; the final weights within 1e-5 of 1 + |w|
(float32 rounding of two programs over a few steps: 3.0e-7 measured).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import parse_cli as jax_parse_cli
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.serialize import network_to_dict as jax_network_to_dict
from yet_another_mobilenet_series_tpu.nas import masking as jmasking, penalty as jpenalty
from yet_another_mobilenet_series_tpu.nas import rematerialize as jremat
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu.utils.cadence import StepCadence
from yet_another_mobilenet_series_tpu.utils.profiling import profile_network as jax_profile_network
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import parse_cli
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.serialize import network_to_dict
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.nas import masking
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

from test_torch_port_models import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps")
JAX_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu", "apps")
FOLD_ATOL = 1e-4  # tests/test_serve.py's folded-logits bar
WEIGHT_TOL = 1e-5

# a t=1 block, a stride-2 block without residual and a residual one
SPECS = [{"t": 1, "c": 8, "n": 1, "s": 1, "k": [3, 5]}, {"t": 3, "c": 8, "n": 2, "s": 2, "k": [3, 5, 7]}]
BATCH, IMAGE, STEPS_PER_EPOCH, EPOCHS = 8, 16, 2, 3
# the shipped search config cut to this size: width (the tiny spec), image
# size, classes, batch, dataset and length; the prune cadence shortened so
# that events and a rematerialization happen mid-run; f32, no dropout and
# no drop path (the two packages' random streams differ); the gamma
# threshold at 0.9 so that the numpy-made gammas (U(0.5, 1.5)) below it die
# at the first event, none within float32 rounding of it
OVERRIDES = ["dist.num_devices=1", "data.dataset=fake", f"data.image_size={IMAGE}", "model.num_classes=4",
             "model.dropout=0.0", "model.drop_connect=0.0", f"train.batch_size={BATCH}",
             f"data.fake_train_size={BATCH * STEPS_PER_EPOCH}", "data.fake_eval_size=8", "train.eval_batch_size=8",
             f"train.epochs={EPOCHS}", "train.log_every=2", "train.compute_dtype=float32", "prune.mask_interval=1",
             "prune.remat_epochs=1", "prune.gamma_threshold=0.9", "prune.target_flops=0"]
APPS = ["atomnas_a_search", "atomnas_b_search", "atomnas_c_search", "atomnas_c_se", "retrain_searched"]


@pytest.mark.parametrize("app", APPS)
def test_shipped_search_configs_are_the_jax_ones(app):
    mine = parse_cli([f"app:{os.path.join(PORT_APPS, app + '.yml')}"])
    theirs = jax_parse_cli([f"app:{os.path.join(JAX_APPS, app + '.yml')}"])
    assert repr(mine) == repr(theirs)


def _configs(tmp_path, *extra):
    args = OVERRIDES + [f"train.log_dir={tmp_path / 'search'}", *extra]
    pc = parse_cli([f"app:{os.path.join(PORT_APPS, 'atomnas_a_search.yml')}", *args])
    jc = jax_parse_cli([f"app:{os.path.join(JAX_APPS, 'atomnas_a_search.yml')}", *args])
    return (dataclasses.replace(pc, model=dataclasses.replace(pc.model, block_specs=tuple(SPECS))),
            dataclasses.replace(jc, model=dataclasses.replace(jc.model, block_specs=tuple(SPECS))))


def _batches(n):
    rs = np.random.RandomState(11)
    return [(rs.normal(0, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             rs.randint(0, 4, BATCH).astype(np.int32)) for _ in range(n)]


def _jax_search(jc, jts, batches):
    """The JAX package's search at its CLI's cadence (single dispatches):
    returns (masks after each event, remat reports, final net, final ts)."""
    net = jax_get_model(jc.model, IMAGE)
    stop = int(jc.prune.stop_epoch_frac * EPOCHS * STEPS_PER_EPOCH)

    def build(net):
        lr = jsched.make_lr_schedule(jc.schedule, BATCH, STEPS_PER_EPOCH, EPOCHS)
        opt = joptim.make_optimizer(jc.optim, lr, jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0)))[0])
        pen = jpenalty.make_penalty_fn(net, jc.prune, STEPS_PER_EPOCH)
        return (jax.jit(jsteps.make_train_step(net, jc, opt, lr, penalty_fn=pen)),
                jax.jit(jmasking.make_prune_event(net, jc.prune, stop)))

    def remat(net, ts):
        s = jmasking.mask_summary(net, ts.masks)
        if s["alive_atoms"] == s["total_atoms"]:
            return net, ts, None
        new_net, p, st, m, extras, report = jremat.rematerialize(
            net, ts.params, ts.state, ts.masks, opt_state=ts.opt_state, ema_params=ts.ema_params,
            ema_state=ts.ema_state)
        return new_net, jsteps.TrainState(step=ts.step, params=p, state=st, opt_state=extras["opt_state"],
                                          ema_params=extras["ema_params"], ema_state=extras["ema_state"],
                                          masks=m, rho_mult=ts.rho_mult), report

    step, event = build(net)
    cadence = StepCadence(jc.prune.remat_epochs, STEPS_PER_EPOCH, 0)
    events, reports, host_step, it = [], [], 0, iter(batches)
    for _ in range(EPOCHS):
        for _ in range(STEPS_PER_EPOCH):
            x, y = next(it)
            jts, _ = step(jts, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
            host_step += 1
            if host_step % jc.prune.mask_interval == 0 and host_step <= stop:
                masks, rho = event(jts.params, jts.masks, jts.rho_mult, jts.step)
                jts = jts.replace(masks=masks, rho_mult=rho)
                events.append((host_step, {k: np.asarray(v) for k, v in masks.items()}))
        if cadence.due(host_step):
            net, jts, report = remat(net, jts)
            if report is not None:
                reports.append((host_step, report))
                step, event = build(net)
    net, jts, report = remat(net, jts)
    if report is not None:
        reports.append((host_step, report))
    return events, reports, net, jts


@pytest.fixture(scope="module")
def search(tmp_path_factory, request):
    """The port's CLI search and the JAX package's, from one state on the
    same batches."""
    tmp_path = tmp_path_factory.mktemp("search")
    pc, jc = _configs(tmp_path)
    jnet = jax_get_model(jc.model, IMAGE)
    params = jax.tree.map(jnp.asarray, convert.unflatten_tree(numpy_params(jnet, 0)))
    lr = jsched.make_lr_schedule(jc.schedule, BATCH, STEPS_PER_EPOCH, EPOCHS)
    opt = joptim.make_optimizer(jc.optim, lr, params)
    jts0 = jsteps.init_train_state(jnet, jc, opt, jax.random.PRNGKey(0))
    jts0 = jts0.replace(params=params, opt_state=opt.init(params), ema_params=jax.tree.map(jnp.copy, params),
                        masks=jmasking.init_masks(jnet), rho_mult=jnp.ones((), jnp.float32))
    batches = _batches(EPOCHS * STEPS_PER_EPOCH)

    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    port_events = []
    real_event = train_cli._prune_event

    def spy(trainer, ts, step_i, tracer):
        ts = real_event(trainer, ts, step_i, tracer)
        port_events.append((step_i, {k: v.numpy().copy() for k, v in ts.masks.items()}))
        return ts

    mp.setattr(train_cli.Trainer, "init_state", lambda self, seed: convert.train_state_from_jax(jts0))
    mp.setattr(train_cli.data_lib, "make_train_source", lambda *a, **k: (
        {"image": torch.from_numpy(x), "label": torch.from_numpy(y)} for x, y in batches))
    mp.setattr(train_cli, "_prune_event", spy)
    rebuilds0 = get_registry().snapshot().get("train.rebuilds", 0)
    summary, pts, pnet = train_cli.train(pc, device="cpu")
    rebuilds = get_registry().snapshot().get("train.rebuilds", 0) - rebuilds0
    mp.undo()
    return {"summary": summary, "pts": pts, "pnet": pnet, "port_events": port_events, "rebuilds": rebuilds,
            "jax": _jax_search(jc, jts0, batches), "jnet0": jnet, "pc": pc, "jc": jc, "tmp": tmp_path}


def test_search_masks_and_rematerializations_match_jax(search):
    events, reports, jnet, jts = search["jax"]
    summary = search["summary"]
    assert [s for s, _ in search["port_events"]] == [s for s, _ in events] == [1, 2, 3]
    for (step, mine), (_, theirs) in zip(search["port_events"], events):
        assert set(mine) == set(theirs), step
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=f"masks after the event at step {step}")
    # atoms died at the first event; a rematerialization at the first epoch
    # boundary rebuilt the trainer and training went on on the shrunk net
    first = search["port_events"][0][1]
    assert sum(m.sum() for m in first.values()) < sum(m.size for m in first.values())
    remats = summary["remats"]
    assert [r["step"] for r in remats] == [s for s, _ in reports] and remats[0]["step"] == STEPS_PER_EPOCH
    for mine, (_, theirs) in zip(remats, reports):
        assert (mine["atoms_before"], mine["atoms_after"], mine["dropped_blocks"]) == \
               (theirs.atoms_before, theirs.atoms_after, theirs.dropped_blocks)
        assert mine["macs_after"] < mine["macs_before"]
    assert search["rebuilds"] == len(remats) >= 1
    assert summary["steps"] == summary["step"] == summary["finite_steps"] == EPOCHS * STEPS_PER_EPOCH
    assert all(np.isfinite(s["loss"]) and "effective_macs" in s and s["penalty"] > 0 for s in summary["log"])


def test_searched_arch_matches_jax(search):
    _, _, jnet, jts = search["jax"]
    summary, pnet = search["summary"], search["pnet"]
    path = os.path.join(search["pc"].train.log_dir, "searched_arch.json")
    assert summary["searched"]["path"] == path
    with open(path) as f:
        payload = json.load(f)
    prof = jax_profile_network(jnet)
    assert payload["network"] == network_to_dict(pnet) == jax_network_to_dict(jnet)
    assert (payload["macs"], payload["params"], payload["step"]) == \
           (prof.total_macs, prof.total_params, int(jts.step)) == \
           (summary["searched"]["macs"], summary["searched"]["params"], EPOCHS * STEPS_PER_EPOCH)
    assert payload["macs"] < jax_profile_network(search["jnet0"]).total_macs
    # the final state: every field within float32 rounding of the JAX one
    carried = convert.train_state_to_jax(search["pts"], jts.opt_state)
    for field in ("params", "state", "opt_state", "ema_params", "ema_state"):
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, getattr(jts, field)))
        got = jax.tree_util.tree_leaves(carried[field])
        assert len(want) == len(got), field
        worst = max(float((np.abs(a - b) / (1.0 + np.abs(a))).max()) for a, b in zip(want, got))
        assert worst < WEIGHT_TOL, (field, worst)
    for k, m in search["pts"].masks.items():
        assert float(m.min()) == 1.0, k  # the final net carries no dead atom


def test_retrain_from_searched_arch(search, tmp_path):
    spec = os.path.join(search["pc"].train.log_dir, "searched_arch.json")
    cfg = parse_cli([f"app:{os.path.join(PORT_APPS, 'retrain_searched.yml')}", f"model.network_spec={spec}",
                     "dist.num_devices=1", "data.dataset=fake", f"data.image_size={IMAGE}", "model.num_classes=4",
                     f"train.batch_size={BATCH}", f"data.fake_train_size={BATCH * 2}", "data.fake_eval_size=8",
                     "train.eval_batch_size=8", "train.epochs=1", "train.log_every=1",
                     f"train.log_dir={tmp_path / 'retrain'}"])
    summary, ts, net = train_cli.train(cfg, device="cpu")
    assert summary["steps"] == summary["finite_steps"] == 2 and "searched" not in summary
    assert net.blocks == search["pnet"].blocks and ts.masks == {}


def _dead_masks(net, seed=0):
    rng = np.random.RandomState(seed)
    masks = {}
    for i in masking.prunable_blocks(net):
        m = (rng.uniform(size=net.blocks[i].expanded_channels) > 0.4).astype(np.float32)
        m[0] = 1.0
        masks[str(i)] = m
    residual = [i for i in masking.prunable_blocks(net) if net.blocks[i].has_residual]
    masks[str(residual[0])][:] = 0.0  # a residual block dropped whole
    return masks


def test_dead_mask_bundles_cross_both_ways(tmp_path):
    """export_bundle with dead masks hard-applies them (rematerialize) in
    both packages: the same inference spec, each bundle's digest verified
    by the other package, logits within FOLD_ATOL."""
    _, jc = _configs(tmp_path)
    jnet = jax_get_model(jc.model, IMAGE)
    pnet = get_model(_configs(tmp_path)[0].model, IMAGE)
    flat = numpy_params(jnet, 1)
    state = convert.to_jax(random_bn_state(pnet, torch.Generator().manual_seed(1)))
    masks = _dead_masks(pnet)
    jtree = lambda f: jax.tree.map(jnp.asarray, convert.unflatten_tree(f))  # noqa: E731
    mine = export.export_bundle(pnet, convert.from_jax(flat), convert.from_jax(state), str(tmp_path / "port"),
                                masks={k: torch.from_numpy(v) for k, v in masks.items()}, model_name="searched")
    theirs = str(tmp_path / "jax")
    jax_export.export_bundle(jnet, jtree(flat), jtree(state), theirs, masks={k: jnp.asarray(v) for k, v in
                                                                            masks.items()}, model_name="searched")
    pb, jb = export.load_bundle(theirs), jax_export.load_bundle(mine)  # each verifies the other's digest
    assert pb.digest == json.load(open(os.path.join(theirs, "meta.json")))["digest"]
    assert jb.digest == json.load(open(os.path.join(mine, "meta.json")))["digest"]
    own = export.load_bundle(mine)
    assert own.net == pb.net and len(own.net.blocks) == len(pnet.blocks) - 1
    assert own.meta["prune"] == json.load(open(os.path.join(theirs, "meta.json")))["prune"]
    x = np.random.RandomState(2).normal(0, 1, (4, IMAGE, IMAGE, 3)).astype(np.float32)
    a = InferenceEngine(own, device="cpu", buckets=(4,)).predict(x)
    b = InferenceEngine(pb, device="cpu", buckets=(4,)).predict(x)
    want = np.asarray(jax_export.apply_folded(jb.net, jb.params, jnp.asarray(x)))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(a, want, atol=FOLD_ATOL, rtol=0)
    np.testing.assert_allclose(b, want, atol=FOLD_ATOL, rtol=0)
    # the masked supernet's eval forward is what the searched bundle serves
    with torch.no_grad():
        masked = pnet.apply(convert.from_jax(flat), convert.from_jax(state), torch.from_numpy(x),
                            masks={int(k): torch.from_numpy(v) for k, v in masks.items()})
    np.testing.assert_allclose(a, masked.numpy(), atol=FOLD_ATOL, rtol=0)

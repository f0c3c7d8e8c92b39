"""The port's checkpoints (ckpt/manager.py), export from a checkpoint
(serve/export.py ``export_checkpoint``, cli/serve.py ``serve.export_from``)
and eval-only runs of a checkpoint, on the CPU, held to the JAX package.

The mirrors of tests/test_ckpt.py: save -> restore -> next step is bit for
bit the step never checkpointed; an empty dir restores None; digests are
recorded and verified; ``tree_keys``; the pruned shape first. Then what
Orbax gave the JAX package and the port writes itself: the host snapshot of
an async save, ``max_to_keep``, a save killed mid-write, a step saved
twice. Across the packages: a JAX ``CheckpointManager`` checkpoint (read
here through Orbax; the port never reads one) carried across with
``convert.train_state_from_jax`` and saved by the port exports to the bundle
the JAX package exports from its own checkpoint (the same spec and
pass-through weights, BN folds within the fold's ulps, so the digests are
equal exactly when the folds are: ROADMAP F6), with logits within
FOLD_ATOL; and ``train.test_only`` on the two checkpoints gives one eval
loss within the f32 bar.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_port_serve import FOLD_ATOL, FOLD_W_MAX_ULP
from yet_another_mobilenet_series_tpu.ckpt.manager import CheckpointManager as JaxCheckpointManager
from yet_another_mobilenet_series_tpu.cli import train as jax_train_cli
from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
from yet_another_mobilenet_series_tpu.data import pipeline as jax_pipeline
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.serialize import network_to_dict as jax_network_to_dict
from yet_another_mobilenet_series_tpu.nas import masking as jax_masking
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.serve.engine import InferenceEngine as JaxEngine
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointCorrupt, CheckpointManager
from yet_another_mobilenet_series_tpu_torch.ckpt import manager as mgr_mod
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict, parse_cli
from yet_another_mobilenet_series_tpu_torch.data import pipeline
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.serialize import network_from_dict
from yet_another_mobilenet_series_tpu_torch.nas import rematerialize
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")
SUPERNET = {"arch": "atomnas_supernet", "num_classes": 4, "dropout": 0.0,
            "block_specs": [{"t": 4, "c": 8, "n": 1, "s": 2, "k": [3, 5]}]}


def _mk(tmp_path):
    cfg = config_from_dict({
        "model": SUPERNET,
        "schedule": {"schedule": "constant", "base_lr": 0.02, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": True, "decay": 0.9, "warmup": False},
        "train": {"compute_dtype": "float32", "log_dir": str(tmp_path)},
        "prune": {"enable": True},
    })
    net = get_model(cfg.model, image_size=16)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, 8, 1, 10)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    step_fn = steps.make_train_step(net, cfg, opt, lr_fn)
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn((8, 16, 16, 3), generator=gen), "label": torch.arange(8) % 4}
    return cfg, net, ts, step_fn, batch


def _equal(a, b):
    fa, fb = convert.flatten_tree(steps.train_state_to_dict(a)), convert.flatten_tree(steps.train_state_to_dict(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_save_restore_step_bit_equivalence(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    ts, _ = step_fn(ts, batch, torch.Generator().manual_seed(2))
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(int(ts.step), net, ts, extra={"epoch": 0.5})
    mgr.wait()
    ts_cont, _ = step_fn(ts, batch, torch.Generator().manual_seed(2))
    step, net2, extra = mgr.restore_spec()
    assert net2 == net and extra["epoch"] == 0.5 and step == 1
    tree = mgr.restore_tree(step, steps.train_state_to_dict(ts))
    ts_rest2, _ = step_fn(steps.train_state_from_dict(tree), batch, torch.Generator().manual_seed(2))
    _equal(ts_cont, ts_rest2)
    mgr.close()


def test_restore_spec_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"), async_save=False)
    assert mgr.restore_spec() is None and mgr.all_steps() == [] and mgr.latest_step() is None
    assert not (tmp_path / "empty").exists()  # the directory is made by the first save
    mgr.close()


def test_save_records_digests_and_restore_verifies(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    ts, _ = step_fn(ts, batch, torch.Generator().manual_seed(2))
    mgr = CheckpointManager(str(tmp_path / "ckd"), async_save=False)
    mgr.save(int(ts.step), net, ts, items={"generator": torch.Generator().manual_seed(5).get_state()})
    digest_path = tmp_path / "ckd" / mgr_mod.DIGEST_NAME
    index = json.loads(digest_path.read_text())
    items = index[str(int(ts.step))]
    # every non-empty TrainState item is protected, and the generator's state
    assert set(items) == {"step", "params", "state", "opt_state", "ema_params", "ema_state", "masks", "rho_mult",
                          "generator"}
    target = steps.train_state_to_dict(ts)
    tree = mgr.restore_tree(int(ts.step), target)  # verifies, passes
    assert set(tree) == set(target) | {"generator"}
    assert torch.equal(tree["generator"], torch.Generator().manual_seed(5).get_state())
    items["params"] = "0" * 64
    digest_path.write_text(json.dumps(index))
    before = _counter("ckpt.integrity_failures")
    with pytest.raises(CheckpointCorrupt, match="params"):
        mgr.restore_tree(int(ts.step), target)
    assert _counter("ckpt.integrity_failures") == before + 1
    mgr.restore_tree(int(ts.step))  # the as-saved export read stays unverified
    mgr.close()


def _counter(name):
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry

    return get_registry().snapshot().get(name, 0.0)


def test_tree_keys_reports_saved_items(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckk"), async_save=False)
    mgr.save(3, net, ts.replace(ema_params=None, ema_state=None))
    keys = mgr.tree_keys(3)
    assert keys is not None and {"params", "opt_state", "rho_mult", "ema_params"} <= keys  # None items too
    assert mgr.tree_keys(99) is None  # a step that does not exist degrades to None
    mgr.close()


def test_restore_pruned_shape_first(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    masks = {k: torch.from_numpy(np.r_[np.ones(8), np.zeros(v.shape[0] - 8)].astype(np.float32))
             for k, v in ts.masks.items()}
    new_net, p, s, m, extras, _ = rematerialize.rematerialize(
        net, ts.params, ts.state, masks, opt_state=ts.opt_state, ema_params=ts.ema_params, ema_state=ts.ema_state)
    ts2 = steps.TrainState(step=ts.step, params=p, state=s, opt_state=extras["opt_state"],
                           ema_params=extras["ema_params"], ema_state=extras["ema_state"], masks=m,
                           rho_mult=ts.rho_mult)
    mgr = CheckpointManager(str(tmp_path / "ck2"), async_save=False)
    mgr.save(7, new_net, ts2)
    step, net3, _ = mgr.restore_spec()
    assert step == 7 and net3 == new_net and net3.blocks[0].expanded_channels == 8
    _equal(steps.train_state_from_dict(mgr.restore_tree(7, steps.train_state_to_dict(ts2))), ts2)
    mgr.close()


def test_async_save_snapshots_at_save_time(tmp_path):
    """The write runs on a thread; what it writes is the state at save(),
    whatever happens to the live tensors after."""
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    want = steps.train_state_from_dict({k: v for k, v in convert.unflatten_tree(
        {k: t.clone() for k, t in convert.flatten_tree(steps.train_state_to_dict(ts)).items()}).items()})
    mgr = CheckpointManager(str(tmp_path / "cka"), async_save=True)
    mgr.save(1, net, ts)
    for t in convert.flatten_tree(steps.train_state_to_dict(ts)).values():
        t.zero_()  # in place, before the write is waited for
    mgr.wait()
    _equal(steps.train_state_from_dict(mgr.restore_tree(1, steps.train_state_to_dict(want))), want)
    mgr.close()


def test_max_to_keep_prunes_steps_and_their_digests(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckm"), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, net, ts)
    mgr.wait()
    assert mgr.all_steps() == [4, 3] and mgr.latest_step() == 4
    mgr.save(5, net, ts)
    mgr.close()
    index = json.loads((tmp_path / "ckm" / mgr_mod.DIGEST_NAME).read_text())
    # entries of pruned steps go at the next save (the one being pruned may linger one save)
    assert {"4", "5"} <= set(index) <= {"3", "4", "5"} and mgr.all_steps() == [5, 4]


def test_a_save_killed_mid_write_leaves_the_previous_step_whole(tmp_path):
    """A kill mid-save leaves a step dir under its temporary name: not a
    step, removed by the next manager; the previous step restores."""
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    root = tmp_path / "ckk"
    mgr = CheckpointManager(str(root), async_save=False)
    mgr.save(1, net, ts)
    torn = root / f"2{mgr_mod._TMP}4242"
    (torn / mgr_mod.TREE_DIR).mkdir(parents=True)
    (torn / mgr_mod.TREE_DIR / "params.pt").write_bytes(b"\x50\x4b half")
    assert mgr.all_steps() == [1]
    mgr2 = CheckpointManager(str(root), async_save=False)
    assert not torn.exists() and mgr2.latest_step() == 1
    _equal(steps.train_state_from_dict(mgr2.restore_tree(1, steps.train_state_to_dict(ts))), ts)


def test_a_step_saved_again_is_replaced(tmp_path):
    cfg, net, ts, step_fn, batch = _mk(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ckr"), async_save=False)
    mgr.save(1, net, ts, extra={"tag": "first"})
    ts2, _ = step_fn(ts, batch, torch.Generator().manual_seed(2))
    mgr.save(1, net, ts2, extra={"tag": "second"})
    assert mgr.all_steps() == [1] and mgr.restore_spec(1)[2]["tag"] == "second"
    _equal(steps.train_state_from_dict(mgr.restore_tree(1, steps.train_state_to_dict(ts2))), ts2)


# ---------------------------------------------------------------------------
# across the packages: a JAX checkpoint carried into the port
# ---------------------------------------------------------------------------

TINY_V2 = {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
           "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}, {"t": 3, "c": 8, "n": 1, "s": 1, "k": [3, 5]}]}


def _jax_checkpoint(tmp_path):
    """A JAX TrainState after one step, with some atoms of block 1 dead,
    saved by the JAX package's manager; returns its config, net and dir."""
    jc = jax_config_from_dict({"model": TINY_V2, "train": {"compute_dtype": "float32"}, "prune": {"enable": True},
                               "ema": {"enable": True, "decay": 0.9, "warmup": False}})
    jnet = jax_get_model(jc.model, image_size=16)
    lr = jsched.make_lr_schedule(jc.schedule, 8, 1, 10)
    params, _ = jnet.init(jax.random.PRNGKey(0))
    jopt = joptim.make_optimizer(jc.optim, lr, params)
    jts = jsteps.init_train_state(jnet, jc, jopt, jax.random.PRNGKey(0))
    jts = jts.replace(masks=jax_masking.init_masks(jnet))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, 16, 3))
    jts, _ = jax.jit(jsteps.make_train_step(jnet, jc, jopt, lr))(jts, {"image": x, "label": jnp.arange(8) % 4},
                                                                   jax.random.PRNGKey(2))
    dead = np.ones(jts.masks["1"].shape, np.float32)
    dead[::3] = 0.0
    jts = jts.replace(masks={**jts.masks, "1": jnp.asarray(dead)})
    out = str(tmp_path / "jax_ck")
    mgr = JaxCheckpointManager(out, async_save=False)
    mgr.save(int(jts.step), jnet, jax.device_get(jts), extra={"epoch": 1.0})
    mgr.wait()
    mgr.close()
    return jc, jnet, jts, out


def _carry(tmp_path):
    """The JAX checkpoint read through Orbax, carried across and saved by the
    port's manager; returns the JAX dir, the port's dir and both nets."""
    jc, jnet, jts, jax_dir = _jax_checkpoint(tmp_path)
    jmgr = JaxCheckpointManager(jax_dir, async_save=False)
    step, jnet2, extra = jmgr.restore_spec()
    tree = jmgr.restore_tree(step, jsteps.train_state_to_dict(jax.eval_shape(lambda: jts)))
    jmgr.close()
    pts = convert.train_state_from_jax(jsteps.TrainState(**tree))
    pnet = network_from_dict(jax_network_to_dict(jnet2))
    port_dir = str(tmp_path / "port_ck")
    mgr = CheckpointManager(port_dir, async_save=False)
    mgr.save(step, pnet, pts, extra=extra)
    mgr.close()
    return jax_dir, port_dir, jnet, pnet, pts


def test_a_jax_checkpoint_carried_across_exports_the_jax_bundle(tmp_path):
    jax_dir, port_dir, jnet, pnet, pts = _carry(tmp_path)
    jb_dir = jax_export.export_checkpoint(jax_dir, str(tmp_path / "jax_bundle"))
    pb_dir = export.export_checkpoint(port_dir, str(tmp_path / "port_bundle"), device="cpu")
    jmeta, pmeta = (json.load(open(os.path.join(d, "meta.json"))) for d in (jb_dir, pb_dir))
    assert {k: pmeta[k] for k in ("step", "ema", "epoch", "prune")} == \
        {k: jmeta[k] for k in ("step", "ema", "epoch", "prune")}
    assert pmeta["ema"] is True and pmeta["prune"]["atoms_after"] < pmeta["prune"]["atoms_before"]
    assert json.load(open(os.path.join(pb_dir, "spec.json"))) == json.load(open(os.path.join(jb_dir, "spec.json")))
    with np.load(os.path.join(jb_dir, "weights.npz")) as z:
        want = {k: z[k] for k in z.files}
    with np.load(os.path.join(pb_dir, "weights.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    folded = set()
    for k in want:
        if np.array_equal(got[k], want[k]):
            continue
        # only the BN folds may differ: XLA's rsqrt against torch's (ROADMAP F6)
        assert k.endswith("/w") and got[k].ndim == 4 or k.endswith("/b") and not k.startswith(("classifier", "se")), k
        if k.endswith("/w"):
            np.testing.assert_array_max_ulp(got[k], want[k], maxulp=FOLD_W_MAX_ULP)
        folded.add(k)
    # a content digest: the same string exactly when the folded bytes are
    same = export.bundle_digest(json.load(open(os.path.join(pb_dir, "spec.json"))), want)
    assert same == jmeta["digest"]
    assert (pmeta["digest"] == jmeta["digest"]) == (not folded)
    x = np.random.RandomState(3).normal(0, 1, (4, 16, 16, 3)).astype(np.float32)
    ours = InferenceEngine(export.load_bundle(pb_dir), device="cpu", buckets=(4,)).predict(x)
    theirs = np.asarray(JaxEngine(jax_export.load_bundle(jb_dir), buckets=(4,), fuse_ladder=()).predict(x))
    assert np.abs(theirs).max() > 1e-3
    np.testing.assert_allclose(ours, theirs, atol=FOLD_ATOL, rtol=0)
    # and the EMA forward of the carried state, unfolded
    with torch.no_grad():
        ema = pnet.apply(pts.ema_params, pts.ema_state, torch.from_numpy(x), train=False,
                         masks={int(k): v for k, v in pts.masks.items()}).numpy()
    np.testing.assert_allclose(ours, ema, atol=FOLD_ATOL, rtol=0)


@pytest.mark.parametrize("weights", ["float32", "int8"])
def test_serve_cli_exports_from_a_checkpoint_then_serves(tmp_path, weights):
    _, port_dir, _, pnet, _ = _carry(tmp_path)
    log_dir = tmp_path / "srv"
    cfg = parse_cli([f"app:{SERVE_APP}", f"serve.export_from={port_dir}", "data.image_size=16", "serve.requests=12",
                     "serve.clients=3", "serve.buckets=[1,4]", f"serve.quant.weights={weights}",
                     "serve.quant.int8_top1_min=0.5", f"train.log_dir={log_dir}"])
    out = serve_cli.run(cfg, device="cpu")
    assert out["bundle"] == str(log_dir / "bundle") and out["completed"] == 12
    bundle = export.load_bundle(out["bundle"])
    assert bundle.weights == weights and bundle.meta["source"] == port_dir and bundle.meta["step"] == 1
    assert bundle.net.blocks[1].expanded_channels < pnet.blocks[1].expanded_channels  # the dead atoms are gone


def _eval_cfgs(tmp_path, jax_dir, port_dir):
    common = {"model": TINY_V2, "prune": {"enable": True}, "ema": {"enable": True, "decay": 0.9},
              "data": {"dataset": "fake", "image_size": 16, "fake_eval_size": 10, "fake_num_classes": 4},
              "train": {"compute_dtype": "float32", "test_only": True, "eval_batch_size": 4}}
    jc = jax_config_from_dict({**common, "dist": {"num_devices": 1},
                               "train": {**common["train"], "pretrained": jax_dir,
                                         "log_dir": str(tmp_path / "jlog")}})
    pc = config_from_dict({**common, "train": {**common["train"], "pretrained": port_dir,
                                               "log_dir": str(tmp_path / "plog")}})
    return jc, pc


def test_test_only_on_both_packages_gives_one_eval_loss(tmp_path, monkeypatch):
    """``train.test_only`` with ``train.pretrained``: the JAX CLI on its
    checkpoint and the port's CLI on the carried one, over the same eval
    images (the JAX fake eval stream, fed to the port)."""
    jax_dir, port_dir, _, _, _ = _carry(tmp_path)
    jc, pc = _eval_cfgs(tmp_path, jax_dir, port_dir)
    batches = [{k: np.array(v) for k, v in b.items()}
               for b in jax_pipeline.as_numpy(jax_pipeline._fake_dataset(jc.data, 4, seed=0, train=False))]
    monkeypatch.setattr(pipeline.FakeImages, "eval_batches", lambda self, bs, rank=0, world=1: (
        {k: torch.from_numpy(v) for k, v in b.items()} for b in batches))
    theirs = jax_train_cli.run(jc)
    ours = train_cli.run(pc, device="cpu")
    assert ours["test_only"] is True and ours["step"] == 1 and ours["eval_n"] == theirs["n"] == 10
    assert ours["eval_top1"] == theirs["top1"]
    assert ours["eval_loss"] == pytest.approx(theirs["loss"], rel=1e-5)

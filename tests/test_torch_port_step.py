"""The port's train and eval steps (train/steps.py, train/guard.py) and its
training forward (models/specs.py) against the JAX package's, on the CPU.

Both packages start from one TrainState: the JAX package's, with weights
made by numpy from a seed, carried into the port by models/convert.py.
They then take the same batches. Forward values and the new BN state are
held to the repository's float32 bar (rtol 1e-4, atol 1e-5); one step and
the 20-step trajectory to tolerances measured once, written beside each
test with the measured number. Dropout and drop_path masks are injected
from the JAX side: the two frameworks' RNG streams differ.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.train import guard, optim, schedules, steps

RTOL, ATOL = 1e-4, 1e-5  # the repository's float32 forward bar
FIELDS = ("params", "state", "opt_state", "ema_params", "ema_state")

TINY_SPECS = [
    {"t": 2, "c": 8, "n": 1, "s": 2},
    {"t": 2, "c": 16, "n": 1, "s": 2, "k": [3, 5]},
    {"t": 2, "c": 16, "n": 1, "s": 1, "k": [3, 5], "se": 0.25, "act": "hswish"},
]


def _cfg_dict(bn_mode="exact", lr=0.01, **train):
    # tests/test_train.py's tiny config, with a third block (residual, SE,
    # two branches) and a smaller LR: at its 0.05 this 8-image toy run is
    # chaotic (tests/test_train.py says so), and float32 rounding differences
    # between any two programs grow to O(1) within 20 steps
    return {
        "model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0, "block_specs": TINY_SPECS},
        "optim": {"optimizer": "rmsprop", "weight_decay": 1e-5},
        "schedule": {"schedule": "constant", "base_lr": lr, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": True, "decay": 0.9, "warmup": False},
        "train": {"compute_dtype": "float32", "bn_mode": bn_mode, **train},
    }


def _numpy_params(jnet, seed):
    """Weights in the JAX layouts made by numpy from a seed, at the scale of
    the JAX package's init, with non-trivial BN affines."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))[0]

    def draw(path, s):
        key = "/".join(p.key for p in path)
        if len(s.shape) == 4:
            a = rng.normal(0, np.sqrt(2.0 / (s.shape[0] * s.shape[1] * s.shape[3])), s.shape)
        elif len(s.shape) == 2:
            a = rng.normal(0, 0.1 if "/se/" in key else 0.01, s.shape)
        elif key.endswith("gamma"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:
            a = rng.normal(0, 0.05, s.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _both(d, image_size=16, seed=0, batch=8):
    """(JAX pieces, port pieces) started from one TrainState."""
    jc, pc = jax_config_from_dict(d), config_from_dict(d)
    jnet, pnet = jax_get_model(jc.model, image_size=image_size), get_model(pc.model, image_size=image_size)
    jlr = jsched.make_lr_schedule(jc.schedule, batch, 1, 100)
    plr = schedules.make_lr_schedule(pc.schedule, batch, 1, 100)
    params = _numpy_params(jnet, seed)
    jopt = joptim.make_optimizer(jc.optim, jlr, params)
    jts = jsteps.init_train_state(jnet, jc, jopt, jax.random.PRNGKey(seed))
    jts = jts.replace(params=params, opt_state=jopt.init(params), ema_params=jax.tree.map(jnp.copy, params))
    pts = convert.train_state_from_jax(jts)
    popt = optim.make_optimizer(pc.optim, plr, pts.params)
    return (jc, jnet, jopt, jlr, jts), (pc, pnet, popt, plr, pts)


def _batches(n, batch=8, image_size=16, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.normal(0, 1, (batch, image_size, image_size, 3)).astype(np.float32),
             (np.arange(batch) % 4).astype(np.int32)) for _ in range(n)]


def _diffs(jts, pts) -> dict:
    """Max |JAX - port| / (1 + |JAX|) per TrainState field, in the JAX
    layouts: the absolute difference for values below 1, the relative one
    above (BN running variances reach 1e1)."""
    carried = convert.train_state_to_jax(pts, jts.opt_state)
    out = {}
    for field in FIELDS:
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, getattr(jts, field)))
        got = jax.tree_util.tree_leaves(carried[field])
        assert len(want) == len(got), field
        out[field] = max(float((np.abs(np.asarray(a) - np.asarray(b)) / (1.0 + np.abs(np.asarray(a)))).max())
                         for a, b in zip(want, got))
    return out


def _train(d, n_steps, batches=None):
    (jc, jnet, jopt, jlr, jts), (pc, pnet, popt, plr, pts) = _both(d)
    jstep = jax.jit(jsteps.make_train_step(jnet, jc, jopt, jlr))
    pstep = steps.make_train_step(pnet, pc, popt, plr)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for x, y in batches or _batches(n_steps):
        jts, jm = jstep(jts, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
        pts, pm = pstep(pts, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}, gen)
        losses.append((float(jm["loss"]), float(pm["loss"]), float(jm["grad_norm"]), float(pm["grad_norm"])))
    return jts, pts, np.asarray(losses), pm


@pytest.mark.parametrize("bn_mode", ["exact", "fused_vjp"])
def test_one_train_step_matches_jax(bn_mode):
    """One step: loss, grad norm, params, BN state, optimizer state, EMA.
    Measured max over the fields of |diff| / (1 + |JAX|): 4.2e-7 (exact,
    in the BN state) and 1.9e-7 (fused_vjp); the bar is 2e-6."""
    jts, pts, losses, metrics = _train(_cfg_dict(bn_mode), 1)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-6)
    np.testing.assert_allclose(losses[:, 3], losses[:, 2], rtol=1e-5)
    diffs = _diffs(jts, pts)
    assert max(diffs.values()) < 2e-6, diffs
    assert int(pts.step) == int(jts.step) == 1
    assert int(pts.opt_state["count"]) == 1
    assert set(metrics) == {"loss", "ce", "penalty", "top1", "lr", "grad_norm", "finite"}


@pytest.fixture
def one_torch_thread():
    """torch's CPU reductions split their sums over the intra-op threads, so
    their float32 rounding depends on the machine's core count; the exact
    BN mode's autodiff through the E[x^2] - E[x]^2 variance amplifies that
    over 20 steps (at 8 threads the losses drift 4.6e-3 from the JAX run's,
    at 1 thread 3.8e-6). The trajectory is compared with one thread, the
    order every machine reproduces."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("bn_mode", ["exact", "fused_vjp"])
def test_twenty_step_trajectory_matches_jax(bn_mode, one_torch_thread):
    """20 steps over two alternating batches, a task the net learns (the
    loss falls from 1.38 to 0.40): the losses and every field of the state.
    On 20 fresh batches of random labels the run is chaotic even at LR
    0.002: both packages' float32 rounding alone moves the params by 1e-3
    within 20 steps (measured 1.4e-3). Measured here, on one torch thread:
    losses within 5.6e-6 relative, and |diff| / (1 + |JAX|) at most 1.4e-6
    (exact) and 1.5e-6 (fused_vjp) over the fields; the bars are 1e-5 and
    5e-6."""
    jts, pts, losses, _ = _train(_cfg_dict(bn_mode), 20, batches=_batches(2) * 10)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    diffs = _diffs(jts, pts)
    assert max(diffs.values()) < 5e-6, diffs
    assert int(pts.step) == 20 and int(pts.opt_state["count"]) == 20


@pytest.mark.parametrize("policy,bn_mode", [("full", "exact"), ("save_conv", "exact"), ("save_conv", "fused_vjp")])
def test_remat_step_equals_plain_step(policy, bn_mode):
    """train.remat with either policy is a pure recompute trade: one step
    with it equals the plain step bit for bit on the CPU (the random draws
    are made before the checkpointed forward, so its recomputation reuses
    them)."""
    d_plain = _cfg_dict(bn_mode)
    d_remat = _cfg_dict(bn_mode, remat=True, remat_policy=policy)
    d_plain["model"]["dropout"] = d_remat["model"]["dropout"] = 0.2
    d_plain["model"]["drop_connect"] = d_remat["model"]["drop_connect"] = 0.3
    out = []
    for d in (d_plain, d_remat):
        _, (pc, pnet, popt, plr, pts) = _both(d)
        step = steps.make_train_step(pnet, pc, popt, plr)
        gen = torch.Generator().manual_seed(5)
        for x, y in _batches(2):
            pts, m = step(pts, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}, gen)
        out.append((pts, m))
    (a, ma), (b, mb) = out
    assert float(ma["loss"]) == float(mb["loss"])
    for field in FIELDS:
        fa, fb = convert.flatten_tree(getattr(a, field)), convert.flatten_tree(getattr(b, field))
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (field, k)


def test_remat_save_conv_keeps_the_conv_outputs():
    """The save_conv policy saves exactly the convolutions' and matmuls'
    outputs, and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    assert steps._save_conv_policy(None, torch.ops.aten.convolution.default) == CheckpointPolicy.MUST_SAVE
    assert steps._save_conv_policy(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert steps._save_conv_policy(None, torch.ops.aten.mul.Tensor) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat_policy"):
        _, (pc, pnet, popt, plr, _) = _both(_cfg_dict(remat=True, remat_policy="some"))
        steps.make_train_step(pnet, pc, popt, plr)


def test_step_validates_bn_mode_and_leaves_its_input_alone():
    _, (pc, pnet, popt, plr, pts) = _both(_cfg_dict())
    with pytest.raises(ValueError, match="bn_mode"):
        steps.make_train_step(pnet, config_from_dict(_cfg_dict("exactt")), popt, plr)
    with pytest.raises(ValueError, match="bn_mode"):
        steps.make_eval_step(pnet, config_from_dict(_cfg_dict("exactt")))
    before = {f: {k: v.clone() for k, v in convert.flatten_tree(getattr(pts, f)).items()} for f in FIELDS}
    x, y = _batches(1)[0]
    new, m = steps.make_train_step(pnet, pc, popt, plr)(pts, {"image": torch.from_numpy(x),
                                                             "label": torch.from_numpy(y)},
                                                        torch.Generator().manual_seed(0))
    for f in FIELDS:  # the step is functional: its input state is untouched
        for k, v in convert.flatten_tree(getattr(pts, f)).items():
            assert torch.equal(v, before[f][k]), (f, k)
    assert int(pts.step) == 0 and int(new.step) == 1
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 and not v.requires_grad for v in m.values())
    assert all(not v.requires_grad for v in convert.flatten_tree(new.params).values())


def test_guard_rejects_a_nonfinite_step_in_place_and_the_counter_advances():
    _, (pc, pnet, popt, plr, pts) = _both(_cfg_dict())
    step = guard.wrap_step_fn(steps.make_train_step(pnet, pc, popt, plr))
    gen = torch.Generator().manual_seed(0)
    (x, y), (x2, y2) = _batches(2)
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    new, m = step(pts, {"image": torch.from_numpy(bad), "label": torch.from_numpy(y)}, gen)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert int(new.step) == 1  # the bad batch is consumed
    for f in FIELDS:
        for k, v in convert.flatten_tree(getattr(pts, f)).items():
            assert torch.equal(convert.flatten_tree(getattr(new, f))[k], v), (f, k)
    assert int(new.opt_state["count"]) == 0
    good, m2 = step(new, {"image": torch.from_numpy(x2), "label": torch.from_numpy(y2)}, gen)
    assert float(m2["skipped"]) == 0.0 and int(good.step) == 2 and int(good.opt_state["count"]) == 1
    moved = [not torch.equal(a, b) for a, b in zip(convert.flatten_tree(good.params).values(),
                                                   convert.flatten_tree(new.params).values())]
    assert any(moved)


def test_step_guard_host_accounting(tmp_path):
    from yet_another_mobilenet_series_tpu_torch.config import GuardConfig

    g = guard.StepGuard(GuardConfig(enable=True, max_skipped_steps=2), str(tmp_path))
    for i, s in enumerate([0.0, 1.0, 0.0, 1.0], start=1):
        g.observe(i, {"skipped": torch.tensor(s)})
    g.check(4)
    assert g.skipped_total == 2 and g.skipped_steps == [2, 4]
    g.observe(5, {"skipped": torch.tensor(1.0)})
    with pytest.raises(guard.TrainHealthError, match="max_skipped_steps=2"):
        g.check(5)
    assert (tmp_path / guard.HEALTH_REPORT_NAME).exists()


def test_eval_step_counts_and_padding_match_jax():
    (jc, jnet, _, _, jts), (pc, pnet, _, _, pts) = _both(_cfg_dict())
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, (6, 16, 16, 3)).astype(np.float32)
    y = np.asarray([0, 1, 2, 3, -1, -1], np.int32)  # 2 padded rows
    want = jax.jit(jsteps.make_eval_step(jnet, jc))(jts.params, jts.state, {"image": jnp.asarray(x),
                                                                            "label": jnp.asarray(y)}, {})
    got = steps.make_eval_step(pnet, pc)(pts.params, pts.state, {"image": torch.from_numpy(x),
                                                                 "label": torch.from_numpy(y)}, {})
    assert float(got["n"]) == float(want["n"]) == 4.0
    assert float(got["top1"]) == float(want["top1"]) and float(got["top5"]) == float(want["top5"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=RTOL)


def test_training_forward_with_injected_dropout_and_drop_path_matches_jax():
    """Network.apply(train=True) with dropout 0.2 and a drop_connect ramp:
    the JAX package's masks (its per-block folded streams and the
    classifier's) injected into the port through ``noise``; logits and the
    new BN state at the float32 bar."""
    d = _cfg_dict("folded")
    d["model"].update(dropout=0.2, drop_connect=0.4)
    (jc, jnet, _, _, jts), (pc, pnet, _, _, pts) = _both(d)
    x = np.random.RandomState(4).normal(0, 1, (8, 16, 16, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want, want_s = jnet.apply(jts.params, jts.state, jnp.asarray(x), train=True, rng=rng, bn_mode="folded")
    noise = {"drop_path": {}}
    for i, blk in enumerate(jnet.blocks):
        if blk.drop_path > 0 and blk.has_residual:
            keep = jax.random.bernoulli(jax.random.fold_in(rng, i), 1.0 - blk.drop_path, (8, 1, 1, 1))
            noise["drop_path"][i] = torch.from_numpy(np.array(keep).reshape(-1))
    assert noise["drop_path"], "the tiny net has a residual block with a drop-path rate"
    feat = jnet.classifier.in_features
    noise["dropout"] = torch.from_numpy(np.array(jax.random.bernoulli(rng, 0.8, (8, feat))))
    got, got_s = pnet.apply(pts.params, pts.state, torch.from_numpy(x), train=True, noise=noise, bn_mode="folded")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want_flat = convert.flatten_tree(jax.tree.map(np.asarray, want_s))
    for k, v in convert.flatten_tree(got_s).items():
        np.testing.assert_allclose(v.detach().numpy(), want_flat[k], rtol=RTOL, atol=ATOL, err_msg=k)
    with pytest.raises(ValueError, match="generator"):
        pnet.apply(pts.params, pts.state, torch.from_numpy(x), train=True)
    drawn, _ = pnet.apply(pts.params, pts.state, torch.from_numpy(x), train=True,
                          generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()


def test_eval_forward_of_a_trained_state_matches_jax():
    """After two steps on both sides, the eval forward (train=False) of the
    port's state equals JAX's at the float32 bar."""
    jts, pts, _, _ = _train(_cfg_dict(), 2)
    jc, pc = jax_config_from_dict(_cfg_dict()), config_from_dict(_cfg_dict())
    jnet, pnet = jax_get_model(jc.model, image_size=16), get_model(pc.model, image_size=16)
    x = np.random.RandomState(8).normal(0, 1, (3, 16, 16, 3)).astype(np.float32)
    want, _ = jnet.apply(jts.ema_params, jts.ema_state, jnp.asarray(x), train=False)
    got = pnet.apply(pts.ema_params, pts.ema_state, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

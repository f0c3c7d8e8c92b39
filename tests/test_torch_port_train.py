"""The port's training mechanics (train/losses.py, schedules.py, optim.py,
ema.py, the batch mixer, utils/profiling.py) against the JAX package's, on
the CPU, mirroring tests/test_train.py and tests/test_models.py.

The optimizer is written by hand in the port; here it is held against
optax's chain, as the JAX package builds it, on the same gradients. Exact
formulas are held at float32 rounding (rtol 1e-6, or 1e-5 where optax's
rsqrt stands against the port's division by a sqrt).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import (EMAConfig as JEMAConfig, OptimConfig as JOptimConfig,
                                                     ScheduleConfig as JScheduleConfig, ModelConfig as JModelConfig)
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.zoo import ARCHS as JAX_ARCHS
from yet_another_mobilenet_series_tpu.train import ema as jema, losses as jlosses, optim as joptim
from yet_another_mobilenet_series_tpu.train import schedules as jsched
from yet_another_mobilenet_series_tpu.utils import profiling as jprof
from yet_another_mobilenet_series_tpu_torch.config import (EMAConfig, ModelConfig, OptimConfig, ScheduleConfig,
                                                           config_from_dict)
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.train import ema, losses, optim, schedules, steps
from yet_another_mobilenet_series_tpu_torch.utils import profiling


def test_label_smoothing_matches_jax_and_torch():
    logits = np.random.RandomState(0).normal(size=(8, 10)).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, 10, size=(8,))
    for eps in (0.1, 0.0):
        got = float(losses.cross_entropy_label_smooth(torch.from_numpy(logits), torch.from_numpy(labels), eps))
        want = float(jlosses.cross_entropy_label_smooth(jnp.asarray(logits), jnp.asarray(labels), eps))
        ref = float(torch.nn.functional.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                                      label_smoothing=eps))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_topk_correct_matches_jax():
    logits = np.random.RandomState(2).normal(size=(16, 7)).astype(np.float32)
    labels = np.random.RandomState(3).randint(0, 7, size=(16,)).astype(np.int32)
    got = losses.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), ks=(1, 3, 5))
    want = jlosses.topk_correct(jnp.asarray(logits), jnp.asarray(labels), ks=(1, 3, 5))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    with pytest.raises(ValueError, match="top-9"):
        losses.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), ks=(9,))


SCHEDULES = [
    dict(schedule="exp_decay", base_lr=0.1, scale_by_batch=False, warmup_epochs=2.0, decay_rate=0.9,
         decay_epochs=1.0),
    dict(schedule="exp_decay", base_lr=0.064, scale_by_batch=True, warmup_epochs=5.0, decay_rate=0.963,
         decay_epochs=3.0),
    dict(schedule="cosine", base_lr=0.2, scale_by_batch=False, warmup_epochs=0.0, final_lr_factor=0.0),
    dict(schedule="cosine", base_lr=0.2, scale_by_batch=True, warmup_epochs=1.5, final_lr_factor=0.1),
    dict(schedule="constant", base_lr=0.064, scale_by_batch=True, warmup_epochs=0.0),
    dict(schedule="constant", base_lr=0.05, scale_by_batch=False, warmup_epochs=0.5),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['schedule']}-{kw['warmup_epochs']}")
def test_lr_schedule_matches_jax(kw):
    args = dict(total_batch=1024, steps_per_epoch=10, total_epochs=12)
    got = schedules.make_lr_schedule(ScheduleConfig(**kw), **args)
    want = jsched.make_lr_schedule(JScheduleConfig(**kw), **args)
    for step in (0, 1, 5, 9, 10, 14, 15, 20, 29, 30, 31, 50, 75, 119, 120, 200):
        np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=1e-6, atol=1e-9, err_msg=str(step))
        # a tensor step (the optimizer's count) gives the same value
        assert float(got(torch.tensor(step, dtype=torch.int32))) == float(got(step))
    with pytest.raises(ValueError, match="schedule"):
        schedules.make_lr_schedule(ScheduleConfig(schedule="nope"), **args)


def test_lr_exp_decay_staircase_values():
    cfg = ScheduleConfig(schedule="exp_decay", base_lr=0.1, scale_by_batch=False, warmup_epochs=2.0,
                         decay_rate=0.9, decay_epochs=1.0)
    lr = schedules.make_lr_schedule(cfg, total_batch=256, steps_per_epoch=10, total_epochs=10)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 0.05, rtol=1e-6)
    np.testing.assert_allclose(float(lr(29)), 0.1, rtol=1e-6)
    np.testing.assert_allclose(float(lr(30)), 0.09, rtol=1e-6)
    np.testing.assert_allclose(float(lr(50)), 0.1 * 0.9 ** 3, rtol=1e-6)


@pytest.mark.parametrize("arch", ["mobilenet_v3_large", "atomnas_supernet_se", "efficientnet_b0"])
@pytest.mark.parametrize("flags", [(True, True, False), (True, True, True), (False, False, False)])
def test_wd_mask_matches_jax(arch, flags):
    bn, bias, dw = flags
    kw = dict(wd_skip_bn=bn, wd_skip_bias=bias, wd_skip_depthwise=dw)
    pnet = get_model(ModelConfig(arch=arch, width_mult=0.5, num_classes=10), image_size=32)
    jnet = jax_get_model(JModelConfig(arch=arch, width_mult=0.5, num_classes=10), image_size=32)
    params, _ = pnet.init(torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))[0]
    got = convert.flatten_tree(optim.wd_mask(params, OptimConfig(**kw)))
    want = {"/".join(p.key for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(joptim.wd_mask(jparams, JOptimConfig(**kw)))[0]}
    assert got == want
    assert any(got.values()) and not all(got.values()) or not (bn or bias or dw)


def test_clip_by_global_norm_matches_optax():
    rs = np.random.RandomState(0)
    grads = {"a": rs.normal(0, 1, (3, 4)).astype(np.float32), "b": rs.normal(0, 2, (5,)).astype(np.float32)}
    for max_norm in (0.5, 1e3):
        tx = joptim.clip_by_global_norm(max_norm)
        want, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(None))
        got = optim.clip_by_global_norm([torch.from_numpy(grads["a"]), torch.from_numpy(grads["b"])], max_norm)
        for t, k in zip(got, ("a", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    norm = float(optim.global_norm([torch.from_numpy(v) for v in grads.values()]))
    np.testing.assert_allclose(norm, np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in grads.values())),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup", [False, True])
def test_ema_update_matches_jax(warmup):
    rs = np.random.RandomState(1)
    shadow = {"w": rs.normal(size=(3, 2)).astype(np.float32), "s": {"m": rs.normal(size=(4,)).astype(np.float32)}}
    value = {"w": rs.normal(size=(3, 2)).astype(np.float32), "s": {"m": rs.normal(size=(4,)).astype(np.float32)}}
    for step in (0, 7, 1000):
        want = jema.ema_update(JEMAConfig(decay=0.9999, warmup=warmup), jax.tree.map(jnp.asarray, shadow),
                               jax.tree.map(jnp.asarray, value), step)
        tshadow = convert.unflatten_tree({k: torch.from_numpy(v) for k, v in convert.flatten_tree(shadow).items()})
        tvalue = convert.unflatten_tree({k: torch.from_numpy(v) for k, v in convert.flatten_tree(value).items()})
        got = ema.ema_update(EMAConfig(decay=0.9999, warmup=warmup), tshadow, tvalue, torch.tensor(step))
        for k, v in convert.flatten_tree(got).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(convert.flatten_tree(want)[k]), rtol=1e-6, atol=1e-7)
            assert v.data_ptr() != convert.flatten_tree(tvalue)[k].data_ptr()  # never an alias
    off = ema.ema_update(EMAConfig(enable=False), tshadow, tvalue, 0)
    assert off is tshadow


def test_ema_warmup_value():
    out = ema.ema_update(EMAConfig(enable=True, decay=0.9999, warmup=True), {"w": torch.tensor(1.0)},
                         {"w": torch.tensor(3.0)}, 0)
    np.testing.assert_allclose(float(out["w"]), 0.1 * 1 + 0.9 * 3, rtol=1e-6)


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"stem": {"conv": {"w": rs.normal(0, 0.5, (3, 3, 3, 8)).astype(np.float32)},
                     "bn": {"gamma": rs.uniform(0.5, 1.5, 8).astype(np.float32),
                            "beta": rs.normal(0, 0.1, 8).astype(np.float32)}},
            "blocks": {"0": {"dw0_k3": {"w": rs.normal(0, 0.5, (3, 3, 1, 8)).astype(np.float32)}}},
            "classifier": {"w": rs.normal(0, 0.1, (8, 4)).astype(np.float32),
                           "b": rs.normal(0, 0.1, 4).astype(np.float32)}}


def _run_both(cfg_kw, lrs, n_steps=4, seed=0):
    """n_steps of the port's optimizer and the JAX package's optax chain on
    the same JAX-layout gradients; returns both params and states."""
    params = _params(seed)
    rs = np.random.RandomState(seed + 10)
    grads = [jax.tree.map(lambda a: rs.normal(0, 1, a.shape).astype(np.float32), params) for _ in range(n_steps)]
    lr_table = np.asarray(lrs, np.float32)
    jtx = joptim.make_optimizer(JOptimConfig(**cfg_kw), lambda s: jnp.asarray(lr_table)[s], params)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jtx.init(jp)
    ptx = optim.make_optimizer(OptimConfig(**cfg_kw), lambda s: torch.from_numpy(lr_table)[s], convert.from_jax(
        convert.flatten_tree(params)))
    pp = convert.from_jax(convert.flatten_tree(params))
    pst = ptx.init(pp)
    for g in grads:
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        pupd, pst = ptx.update(convert.from_jax(convert.flatten_tree(g)), pst, pp)
        pp = optim.apply_updates(pp, pupd)
    return jp, jst, pp, pst


OPTIMIZERS = [
    dict(optimizer="rmsprop", momentum=0.9, rmsprop_decay=0.9, rmsprop_eps=0.002, weight_decay=1e-5),
    dict(optimizer="rmsprop", momentum=0.9, rmsprop_decay=0.9, rmsprop_eps=0.002, weight_decay=1e-5,
         rmsprop_tf_momentum_order=False),
    dict(optimizer="rmsprop", momentum=0.0, rmsprop_decay=0.9, rmsprop_eps=0.01, weight_decay=0.0),
    dict(optimizer="rmsprop", momentum=0.9, weight_decay=4e-5, grad_clip_norm=1.0, wd_skip_depthwise=True),
    dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4),
    dict(optimizer="sgd", momentum=0.0, weight_decay=0.0),
    dict(optimizer="adamw", weight_decay=1e-4),
]


@pytest.mark.parametrize("cfg_kw", OPTIMIZERS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_optimizer_matches_optax_across_an_lr_boundary(cfg_kw):
    """Four steps with the LR falling 0.1 -> 0.01 at step 2 (where the TF
    and torch momentum orders part): params and every buffer of the state,
    with the optimizer's own count, against optax's chain."""
    jp, jst, pp, pst = _run_both(cfg_kw, [0.1, 0.1, 0.01, 0.01])
    got = convert.to_jax(pp)
    for k, v in convert.flatten_tree(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    carried = convert.opt_state_from_jax(jst)
    assert set(carried) == set(pst)
    assert int(carried["count"]) == int(pst["count"]) == 4
    for name in set(pst) - {"count"}:
        a, b = convert.to_jax(pst[name]), convert.to_jax(carried[name])
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=f"{name}/{k}")


def test_rmsprop_tf_semantics_one_step_by_hand():
    cfg = OptimConfig(optimizer="rmsprop", momentum=0.9, rmsprop_decay=0.9, rmsprop_eps=0.01, weight_decay=0.0)
    params = {"w": torch.tensor(2.0)}
    opt = optim.make_optimizer(cfg, lambda s: torch.tensor(0.1), params)
    upd, st = opt.update({"w": torch.tensor(0.5)}, opt.init(params), params)
    nu = 0.9 * 1.0 + 0.1 * 0.5 ** 2
    np.testing.assert_allclose(float(upd["w"]), -0.1 * 0.5 / np.sqrt(nu + 0.01), rtol=1e-6)
    np.testing.assert_allclose(float(st["nu"]["w"]), nu, rtol=1e-6)
    assert int(st["count"]) == 1


def test_momentum_orders_differ_only_after_an_lr_change():
    tf = _run_both(OPTIMIZERS[0], [0.1, 0.1, 0.01, 0.01])[2]
    torch_order = _run_both(OPTIMIZERS[1], [0.1, 0.1, 0.01, 0.01])[2]
    diff = max(float((a - b).abs().max()) for a, b in zip(convert.flatten_tree(tf).values(),
                                                           convert.flatten_tree(torch_order).values()))
    assert diff > 1e-4
    tf = _run_both(OPTIMIZERS[0], [0.1] * 3, n_steps=3)[2]
    torch_order = _run_both(OPTIMIZERS[1], [0.1] * 3, n_steps=3)[2]
    for a, b in zip(convert.flatten_tree(tf).values(), convert.flatten_tree(torch_order).values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_weight_decay_is_coupled_and_masked():
    cfg = OptimConfig(optimizer="sgd", momentum=0.0, weight_decay=0.1)
    params = {"conv": {"w": torch.tensor([2.0])}, "bn": {"gamma": torch.tensor([2.0])}}
    opt = optim.make_optimizer(cfg, lambda s: torch.tensor(1.0), params)
    upd, _ = opt.update({"conv": {"w": torch.zeros(1)}, "bn": {"gamma": torch.zeros(1)}}, opt.init(params), params)
    np.testing.assert_allclose(float(upd["conv"]["w"]), -0.2, rtol=1e-6)
    assert float(upd["bn"]["gamma"]) == 0.0
    with pytest.raises(ValueError, match="optimizer"):
        optim.make_optimizer(OptimConfig(optimizer="lamb"), lambda s: 0.1, params)


def _mix_cfg(**optim_kw):
    return config_from_dict({"optim": optim_kw})


def test_batch_mixer_semantics():
    """Mixup is the exact convex combination; CutMix pastes a box from the
    permuted batch whose clipped area defines lam; both are deterministic
    per generator state (tests/test_train.py's contract)."""
    assert steps.make_batch_mixer(_mix_cfg()) is None
    with pytest.raises(ValueError, match="alphas"):
        steps.make_batch_mixer(_mix_cfg(mixup_alpha=-1.0))
    mix = steps.make_batch_mixer(_mix_cfg(mixup_alpha=0.4))
    x = torch.randn((16, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    y = torch.arange(16) % 4
    xm, yb, lam = mix(torch.Generator().manual_seed(1), x, y)
    xm2, _, lam2 = mix(torch.Generator().manual_seed(1), x, y)
    assert torch.equal(xm, xm2) and float(lam) == float(lam2) and 0.0 <= float(lam) <= 1.0
    np.testing.assert_allclose(xm.mean(0).numpy(), x.mean(0).numpy(), atol=1e-5)

    mix = steps.make_batch_mixer(_mix_cfg(cutmix_alpha=1.0))
    yc = torch.arange(16)
    xc = torch.arange(16, dtype=torch.float32)[:, None, None, None].expand(16, 8, 8, 3).contiguous()
    found = False
    for k in range(6):
        xm, yb, lam = mix(torch.Generator().manual_seed(k), xc, yc)
        vals = xm[..., 0]
        for i in range(16):
            own = vals[i] == float(i)
            pasted = vals[i] == float(yb[i])
            assert bool((own | pasted).all())  # every pixel is its own or its partner's
            if int(yb[i]) != i:
                np.testing.assert_allclose(float(own.float().mean()), float(lam), atol=1e-6)
                found = found or 0.0 < float(lam) < 1.0
    assert found

    both = steps.make_batch_mixer(_mix_cfg(mixup_alpha=0.4, cutmix_alpha=1.0))
    assert both(torch.Generator().manual_seed(3), x, y)[0].shape == x.shape


# ---------------------------------------------------------------------------
# the MAC/param profiler
# ---------------------------------------------------------------------------

# tests/test_models.py's golden counts: (params, MACs, relative tolerance)
GOLDEN = {
    "mobilenet_v1": (4.23e6, 569e6, 0.01),
    "mobilenet_v2": (3.50e6, 300e6, 0.01),
    "mobilenet_v3_large": (5.48e6, 217e6, 0.01),
    "mobilenet_v3_small": (2.54e6, 56e6, 0.02),
    "mnasnet_a1": (3.9e6, 312e6, 0.01),
    # beyond reference parity (arXiv:1905.11946). Paper MACs "0.39B" rounds
    # up from ~386M (torchvision/thop measure 386M); lite0's widely-quoted
    # 407M uses a different counting — structurally it is B0 minus SE, so
    # its multiply-adds sit just under B0's.
    "efficientnet_b0": (5.29e6, 386e6, 0.01),
    "efficientnet_lite0": (4.65e6, 385e6, 0.01),
}


@pytest.mark.parametrize("arch", sorted(GOLDEN))
def test_profiler_golden_counts(arch):
    params_ref, macs_ref, tol = GOLDEN[arch]
    prof = profiling.profile_network(get_model(ModelConfig(arch=arch)))
    assert abs(prof.total_params - params_ref) / params_ref < tol, prof.total_params
    assert abs(prof.total_macs - macs_ref) / macs_ref < tol, prof.total_macs


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_profiler_equals_jax_for_every_arch(arch):
    pnet = get_model(ModelConfig(arch=arch))
    jnet = jax_get_model(JModelConfig(arch=arch))
    got, want = profiling.profile_network(pnet), jprof.profile_network(jnet)
    assert [dataclasses.astuple(layer) for layer in got.layers] == \
        [dataclasses.astuple(layer) for layer in want.layers]
    assert got.atom_costs.keys() == want.atom_costs.keys()
    for i in got.atom_costs:
        np.testing.assert_array_equal(got.atom_costs[i], want.atom_costs[i])
    masks = {i: (np.arange(len(c)) % 3 > 0).astype(np.float32) for i, c in got.atom_costs.items()}
    assert profiling.masked_macs(pnet, masks) == jprof.masked_macs(jnet, masks)
    assert profiling.masked_macs(pnet, masks, 160) == jprof.masked_macs(jnet, masks, 160)

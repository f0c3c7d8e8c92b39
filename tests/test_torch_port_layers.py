"""Train-mode layers and blocks of the port (ops/layers.py, ops/blocks.py)
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both. The bars are the
repository's float32 forward bar (rtol 1e-4, atol 1e-5) for outputs and new
BN state, and the JAX package's own bars where it compares its modes with
each other (tests/test_ops.py). Gradients are held at rtol 1e-4 (atol 1e-5, or
3e-5 for a whole block's): the largest difference measured against JAX's
is given beside each check. Random draws (drop_path) are injected from the JAX side, since the
two frameworks' RNG streams differ.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu import ops as jops
from yet_another_mobilenet_series_tpu.ops import blocks as jblocks
from yet_another_mobilenet_series_tpu_torch.ops import blocks, layers

RTOL, ATOL = 1e-4, 1e-5  # the repository's float32 forward bar

MODES = layers.BN_MODES


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's layout: NCHW shape, channels_last memory."""
    return torch.from_numpy(np.array(x_nhwc, dtype=np.float32, order="C")).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _bn_inputs(c=12, seed=0, shape=(8, 7, 7)):
    rs = np.random.RandomState(seed)
    gamma = rs.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rs.uniform(-0.5, 0.5, c).astype(np.float32)
    mean = rs.normal(0, 0.5, c).astype(np.float32)
    var = rs.uniform(0.5, 2.0, c).astype(np.float32)
    x = rs.normal(2.0, 3.0, (*shape, c)).astype(np.float32)
    return gamma, beta, mean, var, x


def _jax_bn(c, gamma, beta, mean, var):
    spec = jops.BatchNorm(c)
    return spec, {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}, {"mean": jnp.asarray(mean),
                                                                           "var": jnp.asarray(var)}


def _port_bn(c, gamma, beta, mean, var):
    spec = layers.BatchNorm(c)
    return spec, {"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)}, \
        {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_modes_match_jax(mode, train):
    c = 12
    gamma, beta, mean, var, x = _bn_inputs(c)
    jspec, jp, js = _jax_bn(c, gamma, beta, mean, var)
    pspec, pp, ps = _port_bn(c, gamma, beta, mean, var)
    want_y, want_s = jspec.apply(jp, js, jnp.asarray(x), train=train, mode=mode)
    got = pspec.apply(pp, ps, _nchw(x), train=train, mode=mode)
    got_y, got_s = got if train else (got, ps)
    np.testing.assert_allclose(_nhwc(got_y), np.asarray(want_y), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].detach().numpy(), np.asarray(want_s[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_batchnorm_modes_bf16_match_jax(mode):
    """bf16 activations (the training dtype): the statistics accumulate in
    float32 on both sides and agree at the float32 bar; the outputs agree
    within one bf16 ulp (2**-7 relative; measured max 9.8e-4 absolute over
    the six modes)."""
    c = 12
    gamma, beta, mean, var, x = _bn_inputs(c, seed=4)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # exact in bf16
    jspec, jp, js = _jax_bn(c, gamma, beta, mean, var)
    pspec, pp, ps = _port_bn(c, gamma, beta, mean, var)
    want_y, want_s = jspec.apply(jp, js, jnp.asarray(x).astype(jnp.bfloat16), train=True, mode=mode)
    got_y, got_s = pspec.apply(pp, ps, _nchw(x).bfloat16(), train=True, mode=mode)
    assert got_y.dtype == torch.bfloat16
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), rtol=RTOL, atol=ATOL)
    want = np.asarray(want_y.astype(jnp.float32))
    np.testing.assert_allclose(_nhwc(got_y), want, rtol=2.0 ** -7, atol=2.0 ** -7 * np.abs(want).max())


def test_batchnorm_train_matches_torch_batchnorm2d():
    """The port's own yardstick too: torch.nn.BatchNorm2d in train mode
    (biased variance to normalize, momentum 0.1 and the unbiased variance
    for the running stats)."""
    c = 6
    gamma, beta, _, _, x = _bn_inputs(c, seed=2, shape=(4, 5, 5))
    pspec, pp, ps = _port_bn(c, gamma, beta, np.zeros(c, np.float32), np.ones(c, np.float32))
    y, st = pspec.apply(pp, ps, _nchw(x), train=True)
    bn = torch.nn.BatchNorm2d(c, momentum=0.1, eps=1e-5)
    bn.weight.data, bn.bias.data = torch.from_numpy(gamma), torch.from_numpy(beta)
    want = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st["mean"].numpy(), bn.running_mean.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st["var"].numpy(), bn.running_var.numpy(), rtol=1e-5, atol=1e-6)


def _grads_port(mode, gamma, beta, mean, var, x, w):
    c = gamma.shape[0]
    spec, pp, ps = _port_bn(c, gamma, beta, mean, var)
    pp = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    xt = _nchw(x).clone().requires_grad_(True)
    y, _ = spec.apply(pp, ps, xt, train=True, mode=mode)
    (y * _nchw(w)).sum().backward()
    return {"gamma": pp["gamma"].grad.numpy(), "beta": pp["beta"].grad.numpy(), "x": _nhwc(xt.grad)}


@pytest.mark.parametrize("mode", MODES)
def test_batchnorm_grads_match_jax(mode):
    """Gradients of every mode against JAX autodiff of the same mode (the
    closed-form backward of fused_vjp against JAX's fused_vjp); measured
    max |diff| over the six modes 4.2e-7 for x, 1.7e-5 for gamma and 1.3e-5
    for beta (sums over 392 terms), inside rtol 1e-4 of their values."""
    c = 12
    gamma, beta, mean, var, x = _bn_inputs(c, seed=3)
    w = np.random.RandomState(5).normal(0, 1, x.shape).astype(np.float32)
    jspec, jp, js = _jax_bn(c, gamma, beta, mean, var)

    def loss(p, xx):
        y, _ = jspec.apply(p, js, xx, train=True, mode=mode)
        return jnp.sum(y * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    got = _grads_port(mode, gamma, beta, mean, var, x, w)
    np.testing.assert_allclose(got["x"], np.asarray(gx), rtol=RTOL, atol=ATOL)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(got[k], np.asarray(gp[k]), rtol=RTOL, atol=ATOL)


def test_fused_vjp_equals_folded_and_autodiff():
    """Within the port (tests/test_ops.py's contract): fused_vjp's forward
    equals "folded" bit for bit, its running stats equal, and its
    closed-form gradients equal autodiff through "exact"."""
    c = 12
    gamma, beta, mean, var, x = _bn_inputs(c, seed=3)
    w = np.random.RandomState(5).normal(0, 1, x.shape).astype(np.float32)
    spec, pp, ps = _port_bn(c, gamma, beta, mean, var)
    y_f, s_f = spec.apply(pp, ps, _nchw(x), train=True, mode="folded")
    y_v, s_v = spec.apply(pp, ps, _nchw(x), train=True, mode="fused_vjp")
    assert torch.equal(y_f, y_v)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s_v[k].detach().numpy(), s_f[k].detach().numpy(), rtol=1e-6)
    fused = _grads_port("fused_vjp", gamma, beta, mean, var, x, w)
    exact = _grads_port("exact", gamma, beta, mean, var, x, w)
    for k in fused:
        np.testing.assert_allclose(fused[k], exact[k], rtol=RTOL, atol=ATOL)


def test_fused_vjp_rejects_stat_cotangents():
    """A loss that differentiates the batch statistics fails loudly under
    fused_vjp (the closed form discards those cotangents by contract) and
    works under an autodiff mode."""
    spec = layers.BatchNorm(4)
    params, state = spec.init()
    x = _nchw(np.random.RandomState(0).normal(0, 1, (2, 3, 3, 4)).astype(np.float32))
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    _, st = spec.apply(p, state, x, train=True, mode="fused_vjp")
    with pytest.raises(TypeError, match="fused_vjp.*cotangents"):
        st["mean"].sum().backward()
    # the batch statistics depend on x alone: differentiate through x
    xg = x.clone().requires_grad_(True)
    _, st = spec.apply(params, state, xg, train=True, mode="folded")
    st["mean"].sum().backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().max() > 0


def test_batchnorm_rejects_unknown_mode():
    spec = layers.BatchNorm(3)
    params, state = spec.init()
    with pytest.raises(ValueError, match="bn mode"):
        spec.apply(params, state, torch.zeros(1, 3, 2, 2), train=True, mode="nope")


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_as_dot_equals_conv_and_jax(stride):
    """1x1 conv as a matmul (stride as a subsample) equals the convolution
    lowering and the JAX package's as_dot; values and weight gradients."""
    rs = np.random.RandomState(stride)
    spec, jspec = layers.Conv2D(8, 16, 1, stride), jops.Conv2D(8, 16, 1, stride)
    w = rs.normal(0, 0.3, (1, 1, 8, 16)).astype(np.float32)  # HWIO
    x = rs.normal(0, 1, (2, 7, 7, 8)).astype(np.float32)
    pw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    outs = {}
    for as_dot in (False, True):
        wt = pw.clone().requires_grad_(True)
        y = spec.apply({"w": wt}, _nchw(x), as_dot=as_dot)
        (y * y).sum().backward()
        outs[as_dot] = (_nhwc(y), wt.grad.numpy())
    want = np.asarray(jspec.apply({"w": jnp.asarray(w)}, jnp.asarray(x), as_dot=True))
    np.testing.assert_allclose(outs[True][0], outs[False][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[True][1], outs[False][1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[True][0], want, rtol=RTOL, atol=ATOL)
    # a depthwise conv ignores the flag
    dw = layers.Conv2D(8, 8, 3, 1, groups=8)
    pdw = dw.init(torch.Generator().manual_seed(0))
    assert torch.equal(dw.apply(pdw, _nchw(x), as_dot=True), dw.apply(pdw, _nchw(x)))


def test_dropout_with_an_injected_mask_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.normal(0, 1, (4, 10)).astype(np.float32)
    keep = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(3), 0.8, x.shape))
    want = np.asarray(jnp.where(keep, jnp.asarray(x) / 0.8, 0.0))
    got = layers.dropout(torch.from_numpy(x), 0.2, True, keep=torch.from_numpy(np.array(keep)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert layers.dropout(torch.from_numpy(x), 0.2, False) is not None
    assert torch.equal(layers.dropout(torch.from_numpy(x), 0.0, True), torch.from_numpy(x))
    drawn = layers.dropout(torch.ones(1000), 0.5, True, generator=torch.Generator().manual_seed(0))
    assert set(drawn.unique().tolist()) == {0.0, 2.0}


# ---------------------------------------------------------------------------
# blocks in train mode
# ---------------------------------------------------------------------------


def _tree_from_jax(tree):
    from yet_another_mobilenet_series_tpu_torch.models import convert

    return convert.from_jax({k: np.asarray(v) for k, v in convert.flatten_tree(tree).items()})


def _rand_params(jtree, seed):
    """numpy values in the JAX layout for every leaf of a JAX init tree,
    with non-trivial BN affines."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "gamma":
            return jnp.asarray(rs.uniform(0.5, 1.5, shape).astype(np.float32))
        if name in ("beta", "b"):
            return jnp.asarray(rs.normal(0, 0.1, shape).astype(np.float32))
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return jnp.asarray(rs.normal(0, 1.0 / np.sqrt(fan), shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, jtree)


@pytest.mark.parametrize("mode", ["exact", "fused_vjp", "compute_sdot"])
@pytest.mark.parametrize("conv1x1_dot", [False, True])
def test_conv_bn_act_train_matches_jax(mode, conv1x1_dot):
    jspec = jblocks.ConvBNAct(8, 16, 1, 1, active_fn="hswish")
    pspec = blocks.ConvBNAct(8, 16, 1, 1, active_fn="hswish")
    jp, js = jspec.init(jax.random.PRNGKey(0))
    jp = _rand_params(jp, 1)
    x = np.random.RandomState(2).normal(0, 1, (3, 6, 6, 8)).astype(np.float32)
    want, want_s = jspec.apply(jp, js, jnp.asarray(x), train=True, bn_mode=mode, conv1x1_dot=conv1x1_dot)
    got, got_s = pspec.apply(_tree_from_jax(jp), _tree_from_jax(js), _nchw(x), train=True, bn_mode=mode,
                             conv1x1_dot=conv1x1_dot)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s["bn"][k].detach().numpy(), np.asarray(want_s["bn"][k]), rtol=RTOL,
                                   atol=ATOL)


ATOM_BLOCK = dict(in_channels=16, out_channels=16, expanded_channels=48, stride=1, kernel_sizes=(3, 5, 7),
                  group_channels=(16, 16, 16), active_fn="hswish", se_channels=8, drop_path=0.25)


def _block_case(mask_kind, seed=0):
    jspec, pspec = jblocks.InvertedResidual(**ATOM_BLOCK), blocks.InvertedResidual(**ATOM_BLOCK)
    jp, js = jspec.init(jax.random.PRNGKey(seed))
    jp = _rand_params(jp, seed + 1)
    x = np.random.RandomState(seed + 2).normal(0, 1, (4, 8, 8, 16)).astype(np.float32)
    mask = None
    if mask_kind == "some":
        mask = np.ones(48, np.float32)
        mask[::3] = 0.0
    elif mask_kind == "dead":
        mask = np.zeros(48, np.float32)
    return jspec, pspec, jp, js, x, mask


@pytest.mark.parametrize("mask_kind", [None, "some", "dead"])
@pytest.mark.parametrize("mode", ["exact", "fused_vjp"])
def test_inverted_residual_train_matches_jax(mask_kind, mode):
    """An AtomNAS block (three kernel-size branches, SE, a residual) in
    train mode with an injected drop_path draw: outputs, new BN state and
    the gradients of every parameter against JAX's. A fully masked block
    equals the identity (the any_alive gate). The gradients (sums over the
    batch, some of magnitude 1e2) measured within 7.6e-5 absolute of JAX's,
    inside the bar of rtol 1e-4 plus atol 3e-5."""
    jspec, pspec, jp, js, x, mask = _block_case(mask_kind)
    rng = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(rng, 1.0 - ATOM_BLOCK["drop_path"], (4, 1, 1, 1)))
    w = np.random.RandomState(9).normal(0, 1, (4, 8, 8, 16)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p):
        y, st = jspec.apply(p, js, jnp.asarray(x), train=True, mask=jmask, bn_mode=mode, rng=rng)
        return jnp.sum(y * w), (y, st)

    (_, (want, want_s)), want_g = jax.value_and_grad(loss, has_aux=True)(jp)
    from yet_another_mobilenet_series_tpu_torch.models import convert

    flat = convert.flatten_tree(_tree_from_jax(jp))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    got, got_s = pspec.apply(convert.unflatten_tree(leaves), _tree_from_jax(js), _nchw(x), train=True,
                             mask=None if mask is None else torch.from_numpy(mask), bn_mode=mode,
                             keep=torch.from_numpy(np.array(keep).reshape(-1)))
    (got * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    if mask_kind == "dead":
        np.testing.assert_array_equal(_nhwc(got), x)
    for k, v in convert.flatten_tree(want_s).items():
        np.testing.assert_allclose(convert.flatten_tree(got_s)[k].detach().numpy(), np.asarray(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want_flat = convert.to_jax(convert.from_jax({k: np.asarray(v) for k, v in
                                                 convert.flatten_tree(want_g).items()}))
    got_flat = convert.to_jax(convert.unflatten_tree({k: (t.grad if t.grad is not None else torch.zeros_like(t))
                                                      for k, t in leaves.items()}))
    for k in want_flat:
        np.testing.assert_allclose(got_flat[k], want_flat[k], rtol=RTOL, atol=3e-5, err_msg=k)


def test_inverted_residual_drop_path_zeroes_dropped_samples():
    """Samples whose keep draw is 0 carry only the residual; kept samples
    are the branch scaled by 1/keep_prob plus the residual."""
    _, pspec, jp, js, x, _ = _block_case(None, seed=3)
    params, state = _tree_from_jax(jp), _tree_from_jax(js)
    keep = torch.tensor([1.0, 0.0, 1.0, 0.0])
    y_drop, _ = pspec.apply(params, state, _nchw(x), train=True, keep=keep)
    y_all, _ = pspec.apply(params, state, _nchw(x), train=True, keep=torch.ones(4))
    y_none, _ = pspec.apply(params, state, _nchw(x), train=True)
    np.testing.assert_array_equal(_nhwc(y_drop)[[1, 3]], x[[1, 3]])
    np.testing.assert_allclose(_nhwc(y_drop)[[0, 2]], _nhwc(y_all)[[0, 2]], rtol=1e-6, atol=1e-6)
    branch = _nhwc(y_all) - x
    np.testing.assert_allclose(branch, (_nhwc(y_none) - x) / 0.75, rtol=1e-5, atol=1e-5)


def test_block_eval_form_is_unchanged_by_train_kwargs():
    """train=False returns the output alone, as the serving path expects."""
    _, pspec, jp, js, x, _ = _block_case(None, seed=5)
    y = pspec.apply(_tree_from_jax(jp), _tree_from_jax(js), _nchw(x))
    assert isinstance(y, torch.Tensor) and y.shape == (4, 16, 8, 8)

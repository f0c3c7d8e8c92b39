"""The five families of tests/test_torch_port_families.py in training, on
the CPU, against the JAX package: the training forward (batch statistics,
new BN state) and the gradients of every parameter, layer by layer.

From one set of numpy-made weights at each family's published width, 64 px,
batch 2, ``bn_mode="exact"``: the stem, each block and the head on the JAX
forward's input to that layer, then the pooled classifier, in each package;
each layer's output and new BN state at the float32 bar (rtol 1e-4, atol
1e-5), its gradients (every parameter's and its input's, under a seeded
cotangent) at rtol 1e-4 with an atol of 1e-4 of the tensor's largest
|element| (each element is a sum over the batch and the pixels). Layer by
layer, because a whole net's float32 training forward at batch 2 carries
each package's rounding through the batch statistics of every BN: the
logits of the two packages part by more than the bar at this size, by as
much as the JAX package's own float32 logits part from a float64 forward,
and more than the port's do (F14, ROADMAP queue 3;
scripts/train_forward_drift.py). Dropout and drop_connect are 0 (the two packages' random
streams differ), except in EfficientNet-B0's, which runs its recipe's
drop_connect and dropout with the JAX package's draws injected into the
port through ``noise``. The SE search and F3 are tests/test_torch_port_families_search.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu_torch.models import convert

from test_torch_port_families import FAMILIES, family_nets, images
from test_torch_port_models import _jax_tree, _jax_weights_with_seeded_stats

RTOL, ATOL = 1e-4, 1e-5  # the repository's float32 bar
GRAD_ATOL_SHARE = 1e-4  # a gradient's atol, as a share of its tensor's largest |element|

# ---------------------------------------------------------------------------
# the training forward and the gradients
# ---------------------------------------------------------------------------


def _sub(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _close_grad(got, want, what) -> float:
    """A gradient at rtol 1e-4, its atol 1e-4 of the tensor's largest
    |element| (each element is a sum over the batch and the pixels, whose
    float32 rounding follows the size of its terms, not of the sum); returns
    the largest |difference| over that largest |element|."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=GRAD_ATOL_SHARE * scale, err_msg=what)
    return float(np.abs(got - want).max()) / max(scale, 1e-30)


def _jax_layers(layers, checked, rng):
    """One compiled program of the JAX package's layers: each layer's
    training forward from the previous layer's output and, for the
    ``checked`` ones, its VJP under its cotangent; per checked layer (input,
    output, new state, gradient of the params, gradient of the input)."""
    def run(params, state, x, cts):
        h, out, cts = x, [], iter(cts)
        for (name, layer, _), check in zip(layers, checked):
            kw = {}
            if rng is not None and name.startswith("blocks/") and layer.drop_path > 0:
                kw["rng"] = jax.random.fold_in(rng, int(name.split("/")[1]))

            def apply(p, a, layer=layer, s=_sub(state, name), kw=kw):
                return layer.apply(p, s, a, train=True, bn_mode="exact", **kw)

            if not check:
                h = apply(_sub(params, name), h)[0]
                continue
            y, vjp, new_state = jax.vjp(apply, _sub(params, name), h, has_aux=True)
            out.append((h, y, new_state, *vjp(next(cts))))
            h = y
        return out, h

    return jax.jit(run)


def _layer_parity(jnet, pnet, params, state, x, seed, rng=None, noise=None) -> dict:
    """Every layer of the training forward, one at a time, in each package:
    the stem, each block (its expand, depthwise branches, SE, project and
    residual) and the head on the JAX forward's input to that layer, then the
    pooled classifier; each layer's output and new BN state, and its VJP
    under a seeded cotangent (the gradient of every parameter and of its
    input) held at the float32 bar. The JAX package's per-block drop_connect
    draws (``rng``) and classifier dropout reach the port through ``noise``.
    Returns the largest |difference| of each kind."""
    jp, js = _jax_tree(params), _jax_tree(state)
    pp, ps = convert.from_jax(params), convert.from_jax(state)
    layers = [("stem", jnet.stem, pnet.stem)]
    layers += [(f"blocks/{i}", jb, pb) for i, (jb, pb) in enumerate(zip(jnet.blocks, pnet.blocks))]
    if jnet.head is not None:
        layers.append(("head", jnet.head, pnet.head))

    def port_kw(name):
        if not name.startswith("blocks/"):
            return {}
        return {"keep": None if noise is None else noise["drop_path"].get(int(name.split("/")[1]))}

    # each layer's output shape, from the port's own forward, for its
    # cotangent; a block whose spec (its drop_connect rate aside) and input
    # shape an earlier block had runs the same code on the same shapes, so
    # only the first of them is held to the bar
    rs = np.random.RandomState(seed)
    cts, checked, seen, a = [], [], set(), torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for name, jl, pl in layers:
            key = (dataclasses.replace(jl, drop_path=0.0) if name.startswith("blocks/") else jl, tuple(a.shape))
            checked.append(key not in seen)
            seen.add(key)
            a, _ = pl.apply(_sub(pp, name), _sub(ps, name), a, train=True, bn_mode="exact", **port_kw(name))
            if checked[-1]:
                cts.append(jnp.asarray(rs.normal(0, 1, _nhwc(a).shape).astype(np.float32)))
    jax_out, h = _jax_layers(layers, checked, rng)(jp, js, jnp.asarray(x), cts)
    layers = [layer for layer, check in zip(layers, checked) if check]
    worst = {"out": 0.0, "state": 0.0, "param_grad": 0.0, "input_grad": 0.0}
    for (name, _, pl), ct, (h_in, y, new_state, jgrad_p, jgrad_x) in zip(layers, cts, jax_out):
        leaves = {k: v.clone().requires_grad_(True) for k, v in convert.flatten_tree(_sub(pp, name)).items()}
        a = torch.from_numpy(np.array(h_in)).permute(0, 3, 1, 2).requires_grad_(True)
        py, pnew = pl.apply(convert.unflatten_tree(leaves), _sub(ps, name), a, train=True, bn_mode="exact",
                            **port_kw(name))
        keys = list(leaves)
        grads = torch.autograd.grad((py * torch.from_numpy(np.array(ct)).permute(0, 3, 1, 2)).sum(),
                                    [leaves[k] for k in keys] + [a])
        y = np.asarray(y)
        _close(_nhwc(py), y, f"{name}: output")
        worst["out"] = max(worst["out"], float(np.abs(_nhwc(py) - y).max()))
        want_s = {k: np.asarray(v) for k, v in convert.flatten_tree(new_state).items()}
        for k, v in convert.to_jax(pnew).items():
            _close(v, want_s[k], f"{name}: new BN state {k}")
            worst["state"] = max(worst["state"], float(np.abs(v - want_s[k]).max()))
        want_g = {k: np.asarray(v) for k, v in convert.flatten_tree(jgrad_p).items()}
        got_g = convert.to_jax(convert.unflatten_tree(dict(zip(keys, grads[:-1]))))
        assert set(got_g) == set(want_g), name
        for k, v in got_g.items():
            worst["param_grad"] = max(worst["param_grad"], _close_grad(v, want_g[k], f"{name}: gradient of {k}"))
        worst["input_grad"] = max(worst["input_grad"], _close_grad(_nhwc(grads[-1]), np.asarray(jgrad_x),
                                                                   f"{name}: gradient of its input"))
    h = np.asarray(h)
    # the tail: global pool, the classifier dropout's draw, the classifier
    keep = None if noise is None else np.asarray(noise["dropout"], np.float32) / (1.0 - jnet.dropout)
    pooled = h.mean(axis=(1, 2)) * (1.0 if keep is None else keep)
    logits, vjp = jax.vjp(lambda p, f: jnet.classifier.apply(p, f), jp["classifier"], jnp.asarray(pooled))
    ct = rs.normal(0, 1, logits.shape).astype(np.float32)
    jgrad_p, jgrad_f = vjp(jnp.asarray(ct))
    leaves = {k: v.clone().requires_grad_(True) for k, v in convert.flatten_tree(pp["classifier"]).items()}
    f = torch.from_numpy(pooled).requires_grad_(True)
    out = pnet.classifier.apply(convert.unflatten_tree(leaves), f)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [leaves["w"], leaves["b"], f])
    _close(out.detach().numpy(), np.asarray(logits), "classifier: logits")
    for g, want, what in zip(grads, (jgrad_p["w"], jgrad_p["b"], jgrad_f), ("w", "b", "input")):
        _close_grad(g.numpy(), np.asarray(want), f"classifier: gradient of {what}")
    assert np.abs(np.asarray(logits)).max() > 1e-2
    return worst


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_training_forward_and_gradients_match_jax_layer_by_layer(arch):
    """EfficientNet-B0 as its app ships it (drop_connect 0.2 ramped over the
    blocks, dropout 0.2), with the JAX package's per-block keep draws (its
    ``fold_in(rng, i)`` streams) and the classifier's injected into the port;
    the other four with dropout and drop_connect off."""
    recipe = arch == "efficientnet_b0"
    jnet, pnet = family_nets(arch) if recipe else family_nets(arch, dropout=0.0, drop_connect=0.0)
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=31)
    x = images(32)
    rng = noise = None
    if recipe:
        n = x.shape[0]
        rng = jax.random.PRNGKey(37)
        noise = {"drop_path": {}}
        for i, blk in enumerate(jnet.blocks):
            if blk.drop_path > 0 and blk.has_residual:
                keep = jax.random.bernoulli(jax.random.fold_in(rng, i), 1.0 - blk.drop_path, (n, 1, 1, 1))
                noise["drop_path"][i] = torch.from_numpy(np.array(keep).reshape(-1))
        assert len(noise["drop_path"]) >= 8 and not all(bool(k.all()) for k in noise["drop_path"].values())
        noise["dropout"] = torch.from_numpy(np.array(jax.random.bernoulli(rng, 0.8, (n, jnet.classifier.in_features))))
    worst = _layer_parity(jnet, pnet, params, state, x, seed=33, rng=rng, noise=noise)
    assert all(np.isfinite(v) for v in worst.values()), worst

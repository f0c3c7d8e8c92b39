"""The port's fused depthwise module (ops/fused_depthwise.py) against the JAX
package's Pallas kernel (ops/pallas_kernels.py), on the CPU.

On a CPU tensor the wrapper computes the kernel's plain PyTorch version, so
these tests hold that plain version to the JAX kernel run in Pallas
interpret mode and to its XLA reference, at the bar of tests/test_pallas.py
(1e-5), plus the gradient path. The CUDA kernel itself is held to the same
plain version on the card by the tests at the end (skipped without a card)
and by chip_smoke.py. Inputs are made with numpy from a seed and handed to
both packages.

JAX is imported only by the tests that compare against it (the ``ref``
fixture), so the card-only tests at the end also run on the card's machine,
which has no JAX: ``python -m pytest --noconftest tests/test_torch_port_kernels.py -k cuda``
(``--noconftest``: tests/conftest.py sets JAX up).
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from yet_another_mobilenet_series_tpu_torch.ops import activations as port_act
from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw
from yet_another_mobilenet_series_tpu_torch.ops.layers import bn_scale_shift

TOL = 1e-5  # tests/test_pallas.py's bar for the kernel against its reference
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "yet_another_mobilenet_series_tpu_torch", "csrc", "fused_depthwise.cu")


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: jax, jnp, the Pallas kernel module and the layers."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from yet_another_mobilenet_series_tpu.ops import activations, pallas_kernels
    from yet_another_mobilenet_series_tpu.ops.layers import BatchNorm, Conv2D

    return SimpleNamespace(jax=jax, jnp=jnp, act=activations, pk=pallas_kernels, BatchNorm=BatchNorm,
                           Conv2D=Conv2D)


def _operands(seed, n, h, c, k, mask_every=3):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    w = (rng.normal(size=(k, k, c)) * 0.2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    mask = np.ones(c, np.float32)
    mask[::mask_every] = 0.0
    return x, w, scale, shift, mask


def _port(ops, stride, act):
    return fdw.fused_depthwise(*[torch.from_numpy(a) for a in ops], stride, act).numpy()


# the cases of tests/test_pallas.py: its four (k, stride, act) cases, and
# C = 160 and 200 (channel counts that end in a partial TPU channel block)
PALLAS_CASES = [(3, 1, "relu6", 16, 12), (3, 2, "hswish", 16, 12), (5, 1, "swish", 16, 12),
                (7, 2, "relu", 16, 12)] + [(3, s, "hswish", c, 9) for c in (160, 200) for s in (1, 2)]


@pytest.mark.parametrize("k,stride,act,c,h", PALLAS_CASES)
def test_plain_matches_pallas_interpret(k, stride, act, c, h, ref):
    jnp, pk = ref.jnp, ref.pk
    ops = _operands(0, 2, h, c, k)
    got = _port(ops, stride, act)
    want = pk.fused_depthwise_inference(*map(jnp.asarray, ops), stride, act, True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("act", ["relu6", "hswish", "swish", "relu"])
def test_plain_matches_xla_reference_grid(k, stride, act, ref):
    """The whole k x stride x activation grid chip_smoke.py runs on the card,
    against the JAX kernel's XLA reference (_reference_fwd)."""
    jnp, pk = ref.jnp, ref.pk
    ops = _operands(k * 10 + stride, 2, 11, 24, k)
    got = _port(ops, stride, act)
    want = pk._reference_fwd(*map(jnp.asarray, ops), stride=stride, act=act)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_plain_bf16_matches_xla_reference_bf16(ref):
    """bf16 in -> bf16 out, accumulated in f32, against the JAX reference in
    bf16: the two f32 sums differ only in order, so the outputs agree to one
    bf16 ulp (2**-7 relative) where a sum falls on a rounding boundary."""
    jnp, pk = ref.jnp, ref.pk
    x, w, scale, shift, mask = _operands(3, 2, 10, 32, 5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = fdw.fused_depthwise(xb, *[torch.from_numpy(a) for a in (w, scale, shift, mask)], 2, "hswish")
    assert y.dtype == torch.bfloat16 and y.shape == (2, 5, 5, 32)
    want = pk._reference_fwd(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (w, scale, shift, mask)),
                             stride=2, act="hswish")
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), rtol=2.0 ** -7, atol=1e-6)


def test_fused_equals_jax_layer_pipeline(ref):
    """Plain fused (scale/shift from the port's bn_scale_shift) == the JAX
    Conv2D(depthwise) -> BN(eval) -> relu6 pipeline (tests/test_pallas.py's
    test_fused_equals_layer_pipeline, across the packages)."""
    jnp, BatchNorm, Conv2D = ref.jnp, ref.BatchNorm, ref.Conv2D
    c, k = 8, 3
    rng = np.random.RandomState(1)
    w_hwio = (rng.normal(size=(k, k, 1, c)) * 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    x = rng.normal(size=(2, 10, 10, c)).astype(np.float32)
    bn = BatchNorm(c)
    y_conv = Conv2D(c, c, k, 1, groups=c).apply({"w": jnp.asarray(w_hwio)}, jnp.asarray(x))
    y_bn, _ = bn.apply({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)},
                       {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}, y_conv, train=False)
    want = np.asarray(jnp.clip(y_bn, 0, 6))
    scale, shift = bn_scale_shift(*[torch.from_numpy(a) for a in (gamma, beta, mean, var)], bn.eps)
    got = fdw.fused_depthwise(torch.from_numpy(x), torch.from_numpy(w_hwio[:, :, 0, :]), scale, shift,
                              torch.ones(c), 1, "relu6").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stride,act", [(1, "hswish"), (2, "swish")])
def test_gradients_match_jax_vjp(stride, act, ref):
    """Backward through the wrapper's autograd.Function (recompute through
    the plain version) == jax.vjp of the Pallas entry's custom VJP, for all
    five differentiable operands."""
    jax, jnp, pk = ref.jax, ref.jnp, ref.pk
    ops = _operands(5, 2, 8, 8, 3)
    g_shape = pk._reference_fwd(*map(jnp.asarray, ops), stride=stride, act=act).shape
    g = np.random.RandomState(6).normal(size=g_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pk.fused_depthwise_inference(*a, stride, act, True), *map(jnp.asarray, ops))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    fdw.fused_depthwise(*ts, stride, act).backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fdw.fused_depthwise.launches
    ops = [torch.from_numpy(a) for a in _operands(7, 1, 6, 4, 3)]
    torch.testing.assert_close(fdw.fused_depthwise(*ops, 1, "relu"),
                               fdw.fused_depthwise_reference(*ops, 1, "relu"), rtol=0, atol=0)
    assert fdw.fused_depthwise.launches == before


def test_operand_checks_refuse_what_the_kernel_does_not_take():
    """The checks that guard the CUDA launch, run on CPU tensors."""
    x, w, scale, shift, mask = [torch.from_numpy(a) for a in _operands(8, 1, 6, 4, 3)]
    check = fdw._check_cuda_operands
    check(x, w, scale, shift, mask, 1, "hswish")  # well-formed: no raise
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check(x.double(), w, scale, shift, mask, 1, "relu")
    with pytest.raises(ValueError, match="contiguous NHWC"):
        check(x.permute(0, 2, 1, 3), w, scale, shift, mask, 1, "relu")
    with pytest.raises(ValueError, match="odd k"):
        check(x, torch.zeros(2, 2, 4), scale, shift, mask, 1, "relu")
    with pytest.raises(ValueError, match=r"\(k, k, 4\)"):
        check(x, torch.zeros(3, 3, 5), scale, shift, mask, 1, "relu")
    with pytest.raises(TypeError, match="scale must be contiguous float32"):
        check(x, w, scale.double(), shift, mask, 1, "relu")
    with pytest.raises(ValueError, match=r"mask must be \(4,\)"):
        check(x, w, scale, shift, torch.ones(5), 1, "relu")
    with pytest.raises(ValueError, match="stride"):
        check(x, w, scale, shift, mask, 0, "relu")
    with pytest.raises(ValueError, match="unknown activation"):
        check(x, w, scale, shift, mask, 1, "gelu")


def test_other_devices_raise():
    ops = [torch.from_numpy(a).to("meta") for a in _operands(9, 1, 6, 4, 3)]
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fdw.fused_depthwise(*ops, 1, "relu")


@pytest.mark.parametrize("name", sorted(port_act._ACTIVATIONS))
def test_activation_table_matches_jax(name, ref):
    jnp = ref.jnp
    x = np.linspace(-120.0, 120.0, 4001).astype(np.float32)
    got = port_act.get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.act.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


def test_activation_codes_cover_the_table_and_match_the_cuda_switch(ref):
    assert set(port_act.ACT_CODES) == set(port_act._ACTIVATIONS) == set(ref.act._ACTIVATIONS)
    with open(CSRC) as f:
        enum = dict((m.group(1), int(m.group(2))) for m in re.finditer(r"k(\w+) = (\d+),", f.read()))
    by_fn = {"identity": "Identity", "relu": "Relu", "relu6": "Relu6", "hswish": "Hswish",
             "hsigmoid": "Hsigmoid", "swish": "Swish", "sigmoid": "Sigmoid"}
    for name, code in port_act.ACT_CODES.items():
        fn = port_act.get_activation(name).__name__
        assert enum[by_fn[fn]] == code, (name, fn, code)


# ---------------------------------------------------------------------------
# on the card only: the CUDA kernel against the plain version
# ---------------------------------------------------------------------------

# the string condition is evaluated when the test runs, not at import
needs_card = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card (the kernel has no CPU mode)")


@needs_card
@pytest.mark.parametrize("k,stride,act,c,h", PALLAS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(k, stride, act, c, h, dtype):
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    x, w, scale, shift, mask = [torch.from_numpy(a).cuda() for a in _operands(0, 2, h, c, k)]
    x = x.to(dt)
    before = fdw.fused_depthwise.launches
    y = fdw.fused_depthwise(x, w, scale, shift, mask, stride, act)
    torch.cuda.synchronize()
    assert fdw.fused_depthwise.launches == before + 1
    ref = fdw.fused_depthwise_reference(x, w, scale, shift, mask, stride, act)
    # bf16: one bf16 ulp (2**-7 relative) where the f32 sums round apart
    tol = (TOL, TOL) if dtype == "float32" else (2.0 ** -7, 1e-2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol[0], atol=tol[1])


@needs_card
def test_cuda_wrapper_raises_on_bad_operands_instead_of_falling_back():
    x, w, scale, shift, mask = [torch.from_numpy(a).cuda() for a in _operands(0, 1, 6, 4, 3)]
    with pytest.raises(TypeError):
        fdw.fused_depthwise(x.double(), w, scale, shift, mask, 1, "relu")
    with pytest.raises(ValueError):
        fdw.fused_depthwise(x, w, scale.cpu(), shift, mask, 1, "relu")

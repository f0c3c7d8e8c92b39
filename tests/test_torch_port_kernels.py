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


def test_int_args_follow_the_order_the_c_entry_reads_them():
    """The wrapper passes the launch's integers as one array: its order
    (INT_ARGS) is the order in which yamt_fused_depthwise unpacks args[i]."""
    with open(CSRC) as f:
        unpacked = {int(m.group(2)): m.group(1) for m in re.finditer(r"(\w+) = args\[(\d+)\]", f.read())}
    assert [unpacked[i] for i in range(len(unpacked))] == list(fdw.INT_ARGS)
    p = fdw.plan(2, 9, 9, 16, 3, 1, 4, True)
    args = fdw._int_args(0, 2, 9, 9, 16, 3, 1, 2, 0, 16, 16, p)
    named = dict(zip(fdw.INT_ARGS, args))
    assert (named["th"], named["tw"], named["cb"], named["threads"], named["vec"]) == (p.th, p.tw, p.cb, p.threads,
                                                                                        p.vec)
    assert (named["smem_bytes"], named["pad"], named["row_pitch"]) == (p.smem, p.pad, p.row_pitch)


# ---------------------------------------------------------------------------
# the kernel's tiling plan (pure Python: it runs here as on the card)
# ---------------------------------------------------------------------------


def _mbv3_stages():
    """(h, c, k, stride) of the 15 depthwise stages of MobileNetV3-Large at
    224, from the port's own model table."""
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    net = get_model(ModelConfig(arch="mobilenet_v3_large"), image_size=224)
    h = fdw.out_size(224, net.stem.stride)
    stages = []
    for blk in net.blocks:
        for _, k, g, _ in blk._branches():
            stages.append((h, g, k, blk.stride))
        h = fdw.out_size(h, blk.stride)
    return stages


MBV3_STAGES = _mbv3_stages()
# (n, h, c, k, stride): the 15 stages at the serving buckets, the Pallas
# grid, and odd shapes (a scalar tail, a 1x1 image, k = 7 at stride 2)
PLAN_SHAPES = sorted({(n, h, c, k, s) for n in (1, 8, 32) for (h, c, k, s) in MBV3_STAGES}
                     | {(2, h, c, k, s) for (k, s, _, c, h) in PALLAS_CASES}
                     | {(2, 9, 13, 3, 1), (3, 1, 13, 7, 2), (2, 1, 16, 3, 1), (2, 6, 16, 7, 2), (1, 13, 13, 7, 2),
                        (2, 11, 24, 9, 3)})


def test_plan_shapes_hold_the_fifteen_mbv3_stages():
    assert len(MBV3_STAGES) == 15
    assert MBV3_STAGES[0] == (112, 16, 3, 1) and MBV3_STAGES[-1] == (7, 960, 5, 1)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,h,c,k,stride", PLAN_SHAPES)
def test_plan_covers_every_output_once(n, h, c, k, stride, itemsize):
    """Enumerate the plan's blocks as the kernel decodes blockIdx.x (channel
    chunk fastest, then tile column, tile row, image) and mark the outputs
    each writes: every output element exactly once."""
    p = fdw.plan(n, h, h, c, k, stride, itemsize, c % (16 // itemsize) == 0)
    o = fdw.out_size(h, stride)
    assert p.tw % p.r == 0 and p.cb % p.vec == 0 and p.r == fdw.strip_width(p.vec)
    assert (p.tiles_h, p.tiles_w, p.chunks) == (-(-o // p.th), -(-o // p.tw), -(-c // p.cb))
    assert p.blocks == n * p.tiles_h * p.tiles_w * p.chunks
    seen = np.zeros((n, o, o, c), np.int8)
    for b in range(p.blocks):
        chunk, rest = b % p.chunks, b // p.chunks
        tx, rest = rest % p.tiles_w, rest // p.tiles_w
        ty, img = rest % p.tiles_h, rest // p.tiles_h
        seen[img, ty * p.th: (ty + 1) * p.th, tx * p.tw: (tx + 1) * p.tw, chunk * p.cb: (chunk + 1) * p.cb] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,h,c,k,stride", PLAN_SHAPES)
def test_plan_stays_within_its_shared_memory(n, h, c, k, stride, itemsize):
    """The shared memory the plan declares is what its tile needs (the halo
    tile, then the taps and the three per-channel vectors in float32), it
    stays under the target that keeps several blocks resident on an SM, and
    the block's threads cover its strips within the kernel's launch bound."""
    vector = c % (16 // itemsize) == 0
    p = fdw.plan(n, h, h, c, k, stride, itemsize, vector)
    staged = itemsize if vector else 4
    ih, iw = (p.th - 1) * stride + k, (p.tw - 1) * stride + k
    pad, row_pitch = p.pad, p.row_pitch
    assert (pad, row_pitch) == fdw.staged_layout(p.tw, p.cb, k, stride, p.vec)
    assert 0 <= pad and row_pitch >= iw * p.cb and (row_pitch * staged) % (16 if vector else 4) == 0
    assert p.smem == ih * row_pitch * staged + (k * k + 3) * p.cb * 4
    assert p.smem <= fdw.SMEM_DEFAULT
    assert fdw.SM_SMEM // (p.smem + 1024) >= 4
    items = p.th * (p.tw // p.r) * (p.cb // p.vec)
    assert p.threads % 32 == 0 and 32 <= p.threads <= fdw.MAX_THREADS
    assert p.threads == min(fdw.MAX_THREADS, -(-items // 32) * 32)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("h,c,k,stride", sorted(set(MBV3_STAGES)) + [(9, 13, 3, 1), (23, 50, 5, 2), (11, 24, 9, 3)])
def test_staged_layout_is_collision_free_and_keeps_loads_on_distinct_banks(h, c, k, stride, itemsize):
    """Mirror the kernel's addressing of the staged tile: every staged
    element has its own slot inside the declared rows, every load of the
    compute reads a staged slot, and a quarter-warp's 16-byte loads (a
    warp's 4-byte loads on the scalar path) fall on distinct banks, except
    at stride 2 where a row of strips holds an odd number of vectors."""
    vector = c % (16 // itemsize) == 0
    p = fdw.plan(32, h, h, c, k, stride, itemsize, vector)
    pad, rp = p.pad, p.row_pitch
    nvec, group = p.cb // p.vec, p.r * stride
    ih, iw = (p.th - 1) * stride + k, (p.tw - 1) * stride + k
    slots = {row * rp + col * p.cb + (col // group) * pad + cv * p.vec
             for row in range(ih) for col in range(iw) for cv in range(nvec)}
    assert len(slots) == ih * iw * nvec and max(slots) + p.vec <= ih * rp
    strips = p.tw // p.r
    items = p.th * strips * nvec
    unit, phase, banks = (16, 8, 8) if vector else (4, 32, 32)
    worst = 1
    for w0 in range(0, items, 32):
        base = []
        for it in range(w0, min(items, w0 + 32)):
            cv, rest = it % nvec, it // nvec
            base.append((rest // strips) * stride * rp + (rest % strips) * (group * p.cb + pad) + cv * p.vec)
        for i in range(k):
            for q in range((p.r - 1) * stride + k):
                addr = [b + i * rp + q * p.cb + (q // group) * pad for b in base]
                assert set(addr) <= slots
                for g in range(0, len(addr), phase):
                    used = [(a * (itemsize if vector else 4) // unit) % banks for a in set(addr[g: g + phase])]
                    worst = max(worst, max(used.count(b) for b in used))
    odd_rows = stride == 2 and (strips * nvec) % 2
    assert worst == 1 or (odd_rows and worst <= 2), (p, worst)


def test_plan_fills_the_card_where_the_shape_has_the_work():
    """At every serving bucket a stage with enough outputs gets at least a
    block per SM; at batch 32 the big early stages get several waves."""
    for n in (1, 8, 32):
        for h, c, k, s in MBV3_STAGES:
            p = fdw.plan(n, h, h, c, k, s, 4, True)
            assert p.blocks >= min(fdw.SMS * 3 // 4, n * fdw.out_size(h, s) ** 2 * c // 512), (n, h, c, k, s, p)


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_plan_picks_the_vector_path_only_where_channels_and_offset_allow(dtype, vec):
    wide = torch.zeros((2, 6, 6, 48), dtype=dtype)
    out = torch.zeros((2, 3, 3, 48), dtype=dtype)
    assert wide.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert fdw.launch_plan(wide, 3, 2, out).vec == vec  # contiguous, C = 48
    for off, c in [(0, 16), (8, 16), (16, 24), (3, 16), (4, 16), (0, 13), (5, 13), (2, 6)]:
        xs, ys = wide[..., off: off + c], out[..., off: off + c]
        allowed = c % vec == 0 and off % vec == 0
        assert fdw.vector_ok(xs, ys) == allowed, (off, c)
        p = fdw.launch_plan(xs, 3, 2, ys)
        assert p.vec == (vec if allowed else 1), (off, c, p)
    # an output slice off the vector forces the scalar path too
    assert fdw.launch_plan(wide[..., :16], 3, 2, out[..., 4:20]).vec == (1 if vec == 8 else 4)
    assert fdw.launch_plan(wide[..., :16], 3, 2, out[..., 2:18]).vec == 1


def test_pixel_pitch_takes_channel_slices_and_refuses_other_views():
    t = torch.zeros((2, 5, 7, 40))
    assert fdw.pixel_pitch(t) == 40
    assert fdw.pixel_pitch(t[..., 3:17]) == 40
    for bad in (t[:, :, ::2], t[:, 1:4], t.permute(0, 2, 1, 3), t[..., ::2]):
        with pytest.raises(ValueError, match="contiguous NHWC"):
            fdw.pixel_pitch(bad)


@pytest.mark.parametrize("stride", [1, 2])
def test_out_slices_on_the_cpu_match_the_plain_version_and_touch_nothing_else(stride):
    """The branches of an AtomNAS block written into slices of one output
    (what serve/export.py does) equal the plain version on contiguous
    copies, with the other channels left as they were."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.normal(size=(2, 9, 9, 40)).astype(np.float32))
    o = fdw.out_size(9, stride)
    out = torch.full((2, o, o, 40), 7.0)
    for off, g, k in [(0, 14, 3), (14, 13, 5), (30, 8, 7)]:
        _, w, scale, shift, mask = [torch.from_numpy(a) for a in _operands(off, 1, 1, g, k)]
        got = fdw.fused_depthwise(x[..., off: off + g], w, scale, shift, mask, stride, "hswish",
                                  out=out[..., off: off + g])
        assert got.data_ptr() == out[..., off: off + g].data_ptr()
        want = fdw.fused_depthwise_reference(x[..., off: off + g].contiguous(), w, scale, shift, mask, stride,
                                             "hswish")
        torch.testing.assert_close(out[..., off: off + g], want, rtol=0, atol=0)
    assert (out[..., 27:30] == 7.0).all() and (out[..., 38:] == 7.0).all()


def test_out_refuses_inputs_that_need_a_gradient_and_wrong_shapes():
    x, w, scale, shift, mask = [torch.from_numpy(a) for a in _operands(12, 1, 6, 4, 3)]
    with pytest.raises(RuntimeError, match="records no gradient"):
        fdw.fused_depthwise(x.requires_grad_(True), w, scale, shift, mask, 1, "relu", out=torch.empty(1, 6, 6, 4))
    with pytest.raises(ValueError, match="out must be"):
        fdw.fused_depthwise(x.detach(), w, scale, shift, mask, 2, "relu", out=torch.empty(1, 6, 6, 4))


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


@needs_card
def test_cuda_entry_refuses_a_layout_or_shared_memory_too_small_for_its_tile():
    import dataclasses

    ops = _cuda_operands(0, 2, 12, 16, 3, "float32")
    p = fdw.plan(2, 12, 12, 16, 3, 1, 4, True)
    for bad in (dataclasses.replace(p, row_pitch=p.row_pitch - p.row_pitch % p.vec - p.vec - p.pad),
                dataclasses.replace(p, smem=p.smem - 4), dataclasses.replace(p, pad=p.pad + 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fdw._launch(*ops, 1, "relu", tile=bad)
    y = fdw._launch(*ops, 1, "relu", tile=p)
    torch.cuda.synchronize()
    _assert_matches_plain(y, fdw.fused_depthwise_reference(*ops, 1, "relu"), "float32")


# edge cases of the tiled kernel: (n, h, c, k, stride, act)
EDGE_CASES = [
    (2, 9, 13, 3, 1, "relu6"),      # C = 13: the scalar path's tail
    (3, 1, 16, 3, 1, "hswish"),     # a 1x1 image: outputs smaller than one tile
    (1, 3, 13, 7, 2, "swish"),      # k = 7 at stride 2 over a 3x3 image, scalar
    (2, 5, 24, 5, 2, "relu"),       # a 3x3 output under one tile
    (2, 11, 24, 9, 3, "hsigmoid"),  # k and stride outside the compiled ones: the runtime path
    (2, 10, 8, 1, 1, "sigmoid"),    # k = 1
] + [(2, 7, 32, 3, 1, act) for act in sorted(port_act.ACT_CODES)]  # every activation code


def _cuda_operands(seed, n, h, c, k, dtype):
    x, w, scale, shift, mask = [torch.from_numpy(a).cuda() for a in _operands(seed, n, h, c, k)]
    return x.to(getattr(torch, dtype)), w, scale, shift, mask


def _assert_matches_plain(y, ref, dtype):
    # bf16: one bf16 ulp (2**-7 relative) where the f32 sums round apart
    tol = (TOL, TOL) if dtype == "float32" else (2.0 ** -7, 1e-2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol[0], atol=tol[1])


@needs_card
@pytest.mark.parametrize("n,h,c,k,stride,act", EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_edge_cases_match_plain(n, h, c, k, stride, act, dtype):
    torch.backends.cudnn.allow_tf32 = False
    ops = _cuda_operands(1, n, h, c, k, dtype)
    before = fdw.fused_depthwise.launches
    y = fdw.fused_depthwise(*ops, stride, act)
    torch.cuda.synchronize()
    assert fdw.fused_depthwise.launches == before + 1
    _assert_matches_plain(y, fdw.fused_depthwise_reference(*ops, stride, act), dtype)


@needs_card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_partial_last_tiles_in_h_w_and_c(dtype):
    """A tiling that leaves a partial last tile in H, in W and in C, on the
    vector path (C = 40) and on the scalar path (C = 50)."""
    torch.backends.cudnn.allow_tf32 = False
    for n, h, c, k, stride in [(2, 23, 40, 3, 1), (2, 23, 50, 5, 2)]:
        ops = _cuda_operands(2, n, h, c, k, dtype)
        o = fdw.out_size(h, stride)
        vector = c % (16 // ops[0].element_size()) == 0
        tile = next(p for _, p in fdw.tilings(n, h, h, c, k, stride, ops[0].element_size(), vector)
                    if o % p.th and o % p.tw and c % p.cb and p.smem <= fdw.SMEM_DEFAULT)
        y = fdw._launch(*ops, stride, "hswish", tile=tile)
        torch.cuda.synchronize()
        _assert_matches_plain(y, fdw.fused_depthwise_reference(*ops, stride, "hswish"), dtype)


@needs_card
@pytest.mark.parametrize("off,vector", [(3, False), (8, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_reads_and_writes_channel_slices(off, vector, dtype):
    """A branch slice of a wider NHWC input into a slice of a wider output:
    offset 3 takes the scalar path, offset 8 the vector path (16 channels);
    the other channels of the output stay untouched."""
    torch.backends.cudnn.allow_tf32 = False
    wide, g, k, stride = 40, 16, 5, 2
    x = torch.from_numpy(np.random.RandomState(3).normal(size=(2, 14, 14, wide)).astype(np.float32)).cuda()
    x = x.to(getattr(torch, dtype))
    out = torch.full((2, 7, 7, wide), float("nan"), device="cuda", dtype=x.dtype)
    _, w, scale, shift, mask = _cuda_operands(4, 1, 1, g, k, dtype)
    xs, ys = x[..., off: off + g], out[..., off: off + g]
    assert (fdw.launch_plan(xs, k, stride, ys).vec > 1) == vector
    fdw.fused_depthwise(xs, w, scale, shift, mask, stride, "relu6", out=ys)
    torch.cuda.synchronize()
    _assert_matches_plain(ys, fdw.fused_depthwise_reference(xs.contiguous(), w, scale, shift, mask, stride, "relu6"),
                          dtype)
    rest = torch.ones(wide, dtype=torch.bool)
    rest[off: off + g] = False
    assert torch.isnan(out[..., rest.cuda()].float()).all()


# ---------------------------------------------------------------------------
# on the card only: the engine's CUDA graphs (serve/engine.py), K1 inside
# ---------------------------------------------------------------------------


def _tiny_bundle():
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve import export

    specs = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25}, {"t": 3, "c": 16, "n": 2, "s": 2}]
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, block_specs=specs, dropout=0.0), image_size=24)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    return export.InferenceBundle(net=net, params=export.fold_network(net, params, random_bn_state(net, gen)),
                                  meta={})


@needs_card
def test_cuda_graph_replay_matches_eager_bitwise():
    """Per bucket and fused K=2, a graph replay equals the eager forward of
    the same shapes bit for bit; a dispatch after warmup is one replay, and
    each graph recorded K1's launches."""
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(_tiny_bundle(), device="cuda", buckets=(2, 4), image_size=24, fuse_ladder=(2,),
                          ring_slots=2, overlap_staging=True)
    eng.warmup()
    rng = np.random.RandomState(0)
    for n in (2, 4, 8):
        x = rng.normal(0, 1, (n, 24, 24, 3)).astype(np.float32)
        want = torch.cat([eng._forward(torch.from_numpy(x[i: i + 4]).cuda()) for i in range(0, n, 4)])
        np.testing.assert_array_equal(eng.predict(x), want.cpu().numpy())
    reg = get_registry()
    before = reg.snapshot().get("serve.graph_replays", 0)
    eng.predict(rng.normal(0, 1, (3, 24, 24, 3)).astype(np.float32))
    assert reg.snapshot()["serve.graph_replays"] - before == 1
    per_forward = sum(1 for blk in eng.net.blocks for _ in blk._branches())  # one launch per dw branch
    assert all(r["k1_launches"] == per_forward * r["key"][2] for r in eng.graph_report())


@needs_card
def test_cuda_inflight_dispatches_of_one_key_keep_their_own_outputs():
    """Unsynced replays of one key each hand back their own logits: the
    static output is copied off right after each replay."""
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(_tiny_bundle(), device="cuda", buckets=(4,), image_size=24)
    eng.warmup()
    rng = np.random.RandomState(1)
    xs = [rng.normal(0, 1, (4, 24, 24, 3)).astype(np.float32) for _ in range(3)]
    handles = [eng.predict_async(x) for x in xs]
    for x, h in zip(xs, handles):
        np.testing.assert_array_equal(h.result(), eng._forward(torch.from_numpy(x).cuda()).cpu().numpy())

"""The port's AtomNAS machinery (nas/masking.py, nas/penalty.py,
nas/latency.py, nas/rematerialize.py, utils/treeutil.py) against the JAX
package's, on the CPU.

Both packages take one set of weights, made by numpy from a seed in the JAX
layouts and carried into the port by models/convert.py, at the tiny
supernet of tests/test_nas.py. Masks, prune events and rematerialized
trees are integer decisions and gathers, so they must be equal exactly;
penalties and cost tables are float32 sums held to 1e-6 and 1e-7; the
masked and the rematerialized forward to the repository's float32 bar
(rtol 1e-4, atol 1e-5).
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig, PruneConfig as JaxPruneConfig
from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.models.serialize import network_to_dict as jax_network_to_dict
from yet_another_mobilenet_series_tpu.nas import latency as jlatency, masking as jmasking, penalty as jpenalty
from yet_another_mobilenet_series_tpu.nas import rematerialize as jremat
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, PruneConfig
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.serialize import network_to_dict
from yet_another_mobilenet_series_tpu_torch.nas import latency, masking, penalty, rematerialize
from yet_another_mobilenet_series_tpu_torch.utils import treeutil
from yet_another_mobilenet_series_tpu_torch.utils.profiling import masked_macs, profile_network

from test_torch_port_models import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # the repository's float32 forward bar

# tests/test_nas.py's _supernet(): a t=1 block (not prunable), a stride-2
# block without residual, a residual block, and an SE block, each with
# k = 3/5/7 branches
SPECS = (
    {"t": 1, "c": 16, "n": 1, "s": 1, "k": [3, 5, 7]},
    {"t": 6, "c": 16, "n": 2, "s": 2, "k": [3, 5, 7]},
    {"t": 6, "c": 24, "n": 1, "s": 2, "k": [3, 5, 7], "se": 0.25},
)


def _nets(specs=SPECS, image_size=32):
    kw = dict(arch="atomnas_supernet", num_classes=4, dropout=0.0, block_specs=specs)
    return (jax_get_model(JaxModelConfig(**kw), image_size=image_size),
            get_model(ModelConfig(**kw), image_size=image_size))


def _params(jnet, seed=0, gammas=None):
    """(JAX tree, port tree) of one numpy-made weight set; ``gammas``
    overrides blocks' dw_bn gamma ({block key: array})."""
    flat = numpy_params(jnet, seed)
    for k, g in (gammas or {}).items():
        flat[f"blocks/{k}/dw_bn/gamma"] = np.asarray(g, np.float32)
    jtree = jax.tree.map(jnp.asarray, convert.unflatten_tree(flat))
    return jtree, convert.from_jax(flat)


def _masks_both(np_masks):
    return ({k: jnp.asarray(v) for k, v in np_masks.items()},
            {k: torch.from_numpy(np.array(v, np.float32)) for k, v in np_masks.items()})


def _same_masks(jm, pm):
    assert set(jm) == set(pm)
    for k in jm:
        assert pm[k].dtype == torch.float32
        np.testing.assert_array_equal(pm[k].numpy(), np.asarray(jm[k]), err_msg=f"mask {k}")


def _random_masks(net, rng, kill_frac=0.5, kill_all_block=None, kill_branch=None):
    """tests/test_nas.py's _random_masks, as numpy."""
    masks = {}
    for i in jmasking.prunable_blocks(net):
        b = net.blocks[i]
        m = (rng.uniform(size=b.expanded_channels) > kill_frac).astype(np.float32)
        if m.sum() == 0:
            m[0] = 1.0
        if kill_all_block == i:
            m[:] = 0.0
        if kill_branch is not None and kill_branch[0] == i:
            off = int(np.cumsum([0] + list(b.group_channels))[kill_branch[1]])
            m[off: off + b.group_channels[kill_branch[1]]] = 0.0
            if m.sum() == 0:
                m[-1] = 1.0
        masks[str(i)] = m
    return masks


# ---------------------------------------------------------------------------
# masks and the mask update
# ---------------------------------------------------------------------------


def test_prunable_blocks_and_init_masks_match_jax():
    jnet, pnet = _nets()
    assert masking.prunable_blocks(pnet) == jmasking.prunable_blocks(jnet) == [1, 2, 3]
    _same_masks(jmasking.init_masks(jnet), masking.init_masks(pnet, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            masking.init_masks(pnet)  # the run's device is the card unless the caller asks


def test_mask_update_thresholds_and_is_monotonic_like_jax():
    jnet, pnet = _nets()
    e1 = pnet.blocks[1].expanded_channels
    gamma = np.linspace(-1.2, 1.2, e1).astype(np.float32)
    jp, pp = _params(jnet, gammas={"1": gamma})
    cfg = dict(enable=True, gamma_threshold=0.5)
    jup, pup = jmasking.make_mask_update(jnet, JaxPruneConfig(**cfg)), masking.make_mask_update(pnet, PruneConfig(**cfg))
    jm, pm = _masks_both({k: np.asarray(v) for k, v in jmasking.init_masks(jnet).items()})
    jnew, pnew = jup(jp, jm), pup(pp, pm)
    _same_masks(jnew, pnew)
    np.testing.assert_array_equal(pnew["1"].numpy(), (np.abs(gamma) >= 0.5).astype(np.float32))
    # monotonic: gamma back above the threshold does not revive the atom
    jp["blocks"]["1"]["dw_bn"]["gamma"] = jnp.ones(e1)
    pp["blocks"]["1"]["dw_bn"]["gamma"] = torch.ones(e1)
    jnew2, pnew2 = jup(jp, jnew), pup(pp, pnew)
    _same_masks(jnew2, pnew2)
    np.testing.assert_array_equal(pnew2["1"].numpy(), pnew["1"].numpy())


@pytest.mark.parametrize("case", ["tie", "strongest_dead"])
def test_mask_update_revives_the_first_strongest_alive_atom_like_jax(case):
    """A block without residual (block 1, stride 2) whose atoms all fall
    below the threshold keeps its strongest previously alive atom; of equal
    maxima both argmaxes take the first."""
    jnet, pnet = _nets()
    assert not pnet.blocks[1].has_residual and pnet.blocks[2].has_residual
    e1, e2 = pnet.blocks[1].expanded_channels, pnet.blocks[2].expanded_channels
    g1 = np.full(e1, 0.1, np.float32)
    m1 = np.ones(e1, np.float32)
    if case == "tie":
        g1[[3, 7, 40]] = 0.4  # three equal maxima
        want = 3
    else:
        g1[5] = 0.45  # the strongest is dead already
        m1[5] = 0.0
        g1[[9, 12]] = -0.4  # |gamma| ties among the alive
        want = 9
    jp, pp = _params(jnet, gammas={"1": g1, "2": np.full(e2, 0.1, np.float32)})
    cfg = dict(enable=True, gamma_threshold=0.5)
    masks = {k: np.asarray(v) for k, v in jmasking.init_masks(jnet).items()}
    masks["1"] = m1
    jm, pm = _masks_both(masks)
    jnew = jmasking.make_mask_update(jnet, JaxPruneConfig(**cfg))(jp, jm)
    pnew = masking.make_mask_update(pnet, PruneConfig(**cfg))(pp, pm)
    _same_masks(jnew, pnew)
    assert np.flatnonzero(pnew["1"].numpy()).tolist() == [want]
    assert float(pnew["2"].sum()) == 0.0  # a residual block may die whole


# ---------------------------------------------------------------------------
# the prune event
# ---------------------------------------------------------------------------

EVENT_CASES = [
    # (schedule, target reached?, step): on cadence, off cadence, past stop
    (sched, reached, step)
    for sched in ("constant", "adaptive") for reached in (False, True) for step in (2, 1, 102)
]


@pytest.mark.parametrize("sched,reached,step", EVENT_CASES,
                         ids=[f"{s}-{'reached' if r else 'unreached'}-step{t}" for s, r, t in EVENT_CASES])
def test_prune_event_matches_jax(sched, reached, step):
    jnet, pnet = _nets()
    g = np.asarray(numpy_params(jnet, 0)["blocks/1/dw_bn/gamma"]).copy()
    g[:2] = 0.01  # two deaths when the update applies
    jp, pp = _params(jnet, gammas={"1": g})
    cfg = dict(enable=True, rho=0.1, mask_interval=2, gamma_threshold=0.1, rho_schedule=sched,
               rho_adapt_rate=0.05, target_flops=1e18 if reached else 1.0)
    jevent = jax.jit(jmasking.make_prune_event(jnet, JaxPruneConfig(**cfg), stop_step=100))
    pevent = masking.make_prune_event(pnet, PruneConfig(**cfg), stop_step=100, device="cpu")
    jm, pm = _masks_both({k: np.asarray(v) for k, v in jmasking.init_masks(jnet).items()})
    jmasks, jrho = jevent(jp, jm, jnp.ones((), jnp.float32), jnp.asarray(step, jnp.int32))
    pmasks, prho = pevent(pp, pm, torch.ones(()), torch.tensor(step, dtype=torch.int32))
    _same_masks(jmasks, pmasks)
    assert float(prho) == pytest.approx(float(jrho), rel=1e-7)
    applies = step == 2 and not reached
    assert float(pmasks["1"].sum()) == pnet.blocks[1].expanded_channels - (2 if applies else 0)
    want_rho = 1.0 if sched == "constant" or step != 2 else (0.95 if reached else 1.05)
    assert float(prho) == pytest.approx(want_rho, rel=1e-6)


def test_mask_summary_matches_jax():
    jnet, pnet = _nets()
    masks = _random_masks(jnet, np.random.RandomState(2))
    jm, pm = _masks_both(masks)
    assert masking.mask_summary(pnet, pm) == jmasking.mask_summary(jnet, jm)
    full = masking.mask_summary(pnet, masking.init_masks(pnet, "cpu"))
    assert full["alive_atoms"] == full["total_atoms"] and full["effective_macs"] == profile_network(pnet).total_macs


# ---------------------------------------------------------------------------
# the penalty and its cost tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_atom_cost_table_matches_jax_flops(normalize):
    jnet, pnet = _nets()
    want = jpenalty.atom_cost_table(jnet, JaxPruneConfig(enable=True, normalize_cost=normalize))
    got = penalty.atom_cost_table(pnet, PruneConfig(enable=True, normalize_cost=normalize))
    assert list(got) == list(want) == ["1", "2", "3"]
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=0)


PENALTY_CASES = [
    ("constant", {}, None, None),
    ("ramp", {"rho_ramp_epochs": 1.0}, None, 5),
    ("ramp", {"rho_ramp_epochs": 1.0}, None, 999),
    ("adaptive", {"rho_ramp_epochs": 1.0, "target_flops": 1.0}, 3.0, 10),
    ("adaptive", {"target_flops": 1.0}, 0.5, None),
]


@pytest.mark.parametrize("sched,extra,mult,step", PENALTY_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PENALTY_CASES)])
def test_penalty_flops_matches_jax(sched, extra, mult, step):
    jnet, pnet = _nets()
    jp, pp = _params(jnet, seed=3)
    cfg = dict(enable=True, rho=2.0, rho_schedule=sched, **extra)
    jfn = jpenalty.make_penalty_fn(jnet, JaxPruneConfig(**cfg), steps_per_epoch=10)
    pfn = penalty.make_penalty_fn(pnet, PruneConfig(**cfg), steps_per_epoch=10, device="cpu")
    jm, pm = _masks_both(_random_masks(jnet, np.random.RandomState(1)))
    jkw = {"rho_mult": None if mult is None else jnp.asarray(mult, jnp.float32),
           "step": None if step is None else jnp.asarray(step, jnp.int32)}
    pkw = {"rho_mult": None if mult is None else torch.tensor(mult),
           "step": None if step is None else torch.tensor(step, dtype=torch.int32)}
    want, got = float(jfn(jp, jm, **jkw)), pfn(pp, pm, **pkw)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert want > 0 and float(got) == pytest.approx(want, rel=1e-6)
    # bf16 compute: gamma is still read in float32 (params are float32 masters)
    pbf = convert.unflatten_tree({k: v.to(torch.bfloat16) if k.endswith("gamma") else v
                                  for k, v in convert.flatten_tree(pp).items()})
    assert pfn(pbf, pm, **pkw).dtype == torch.float32


def test_penalty_validation_matches_jax():
    _, pnet = _nets()
    with pytest.raises(ValueError, match="rho_schedule"):
        penalty.make_penalty_fn(pnet, PruneConfig(enable=True, rho_schedule="bogus"), device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        penalty.make_penalty_fn(pnet, PruneConfig(enable=True, rho_schedule="ramp", rho_ramp_epochs=1.0),
                                device="cpu")
    with pytest.raises(ValueError, match="target_flops"):
        penalty.make_penalty_fn(pnet, PruneConfig(enable=True, rho_schedule="adaptive"), 10, device="cpu")
    with pytest.raises(ValueError, match="latency_table"):
        penalty.atom_cost_table(pnet, PruneConfig(enable=True, cost="latency_table"))
    with pytest.raises(ValueError, match="unknown prune.cost"):
        penalty.atom_cost_table(pnet, PruneConfig(enable=True, cost="watts"))


LAT_SPECS = (  # tests/test_latency_table.py's supernet
    {"t": 1, "c": 8, "n": 1, "s": 1, "k": [3]},
    {"t": 4, "c": 8, "n": 1, "s": 2, "k": [3, 5]},
    {"t": 4, "c": 16, "n": 1, "s": 2, "k": [3, 5]},
)


@pytest.fixture(scope="module")
def tiny_table(tmp_path_factory):
    """A measured table for the tiny supernet, built as
    tests/test_latency_table.py builds one (the JAX package's
    scripts/latency_table.py, 2 widths, 2 iterations) in a temp dir."""
    spec = importlib.util.spec_from_file_location("latency_table", os.path.join(REPO, "scripts", "latency_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jnet, _ = _nets(LAT_SPECS, 24)
    entries = mod.build_table(jnet, [24], (0.5, 1.0), batch=2, iters=2)
    path = tmp_path_factory.mktemp("latbl") / "LATENCY_TABLE_test.json"
    path.write_text(json.dumps({"entries": entries}))
    return str(path)


def test_latency_table_penalty_matches_jax(tiny_table):
    jnet, pnet = _nets(LAT_SPECS, 24)
    sizes = latency.block_input_sizes(pnet, 24)
    assert sizes == jlatency.block_input_sizes(jnet, 24)
    assert [latency.block_key(b, s) for b, s in zip(pnet.blocks, sizes)] == \
           [jlatency.block_key(b, s) for b, s in zip(jnet.blocks, sizes)]
    cfg = dict(enable=True, cost="latency_table", latency_table=tiny_table, rho=1.0)
    want = jpenalty.atom_cost_table(jnet, JaxPruneConfig(**cfg))
    got = penalty.atom_cost_table(pnet, PruneConfig(**cfg))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=0)
    jp, pp = _params(jnet, seed=4)
    jm, pm = _masks_both(_random_masks(jnet, np.random.RandomState(5)))
    want_pen = float(jpenalty.make_penalty_fn(jnet, JaxPruneConfig(**cfg))(jp, jm))
    got_pen = float(penalty.make_penalty_fn(pnet, PruneConfig(**cfg), device="cpu")(pp, pm))
    assert got_pen == pytest.approx(want_pen, rel=1e-6)


def test_checked_in_latency_table_has_the_common_format():
    """The repository's rehearsal table loads in both packages alike (its
    format only: it was measured on a CPU)."""
    path = os.path.join(REPO, "LATENCY_TABLE_r01_cpu_rehearsal.json")
    mine, theirs = latency.LatencyTable.load(path), jlatency.LatencyTable.load(path)
    assert mine.entries == theirs.entries and mine.provenance == theirs.provenance
    assert mine.entries and all(len(e["alive_channels"]) >= 2 for e in mine.entries.values())


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stepped():
    """One JAX train step of the supernet with the penalty (RMSProp with
    momentum, EMA), so the optimizer buffers and EMA carry history, and the
    same state in the port."""
    jc = jax_config_from_dict({
        "model": {"arch": "atomnas_supernet", "num_classes": 4, "dropout": 0.0, "block_specs": list(SPECS)},
        "optim": {"optimizer": "rmsprop"},
        "schedule": {"schedule": "constant", "base_lr": 0.01, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": True, "decay": 0.9, "warmup": False},
        "train": {"compute_dtype": "float32"},
        "prune": {"enable": True},
    })
    jnet, pnet = _nets()
    jp, _ = _params(jnet, seed=6)
    lr = jsched.make_lr_schedule(jc.schedule, 8, 1, 10)
    opt = joptim.make_optimizer(jc.optim, lr, jp)
    ts = jsteps.init_train_state(jnet, jc, opt, jax.random.PRNGKey(0))
    ts = ts.replace(params=jp, opt_state=opt.init(jp), ema_params=jax.tree.map(jnp.copy, jp),
                    masks=jmasking.init_masks(jnet))
    step = jax.jit(jsteps.make_train_step(jnet, jc, opt, lr, penalty_fn=jpenalty.make_penalty_fn(jnet, jc.prune)))
    x = np.random.RandomState(7).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    ts, _ = step(ts, {"image": jnp.asarray(x), "label": jnp.arange(4) % 4}, jax.random.PRNGKey(2))
    return jnet, pnet, ts, convert.train_state_from_jax(ts), x


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


def test_rematerialize_matches_jax_exactly(stepped):
    """tests/test_nas.py:125's case, a dropped residual block (2) and a
    dropped k=5 branch (block 3): the same new spec, params, BN state,
    optimizer buffers and EMA as the JAX package's, bit for bit, in both
    directions of models/convert.py."""
    jnet, pnet, jts, pts, _ = stepped
    masks = _random_masks(jnet, np.random.RandomState(0), kill_all_block=2, kill_branch=(3, 1))
    jm, pm = _masks_both(masks)
    jout = jremat.rematerialize(jnet, jts.params, jts.state, jm, opt_state=jts.opt_state,
                                ema_params=jts.ema_params, ema_state=jts.ema_state)
    pout = rematerialize.rematerialize(pnet, pts.params, pts.state, pm, opt_state=pts.opt_state,
                                       ema_params=pts.ema_params, ema_state=pts.ema_state)
    (jnew, jp, js, jmasks, jx, jrep), (pnew, pp, ps, pmasks, px, prep) = jout, pout
    assert network_to_dict(pnew) == jax_network_to_dict(jnew)
    assert dataclasses.asdict(prep) == dataclasses.asdict(jrep)
    assert prep.dropped_blocks == [2] and 5 in prep.dropped_branches[3]
    _same_masks(jmasks, pmasks)
    # port -> JAX layouts, leaf by leaf against the JAX package's slices
    new_pts = pts.replace(params=pp, state=ps, opt_state=px["opt_state"], ema_params=px["ema_params"],
                          ema_state=px["ema_state"], masks=pmasks)
    carried = convert.train_state_to_jax(new_pts, jx["opt_state"])
    want = {"params": jp, "state": js, "opt_state": jx["opt_state"], "ema_params": jx["ema_params"],
            "ema_state": jx["ema_state"]}
    for field, tree in want.items():
        assert jax.tree.structure(jax.tree.map(np.asarray, tree)) == jax.tree.structure(carried[field]), field
        for a, b in zip(_jax_leaves(tree), _jax_leaves(carried[field])):
            np.testing.assert_array_equal(b, a, err_msg=field)
    # JAX -> port: the JAX package's sliced state carried in equals the port's
    back = convert.train_state_from_jax(jsteps.TrainState(
        step=jts.step, params=jp, state=js, opt_state=jx["opt_state"], ema_params=jx["ema_params"],
        ema_state=jx["ema_state"], masks=jmasks, rho_mult=jts.rho_mult))
    for field in ("params", "state", "opt_state", "ema_params", "ema_state"):
        mine = convert.flatten_tree(getattr(new_pts, field))
        assert sorted(mine) == sorted(convert.flatten_tree(getattr(back, field))), field
        for k, v in convert.flatten_tree(getattr(back, field)).items():
            assert torch.equal(mine[k], v), (field, k)
    # the history survives: count kept, nu not reset to its initial 1
    assert int(px["opt_state"]["count"]) == 1
    assert not torch.all(px["opt_state"]["nu"]["blocks"]["2"]["dw_bn"]["gamma"] == 1.0)


def test_masked_forward_equals_rematerialized_forward(stepped):
    jnet, pnet, _, pts, x = stepped
    masks = _random_masks(jnet, np.random.RandomState(0), kill_all_block=2, kill_branch=(3, 1))
    _, pm = _masks_both(masks)
    new_net, new_p, new_s, _, _, _ = rematerialize.rematerialize(pnet, pts.params, pts.state, pm)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        masked = pnet.apply(pts.params, pts.state, xt, masks={int(k): v for k, v in pm.items()})
        rebuilt = new_net.apply(new_p, new_s, xt)
    np.testing.assert_allclose(rebuilt.numpy(), masked.numpy(), rtol=RTOL, atol=ATOL)
    assert float(masked.abs().max()) > 1e-3
    assert masked_macs(pnet, {int(k): v for k, v in masks.items()}) == pytest.approx(
        profile_network(new_net).total_macs, rel=1e-12)
    assert len(new_net.blocks) == len(pnet.blocks) - 1


def test_rematerialize_refuses_an_all_dead_block_without_residual(stepped):
    jnet, pnet, jts, pts, _ = stepped
    masks = _random_masks(jnet, np.random.RandomState(0))
    masks["1"][:] = 0.0  # block 1: stride 2, no residual
    jm, pm = _masks_both(masks)
    with pytest.raises(ValueError, match="all-dead mask"):
        jremat.rematerialize(jnet, jts.params, jts.state, jm)
    with pytest.raises(ValueError, match="all-dead mask"):
        rematerialize.rematerialize(pnet, pts.params, pts.state, pm)


def test_map_params_shaped_finds_the_optimizer_buffers(stepped):
    _, _, _, pts, _ = stepped
    structure = treeutil.tree_structure(pts.params)
    seen = []
    out = treeutil.map_params_shaped(pts.opt_state, structure, lambda t: seen.append(t) or "sliced")
    assert out == {"count": pts.opt_state["count"], "nu": "sliced", "trace": "sliced"}
    assert len(seen) == 2
    assert treeutil.map_params_shaped([pts.params, 3], structure, lambda t: "p") == ["p", 3]


def test_convert_bridges_masks_and_rho_mult_both_ways(stepped):
    jnet, _, jts, _, _ = stepped
    masks = _random_masks(jnet, np.random.RandomState(3))
    jts = jts.replace(masks={k: jnp.asarray(v) for k, v in masks.items()}, rho_mult=jnp.asarray(1.05, jnp.float32))
    pts = convert.train_state_from_jax(jts)
    _same_masks(jts.masks, pts.masks)
    assert pts.rho_mult.dtype == torch.float32 and float(pts.rho_mult) == pytest.approx(1.05, rel=1e-7)
    back = convert.train_state_to_jax(pts, jts.opt_state)
    for k, v in masks.items():
        np.testing.assert_array_equal(back["masks"][k], v)
    assert back["rho_mult"] == np.float32(1.05)

"""The port's training CLI (cli/train.py), its device-side fake data
(data/pipeline.py), the TrainState bridge (models/convert.py) and the
device of the int8 calibration, on the CPU.

``run(cfg, device="cpu")`` takes a few steps of a tiny net on fake data and
returns a finite summary and checkpoints; every knob the port does not run
yet is refused with a ValueError that names its ROADMAP entry; without a
device the entry points ask for the card, which this machine lacks, and
raise. Resume, preemption, warm starts and eval-only runs are in
tests/test_torch_port_preempt.py and tests/test_torch_port_ckpt.py.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
from yet_another_mobilenet_series_tpu.data import pipeline as jax_pipeline
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.train import optim as joptim, schedules as jsched, steps as jsteps
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import DataConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.data import pipeline
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.serve import export, quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "mobilenet_v3_large.yml")
# the shipped config cut to a tiny size: the widths, image size, class
# count and dataset sizes are the knobs that shrink; optimizer, schedule,
# EMA and bf16 stay as shipped
TINY = ["data.dataset=fake", "model.width_mult=0.35", "data.image_size=32", "model.num_classes=10",
        "train.batch_size=8", "data.fake_train_size=48", "data.fake_eval_size=20", "train.eval_batch_size=8",
        "train.epochs=1", "train.log_every=2"]


def _cfg(tmp_path, *extra):
    return parse_cli([f"app:{APP}", *TINY, f"train.log_dir={tmp_path / 'log'}", *extra])


def test_shipped_config_is_the_jax_one():
    """apps/mobilenet_v3_large.yml and apps/base.yml are copies: the parsed
    configs equal the JAX package's, field by field."""
    from yet_another_mobilenet_series_tpu.config import parse_cli as jax_parse_cli

    jax_app = os.path.join(REPO, "yet_another_mobilenet_series_tpu", "apps", "mobilenet_v3_large.yml")
    mine, theirs = parse_cli([f"app:{APP}"]), jax_parse_cli([f"app:{jax_app}"])
    assert repr(mine) == repr(theirs)


def test_run_trains_a_tiny_net_on_the_cpu(tmp_path):
    cfg = _cfg(tmp_path, "train.guard.enable=true")
    out = train_cli.run(cfg, device="cpu")
    assert out["device"] == "cpu"
    assert out["steps"] == out["step"] == 6 == out["finite_steps"]  # 48 // 8 steps, every one finite
    assert out["skipped_steps"] == 0
    assert out["eval_n"] == 20 and 0.0 <= out["eval_top1"] <= out["eval_top5"] <= 1.0
    assert np.isfinite(out["eval_loss"])
    assert [s["step"] for s in out["log"]] == [2, 4, 6]
    assert all(np.isfinite(s["loss"]) and s["lr"] > 0 for s in out["log"])
    # one epoch: the final checkpoint, at the last step, in log_dir/ckpt
    assert out["checkpoints"] == [6] and out["resumed_from"] is None and out["preempted"] is False
    log_dir = tmp_path / "log"
    assert sorted(os.listdir(log_dir / "ckpt")) == ["6", "digests.json"]
    rows = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r] == [2, 4, 6]
    assert (log_dir / "obs_registry.json").exists()


def test_run_with_a_synthetic_loader_and_fp32(tmp_path):
    cfg = _cfg(tmp_path, "data.loader=synthetic", "train.compute_dtype=float32", "train.bn_mode=fused_vjp",
               "ema.enable=false", "train.epochs=0.5")
    out = train_cli.run(cfg, device="cpu")
    assert out["steps"] == 3 and out["finite_steps"] == 3 and out["eval_n"] == 20


def test_main_parses_device_cpu(tmp_path, capsys):
    out = train_cli.main([f"app:{APP}", *TINY, f"train.log_dir={tmp_path / 'log'}", "train.epochs=0.5",
                          "--device", "cpu"])
    assert out["steps"] == 3 and out["device"] == "cpu"
    first = capsys.readouterr().out.splitlines()[0]
    assert "device: cpu" in first and f"checkpoints in {tmp_path / 'log'}/ckpt every 1.0 epochs" in first


def test_run_without_a_device_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.run(_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pipeline.FakeImages(DataConfig(dataset="fake", image_size=8, fake_num_classes=2))


# data parallel, the grouped step and the replica check (item 8) run since
# they were ported: tests/test_torch_port_parallel.py and
# tests/test_torch_port_grouped.py drive them
REFUSALS = [
    ("train.tuning_file=/nowhere.json", "item 12"),
]


@pytest.mark.parametrize("override,entry", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_unported_knobs_are_refused_with_their_roadmap_entry(tmp_path, override, entry):
    with pytest.raises(ValueError, match=f"ROADMAP queue 1, {entry}"):
        train_cli.run(_cfg(tmp_path, override), device="cpu")


# item 10 (the real-data input path and the profiler window) is ported:
# its knobs now reach the data dispatch and the loop, and fail there only
# as the JAX package's do (tests/test_torch_port_data.py drives them)
ITEM10 = [
    ("train.profile_start_step=5", None, None),
    ("data.dataset=imagenet", FileNotFoundError, "no TFRecord shards"),
    ("data.loader=native", ValueError, "unsupported data config"),
]


@pytest.mark.parametrize("override,error,match", ITEM10, ids=[r[0] for r in ITEM10])
def test_item10_knobs_reach_the_data_path(tmp_path, override, error, match):
    if error is None:
        out = train_cli.run(_cfg(tmp_path, override), device="cpu")
        assert out["profile"] is not None and os.path.exists(out["profile"]["path"]), out["profile"]
    else:
        with pytest.raises(error, match=match):
            train_cli.run(_cfg(tmp_path, override, f"data.data_dir={tmp_path}"), device="cpu")


def test_resume_from_an_existing_checkpoint_is_refused(tmp_path):
    """A checkpoint dir whose only step does not restore is refused by
    resume (it never restarts from zero over checkpoints); with
    train.resume=false the run starts fresh."""
    ckpt = tmp_path / "log" / "ckpt"
    ckpt.mkdir(parents=True)
    (ckpt / "100").mkdir()
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        train_cli.run(_cfg(tmp_path), device="cpu")
    out = train_cli.run(_cfg(tmp_path, "train.resume=false", "train.epochs=0.5"), device="cpu")
    assert out["steps"] == 3 and out["resumed_from"] is None


def test_fake_templates_and_labels_equal_the_jax_ones():
    """The templates are the JAX package's draw: each JAX eval image minus
    the port's template of its label is exactly the JAX noise
    (0.3 * tf.random.stateless_normal of the image's index), and the labels
    come in the same order."""
    import tensorflow as tf

    cfg = DataConfig(dataset="fake", image_size=8, fake_num_classes=5, fake_eval_size=12)
    fake = pipeline.FakeImages(cfg, device="cpu")
    np.testing.assert_array_equal(fake.templates.numpy(),
                                  np.random.RandomState(777).normal(0, 1, (5, 8, 8, 3)).astype(np.float32))
    jax_eval = list(jax_pipeline.as_numpy(jax_pipeline._fake_dataset(cfg, 4, seed=0, train=False)))
    mine = list(fake.eval_batches(4))
    assert len(mine) == len(jax_eval) == 3
    for i, (a, b) in enumerate(zip(mine, jax_eval)):
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
        for r, label in enumerate(b["label"]):
            idx = 4 * i + r
            noise = tf.random.stateless_normal((8, 8, 3), seed=tf.constant([987654, idx], tf.int64)).numpy()
            np.testing.assert_allclose(b["image"][r] - fake.templates[label].numpy(), 0.3 * noise, atol=1e-6)
    # the port's own noise is of the same scale
    resid = mine[0]["image"] - fake.templates[mine[0]["label"].long()]
    assert 0.25 < float(resid.std()) < 0.35


def test_fake_train_stream_visits_every_index_once_per_epoch():
    cfg = DataConfig(dataset="fake", image_size=4, fake_num_classes=3, fake_train_size=10, fake_eval_size=10)
    fake = pipeline.FakeImages(cfg, device="cpu")
    labels = []
    stream = fake.train_batches(4, seed=0)
    for _ in range(5):  # 20 rows: two epochs, batches running across the boundary
        b = next(stream)
        assert b["image"].shape == (4, 4, 4, 3) and b["label"].dtype == torch.int32
        labels += b["label"].tolist()
    counts = np.bincount(labels, minlength=3)
    assert counts.tolist() == [8, 6, 6]  # indices 0..9 twice, labels idx % 3
    pad = list(fake.eval_batches(8))
    assert pad[-1]["label"].tolist()[-6:] == [-1] * 6


def _numpy_hash32(x):
    m = np.uint64(0xFFFFFFFF)
    x = x.astype(np.uint64) & m
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x21F0AAAD)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x735A2D97)) & m
    return x ^ (x >> np.uint64(15))


def test_fake_eval_noise_is_the_integer_hash_at_every_batch_size():
    """The eval images' noise, written again in numpy's unsigned integers:
    bit for bit the port's (so the int64 arithmetic is exact), of unit
    variance, and the eval set is the same at every batch size."""
    cfg = DataConfig(dataset="fake", image_size=8, fake_num_classes=5, fake_eval_size=13)
    fake = pipeline.FakeImages(cfg, device="cpu")
    per_image = 8 * 8 * 3
    words = _numpy_hash32(np.arange(2 * per_image))
    keys = _numpy_hash32(_numpy_hash32(np.arange(13)) ^ np.uint64(pipeline.EVAL_NOISE_SEED))
    h = _numpy_hash32(words[None, :] ^ keys[:, None])
    total = ((h & np.uint64(0xFFFF)) + (h >> np.uint64(16))).reshape(13, per_image, 2).sum(-1).astype(np.int64)
    noise = ((total - 2 * 0xFFFF).astype(np.float32) * np.float32(1 / np.sqrt((65536.0**2 - 1) / 3)))
    labels = np.arange(13) % 5
    want = fake.templates.numpy()[labels] + np.float32(0.3) * noise.reshape(13, 8, 8, 3)
    for bs in (1, 4, 13, 16):
        got = torch.cat([b["image"][b["label"] >= 0] for b in fake.eval_batches(bs)]).numpy()
        np.testing.assert_array_equal(got, want)
    wide = pipeline.eval_noise(100, 8, (32, 32, 3), torch.device("cpu"))
    assert abs(float(wide.mean())) < 0.02 and abs(float(wide.std()) - 1) < 0.02


def test_fake_data_refusals():
    for kw, match in (({"dataset": "folder"}, "data.make_train_source"), ({"loader": "native"}, "unsupported"),
                      ({"transfer_uint8": True}, "transfer_uint8"), ({"randaugment_layers": 2}, "RandAugment")):
        with pytest.raises(ValueError, match=match):
            pipeline.check(DataConfig(**{"dataset": "fake", **kw}))


def _jax_state(seed=0):
    d = {"model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
                   "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}, {"t": 2, "c": 8, "n": 1, "s": 1, "k": [3, 5]}]},
         "train": {"compute_dtype": "float32"}}
    jc = jax_config_from_dict(d)
    jnet = jax_get_model(jc.model, image_size=16)
    lr = jsched.make_lr_schedule(jc.schedule, 8, 1, 10)
    params, _ = jnet.init(jax.random.PRNGKey(seed))
    jopt = joptim.make_optimizer(jc.optim, lr, params)
    jts = jsteps.init_train_state(jnet, jc, jopt, jax.random.PRNGKey(seed))
    step = jax.jit(jsteps.make_train_step(jnet, jc, jopt, lr))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, 16, 3))
    jts, _ = step(jts, {"image": x, "label": jnp.arange(8) % 4}, jax.random.PRNGKey(2))
    return jts


def test_convert_carries_a_train_state_both_ways():
    """JAX -> port -> JAX is the identity on every field (params, BN state,
    the optimizer's nu/trace/count inside optax's chain tuple, EMA, step),
    and port -> JAX -> port too."""
    jts = _jax_state()
    pts = convert.train_state_from_jax(jts)
    assert int(pts.step) == 1 and int(pts.opt_state["count"]) == 1
    assert set(pts.opt_state) == {"count", "nu", "trace"}
    back = convert.train_state_to_jax(pts, jts.opt_state)
    rebuilt = jsteps.TrainState(**back)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(jts)
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt), jax.tree_util.tree_leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = convert.train_state_from_jax(back)
    for field in ("params", "state", "opt_state", "ema_params", "ema_state"):
        for k, v in convert.flatten_tree(getattr(pts, field)).items():
            assert torch.equal(convert.flatten_tree(getattr(again, field))[k], v), (field, k)
    # a depthwise kernel changed layout on the way in: (k, k, 1, C) -> (C, 1, k, k)
    assert tuple(pts.params["blocks"]["1"]["dw1_k5"]["w"].shape)[1:] == (1, 5, 5)
    assert tuple(pts.opt_state["nu"]["blocks"]["1"]["dw1_k5"]["w"].shape)[1:] == (1, 5, 5)


def test_int8_calibration_runs_on_the_device_it_is_given(tmp_path, monkeypatch):
    net = get_model(parse_cli(["model.arch=mobilenet_v3_small", "model.width_mult=0.35",
                               "model.num_classes=10"]).model, image_size=24)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    calib = np.random.RandomState(1).normal(0, 1, (4, 24, 24, 3)).astype(np.float32)
    seen = []
    real = export.apply_folded

    def spy(net_, params_, x, **kw):
        seen.append((x.device.type, next(iter(convert.flatten_tree(params_).values())).device.type))
        return real(net_, params_, x, **kw)

    monkeypatch.setattr(export, "apply_folded", spy)
    out = export.export_bundle(net, params, state, str(tmp_path / "b"), quant_weights="int8", calib_images=calib,
                               int8_top1_min=0.0, device="cpu")
    assert seen == [("cpu", "cpu")] * 2  # the f32 and the int8 forward
    assert export.load_bundle(out).quant["calib"]["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            export.export_bundle(net, params, state, str(tmp_path / "c"), quant_weights="int8", calib_images=calib,
                                 int8_top1_min=0.0)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            quant.calibrate_and_quantize(net, convert.unflatten_tree(convert.to_jax(export.fold_network(
                net, params, state))), calib)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            export.prepare_folded(net, export.fold_network(net, params, state))
    # a float32 export does no device work and needs none
    export.export_bundle(net, params, state, str(tmp_path / "f"))

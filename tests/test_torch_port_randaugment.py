"""The port's RandAugment (``data/randaugment.py``, torch, on the device)
against the JAX package's TensorFlow ops, on the CPU: every op at
magnitudes 0, 5 and 10 (both signs for the signed ones) on two images,
the position-keyed draws, the grouped batch against per-image application,
the validation, and the device stage behind the TFRecord train stream.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from yet_another_mobilenet_series_tpu.data import pipeline as jax_pipeline
from yet_another_mobilenet_series_tpu.data import randaugment as jra

from yet_another_mobilenet_series_tpu_torch import data as port_data
from yet_another_mobilenet_series_tpu_torch.config import DataConfig
from yet_another_mobilenet_series_tpu_torch.data import jpeg, randaugment as ra, tfrecord

MAGNITUDES = (0, 5, 10)
SIGNED = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
# The geometric ops pick a source pixel by rounding float32 coordinates; an
# ulp of difference in cos/sin or in the coordinate arithmetic can move a
# pick at an exact .5. Held to at most 0.5% of the pixels differing (measured
# on these images: none differ). Every other op must be exact.
GEOMETRIC_MISMATCH = 0.005


def _images():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (37, 45, 3)).astype(np.uint8),
            np.clip(rng.normal(120, 40, (40, 33, 3)), 0, 255).astype(np.uint8)]


def _tf_op(tf, name, img, m, sign):
    t = tf.constant(img)
    mm = m / 10.0
    enh = ra.enhance_factor(m)
    signed = np.float32(sign) * np.float32(mm)
    return {
        "autocontrast": lambda: jra._autocontrast(tf, t),
        "equalize": lambda: jra._equalize(tf, t),
        "invert": lambda: jra._invert(tf, t),
        "rotate": lambda: jra._rotate(tf, t, tf.constant(signed * np.float32(30.0))),
        "posterize": lambda: jra._posterize(tf, t, int(mm * 4)),
        "solarize": lambda: jra._solarize(tf, t, int(mm * 256)),
        "color": lambda: jra._color(tf, t, enh),
        "contrast": lambda: jra._contrast(tf, t, enh),
        "brightness": lambda: jra._brightness(tf, t, enh),
        "sharpness": lambda: jra._sharpness(tf, t, enh),
        "shear_x": lambda: jra._shear_x(tf, t, tf.constant(signed * np.float32(0.3))),
        "shear_y": lambda: jra._shear_y(tf, t, tf.constant(signed * np.float32(0.3))),
        "translate_x": lambda: jra._translate_x(tf, t, tf.constant(signed * np.float32(100.0))),
        "translate_y": lambda: jra._translate_y(tf, t, tf.constant(signed * np.float32(100.0))),
        "solarize_add": lambda: jra._solarize_add(tf, t, int(mm * 110)),
    }[name]()


OP_CASES = [(name, m, sign) for name in ra.OPS if name != "cutout" for m in MAGNITUDES
            for sign in ((1.0, -1.0) if name in SIGNED else (1.0,))]


@pytest.mark.parametrize("name,m,sign", OP_CASES, ids=[f"{n}-m{m}-{'neg' if s < 0 else 'pos'}"
                                                      for n, m, s in OP_CASES])
def test_each_op_matches_the_tf_op(name, m, sign):
    tf = jax_pipeline._tf_mod()
    op = ra.OPS.index(name)
    for img in _images():
        h, w, _ = img.shape
        d = {"sign": np.array([sign], np.float32), "cy": np.array([0]), "cx": np.array([0])}
        params = torch.from_numpy(ra.op_params(op, d, float(m), h, w))
        got = ra.apply_op(torch.from_numpy(img)[None], op, float(m), params)[0].numpy()
        want = np.asarray(_tf_op(tf, name, img, m, sign))
        assert got.dtype == np.uint8 and got.shape == want.shape
        if name in SIGNED:
            assert (got != want).any(axis=-1).mean() <= GEOMETRIC_MISMATCH
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", MAGNITUDES)
def test_cutout_matches_the_tf_op_at_its_centre(m):
    """The JAX package's cutout draws its centre from TF's stateless
    generator; at that centre the port's patch is the same."""
    tf = jax_pipeline._tf_mod()
    seed2 = tf.constant([3, 11 + m], tf.int64)
    for img in _images():
        h, w, _ = img.shape
        want = np.asarray(jra._cutout(tf, tf.constant(img), ra.CUTOUT_CONST, seed2, 20))
        cy = int(tf.random.stateless_uniform([], seed=seed2 + tf.constant([20, 0], tf.int64), minval=0, maxval=h,
                                             dtype=tf.int32))
        cx = int(tf.random.stateless_uniform([], seed=seed2 + tf.constant([21, 0], tf.int64), minval=0, maxval=w,
                                             dtype=tf.int32))
        got = ra.cutout(torch.from_numpy(img)[None], ra.CUTOUT_CONST, torch.tensor([cy]), torch.tensor([cx]))[0]
        np.testing.assert_array_equal(got.numpy(), want)


def test_rand_augment_is_a_pure_function_of_seed_and_positions():
    rng = np.random.RandomState(1)
    batch = torch.from_numpy(rng.randint(0, 256, (6, 48, 40, 3)).astype(np.uint8))
    pos = np.arange(1000, 1006)
    a = ra.rand_augment(batch, pos, 7, 2, 10.0)
    b = ra.rand_augment(batch, pos, 7, 2, 10.0)
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, batch)
    # a row's result depends on its own position, not on its neighbours
    single = ra.rand_augment(batch[2:3], pos[2:3], 7, 2, 10.0)
    assert torch.equal(single[0], a[2])
    other = ra.rand_augment(batch, pos + 100, 7, 2, 10.0)
    assert not torch.equal(other, a)
    assert torch.equal(ra.rand_augment(batch, pos, 8, 0, 10.0), batch)  # no layers, no change


def test_the_grouped_batch_equals_the_ops_applied_image_by_image():
    rng = np.random.RandomState(2)
    batch = torch.from_numpy(rng.randint(0, 256, (24, 30, 34, 3)).astype(np.uint8))
    pos = np.arange(24) * 7 + 3
    got = ra.rand_augment(batch, pos, 5, 2, 9.0)
    for i in range(24):
        x = batch[i:i + 1]
        for layer in range(2):
            d = ra.draws(5, pos[i:i + 1], layer, 30, 34)
            if d["fire"][0]:
                op = int(d["op"][0])
                x = ra.apply_op(x, op, 9.0, torch.from_numpy(ra.op_params(op, d, 9.0, 30, 34)))
        assert torch.equal(got[i], x[0]), i


def test_draws_follow_their_distributions():
    pos = np.arange(20000)
    d = ra.draws(0, pos, 0, 224, 224)
    counts = np.bincount(d["op"], minlength=ra.NUM_OPS)
    assert counts.min() > 0.8 * len(pos) / ra.NUM_OPS and counts.max() < 1.2 * len(pos) / ra.NUM_OPS
    assert abs(d["fire"].mean() - 0.5) < 0.02  # E[U(0.2, 0.8)]
    assert abs((d["sign"] > 0).mean() - 0.5) < 0.02
    assert d["cy"].min() >= 0 and d["cy"].max() == 223
    u = ra.uniform(3, pos, 17)
    assert 0.0 <= u.min() and u.max() < 1.0 and abs(u.mean() - 0.5) < 0.01


def test_randaugment_validation():
    with pytest.raises(ValueError, match="tfdata"):
        port_data._check(DataConfig(dataset="folder", loader="native", data_dir="/nope", randaugment_layers=2))
    with pytest.raises(ValueError, match="randaugment"):
        port_data._check(DataConfig(dataset="imagenet", data_dir="/nope", randaugment_layers=2,
                                    randaugment_magnitude=11))
    with pytest.raises(ValueError, match="randaugment_layers=0"):
        port_data._check(DataConfig(dataset="fake", randaugment_layers=2))
    port_data._check(DataConfig(dataset="imagenet", data_dir="/nope", randaugment_layers=2))


@pytest.mark.parametrize("uint8", [False, True])
def test_the_train_stream_carries_positions_and_the_device_stage_augments(tmp_path, uint8):
    rs = np.random.RandomState(0)
    with tfrecord.TFRecordWriter(str(tmp_path / "train-00000-of-00001")) as w:
        for i in range(12):
            w.write(tfrecord.image_example(jpeg.encode(rs.randint(0, 255, (40, 48, 3), np.uint8), 90), i % 3))
    base = dict(dataset="imagenet", loader="tfdata", data_dir=str(tmp_path), image_size=24, num_train_examples=12,
                decode_threads=2, transfer_uint8=uint8)
    cfg = DataConfig(**base, randaugment_layers=2, randaugment_magnitude=9)

    def take(c, n=3):
        src = port_data.make_train_source(c, 4, 3, device="cpu")
        if c.randaugment_layers:
            src = ra.device_stage(src, c, 3)
        return [b for b in itertools.islice(src, n)]

    x1, x2 = take(cfg), take(cfg)
    plain = take(DataConfig(**base))
    for a, b, p in zip(x1, x2, plain):
        assert set(a) == {"image", "label"} and torch.equal(a["image"], b["image"])
        assert a["image"].dtype == (torch.uint8 if uint8 else torch.float32) == p["image"].dtype
        assert torch.equal(a["label"], p["label"])
    assert any(not torch.equal(a["image"], p["image"]) for a, p in zip(x1, plain))
    # the stage's output is the stream's uint8 crop, augmented, then the host
    # path's normalize expression
    raw = next(iter(port_data.make_train_source(cfg, 4, 3, device="cpu")))
    assert raw["image"].dtype == torch.uint8 and list(raw["pos"]) == [0, 1, 2, 3]
    aug = ra.rand_augment(raw["image"], raw["pos"], 3, 2, 9.0)
    if uint8:
        assert torch.equal(x1[0]["image"], aug)
    else:
        mean, std = torch.tensor(cfg.mean), torch.tensor(cfg.std)
        assert torch.equal(x1[0]["image"], (aug.to(torch.float32) / 255.0 - mean) / std)
    assert os.path.exists(tmp_path / "train-00000-of-00001")

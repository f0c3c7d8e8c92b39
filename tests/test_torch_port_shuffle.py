"""The port's TFRecord train stream mixes records by the law of the JAX
package's default stream (F10): an interleave of ``data.decode_threads``
shards and a record shuffle buffer of ``data.shuffle_buffer`` records, each
epoch's order a function of (seed, epoch), so a resume stays bit for bit.

Shards are written by the port's writer, one label per record, so that a
label names its record. The JAX package's ``make_train_dataset`` is read
through TensorFlow on the CPU; the port's stream through
``data.make_train_source``. The one place the two differ by design: the JAX
buffer runs on across an epoch boundary, the port's drains at each epoch's
end (measured in :func:`test_jax_buffer_carries_records_across_the_epoch_boundary`).
"""

import itertools
import math
import os

import numpy as np
import pytest

from yet_another_mobilenet_series_tpu.config import DataConfig as JaxDataConfig
from yet_another_mobilenet_series_tpu.data import pipeline as jax_pipeline

from yet_another_mobilenet_series_tpu_torch import data as port_data
from yet_another_mobilenet_series_tpu_torch.config import DataConfig
from yet_another_mobilenet_series_tpu_torch.data import jpeg, jpeg_corpus, pipeline, tfrecord

RECORDS, SHARDS = 512, 4  # an epoch of this host
BUFFER = 64
BATCH = 64
SEEDS = (0, 1, 2, 3)
SIZE = 8
# the two-sample Kolmogorov-Smirnov bar at significance ALPHA:
# c(alpha) * sqrt((n + m) / (n * m)), c(alpha) = sqrt(-ln(alpha / 2) / 2)
ALPHA = 0.001
# uneven shards for the interleave: empty ones, one of one record
UNEVEN = (5, 0, 13, 2, 9, 1, 7, 0, 4)


def _cfgs(root, **kw):
    base = dict(dataset="imagenet", loader="tfdata", data_dir=root, image_size=SIZE, transfer_uint8=True,
                num_train_examples=RECORDS, color_jitter=0.0)
    base.update(kw)
    return DataConfig(**base), JaxDataConfig(**base)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """RECORDS records of four tiny JPEGs, record i labelled i, dealt over
    SHARDS shards by the port's writer (record i in shard i % SHARDS)."""
    root = str(tmp_path_factory.mktemp("shuffle"))
    rs = np.random.RandomState(0)
    paths = []
    for k in range(4):
        path = os.path.join(root, f"img{k}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg.encode(rs.randint(0, 255, (16, 16, 3), np.uint8), 90))
        paths.append(path)
    jpeg_corpus.write_tfrecords(root, "train", [(paths[i % 4], i) for i in range(RECORDS)], SHARDS)
    return root


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """Shards of UNEVEN records, labels numbered on from shard to shard."""
    root = str(tmp_path_factory.mktemp("uneven"))
    payload = jpeg.encode(np.random.RandomState(1).randint(0, 255, (16, 16, 3), np.uint8), 90)
    label = 0
    for s, n in enumerate(UNEVEN):
        with tfrecord.TFRecordWriter(os.path.join(root, f"train-{s:05d}-of-{len(UNEVEN):05d}")) as w:
            for _ in range(n):
                w.write(tfrecord.image_example(payload, label))
                label += 1
    return root


def _port_labels(cfg, seed, n, batch=BATCH, start_step=0):
    it = port_data.make_train_source(cfg, batch, seed, start_step=start_step, device="cpu")
    return np.concatenate([b["label"].numpy() for b in itertools.islice(it, -(-n // batch))])[:n]


def _jax_labels(jcfg, seed, n):
    ds = jax_pipeline.make_train_dataset(jcfg, BATCH, seed)
    return np.concatenate([b["label"].numpy() for b in ds.take(-(-n // BATCH))])[:n]


def _displacements(source, out, keep):
    """Output position minus source position of the records at output
    positions ``0 .. keep - 1``; ``source`` lists one epoch's records."""
    where = np.empty(len(source), np.int64)
    where[source] = np.arange(len(source))
    return np.arange(keep) - where[out[:keep]]


def _ks(a, b):
    """The two-sample Kolmogorov-Smirnov statistic."""
    grid = np.union1d(a, b)
    fa = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    fb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.abs(fa - fb).max())


@pytest.fixture(scope="module")
def displacements(corpus):
    """Per package and seed, the displacements of the buffered epoch's first
    RECORDS - BUFFER outputs from the unbuffered source order (cycle 1)."""
    out = {"port": [], "jax": [], "port_full": []}
    for seed in SEEDS:
        det, jdet = _cfgs(corpus, deterministic_input=True)
        buf, jbuf = _cfgs(corpus, decode_threads=1, shuffle_buffer=BUFFER)
        src, got = _port_labels(det, seed, RECORDS), _port_labels(buf, seed, RECORDS)
        out["port"].append(_displacements(src, got, RECORDS - BUFFER))
        out["port_full"].append(_displacements(src, got, RECORDS))
        jsrc, jgot = _jax_labels(jdet, seed, RECORDS), _jax_labels(jbuf, seed, RECORDS)
        assert sorted(jsrc) == list(range(RECORDS))
        out["jax"].append(_displacements(jsrc, jgot, RECORDS - BUFFER))
    return {k: np.concatenate(v) for k, v in out.items()}


def test_buffer_displacements_match_the_jax_stream(displacements):
    """(a) The buffer's law: the port's displacements against the JAX
    stream's, under the same settings and seeds, by the KS statistic."""
    mine, theirs = displacements["port"], displacements["jax"]
    n, m = len(mine), len(theirs)
    bar = math.sqrt(-math.log(ALPHA / 2) / 2) * math.sqrt((n + m) / (n * m))
    d = _ks(mine, theirs)
    print(f"KS statistic {d:.4f} over {n} and {m} displacements, bar {bar:.4f} (alpha {ALPHA}); means "
          f"{mine.mean():.2f} / {theirs.mean():.2f}, spreads {mine.std():.2f} / {theirs.std():.2f}")
    assert d <= bar, (d, bar)
    # the buffer really mixed: displacements of the order of the buffer
    assert theirs.std() > BUFFER / 4 and mine.std() > BUFFER / 4


def test_no_record_leaves_more_than_a_buffer_early(displacements):
    """(b) A record enters the buffer at its source position, so it leaves at
    most BUFFER - 1 positions early, in either package (the port's epoch
    counted whole, through its drain)."""
    for key in ("port", "port_full", "jax"):
        assert displacements[key].min() >= -(BUFFER - 1), key
    assert displacements["port_full"].min() < -(BUFFER // 2)  # the bound is reached, nearly


@pytest.mark.parametrize("cycle", [1, 2, 3, 8])
def test_interleave_order_is_tf_datas(uneven, cycle):
    """(c) The port's cycle-k source order (no buffer) is tf.data's
    deterministic interleave, block length 1, over the same permuted files,
    shards of uneven sizes included (empty ones, one of one record)."""
    tf = jax_pipeline._tf_mod()
    n = sum(UNEVEN)
    cfg, _ = _cfgs(uneven, decode_threads=cycle, shuffle_buffer=1, num_train_examples=n)
    got = _port_labels(cfg, 7, 2 * n, batch=n)
    stream = pipeline.RecordTrainStream(cfg, n, 7)
    try:
        for epoch in (0, 1):
            files = [stream.files[f] for f in stream._epoch(epoch)[0]]
            ds = tf.data.Dataset.from_tensor_slices(files).interleave(
                tf.data.TFRecordDataset, cycle_length=cycle, block_length=1, num_parallel_calls=tf.data.AUTOTUNE,
                deterministic=True)
            want = [tfrecord.parse_image_example(r.numpy())[1] for r in ds]
            assert list(got[epoch * n:(epoch + 1) * n]) == want, epoch
    finally:
        stream.close()


def test_interleave_order_equals_the_iterator_interleave():
    """The array form of the interleave against the port's iterator
    interleave (what the eval stream reads through), on random shapes."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        lengths = rng.integers(0, 7, int(rng.integers(1, 9)))
        cycle = int(rng.integers(1, 6))
        starts = np.cumsum(lengths) - lengths
        want = list(pipeline.interleave([iter(range(s, s + n)) for s, n in zip(starts, lengths)], cycle))
        assert list(pipeline.interleave_order(lengths, cycle)) == want, (lengths, cycle)


def test_shuffle_order_is_the_buffer_loop():
    """The array form of the buffer against the buffer itself: each output a
    draw of a slot, the next source record into the drawn slot, the drain
    in random order, with the same draws."""
    for seed in range(60):
        r = np.random.default_rng(seed)
        n, b = int(r.integers(0, 50)), int(r.integers(1, 70))
        source = r.permutation(1000)[:n]
        got = pipeline.shuffle_order(source, b, np.random.default_rng(seed + 100))
        draws = np.random.default_rng(seed + 100)
        held = min(b, n)
        slots = draws.integers(0, held, size=n - held)
        buf, want = list(source[:held]), []
        for i, j in enumerate(slots):
            want.append(buf[j])
            buf[j] = source[held + i]
        want += [buf[k] for k in draws.permutation(held)]
        assert list(got) == want, seed


def test_every_record_once_per_epoch(corpus):
    """(d) The default stream (interleave of 3, buffer BUFFER) reads every
    record once an epoch, in another order each epoch."""
    cfg, _ = _cfgs(corpus, decode_threads=3, shuffle_buffer=BUFFER)
    got = _port_labels(cfg, 5, 3 * RECORDS)
    epochs = [got[e * RECORDS:(e + 1) * RECORDS] for e in range(3)]
    for labels in epochs:
        assert sorted(labels) == list(range(RECORDS))
    assert not np.array_equal(epochs[0], epochs[1]) and not np.array_equal(epochs[1], epochs[2])


@pytest.mark.parametrize("start_step", [5, 10, 13])
def test_resume_is_bit_for_bit_with_the_buffer(corpus, start_step):
    """(e) make_train_source(start_step=k) equals the uninterrupted buffered
    stream: mid-epoch (5), a batch that straddles the epoch boundary (10:
    records 480-527 of 512 an epoch) and in the next epoch (13)."""
    cfg, _ = _cfgs(corpus, decode_threads=3, shuffle_buffer=BUFFER)
    batch, steps = 48, 16
    full = list(itertools.islice(port_data.make_train_source(cfg, batch, 9, device="cpu"), steps))
    resumed = list(itertools.islice(port_data.make_train_source(cfg, batch, 9, start_step=start_step, device="cpu"),
                                    steps - start_step))
    for a, b in zip(full[start_step:], resumed, strict=True):
        np.testing.assert_array_equal(a["image"].numpy(), b["image"].numpy())
        np.testing.assert_array_equal(a["label"].numpy(), b["label"].numpy())


def _unbuffered_labels(root, seed, epochs):
    """The stream as it was before the buffer: each epoch's (seed, epoch)
    shard permutation read back to back, independently of the port's code."""
    files = tfrecord._tfrecord_files(DataConfig(dataset="imagenet", data_dir=root), "train")
    labels = [[tfrecord.parse_image_example(r)[1] for r in tfrecord.iter_records(f)] for f in files]
    out = []
    for e in range(epochs):
        order = np.random.default_rng(pipeline.stream_seed(pipeline.FILE_ORDER_SALT, seed, e)).permutation(len(files))
        out += [x for f in order for x in labels[f]]
    return np.asarray(out)


def test_deterministic_input_and_a_buffer_of_one_keep_the_old_stream(corpus):
    """(f) data.deterministic_input=true, and decode_threads=1 with
    shuffle_buffer=1, each give the stream of before the buffer: the shards
    back to back, the same crops at the same positions."""
    want = _unbuffered_labels(corpus, 4, 2)
    batches = {}
    for tag, kw in (("deterministic", {"deterministic_input": True}),
                    ("buffer of one", {"decode_threads": 1, "shuffle_buffer": 1})):
        cfg, _ = _cfgs(corpus, **kw)
        batches[tag] = list(itertools.islice(port_data.make_train_source(cfg, BATCH, 4, device="cpu"),
                                             2 * RECORDS // BATCH))
        got = np.concatenate([b["label"].numpy() for b in batches[tag]])
        np.testing.assert_array_equal(got, want, err_msg=tag)
    for a, b in zip(batches["deterministic"], batches["buffer of one"]):
        np.testing.assert_array_equal(a["image"].numpy(), b["image"].numpy())


def test_jax_buffer_carries_records_across_the_epoch_boundary(corpus):
    """(g) The documented difference: the JAX stream's buffer runs across
    epochs, so records of one epoch come out in the next; the port's drains
    at each epoch's end, so none does."""
    fractions = []
    for seed in SEEDS:
        _, jbuf = _cfgs(corpus, decode_threads=1, shuffle_buffer=BUFFER)
        first = _jax_labels(jbuf, seed, RECORDS)
        fractions.append((RECORDS - len(np.unique(first))) / RECORDS)
        cfg, _ = _cfgs(corpus, decode_threads=1, shuffle_buffer=BUFFER)
        assert len(np.unique(_port_labels(cfg, seed, RECORDS))) == RECORDS
    mean = float(np.mean(fractions))
    print(f"JAX stream: {mean:.4f} of an epoch's {RECORDS} records cross into the next epoch at buffer {BUFFER} "
          f"({mean * RECORDS / BUFFER:.3f} buffers; per seed {fractions})")
    assert 0 < mean < BUFFER / RECORDS

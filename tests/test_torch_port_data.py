"""The port's real-data input path against the JAX package's, on the CPU:
image folders through the port's copy of the native loader (bit for bit
with the JAX package's loader), TFRecord shards read and written without
TensorFlow (held to TensorFlow both ways), their counts, eval pixels and
resume, the prefetch thread, ``cli/profile.py`` and a tiny ``cli/train.py``
run from a folder.

Images are written with PIL into ``tmp_path``; the card-only half (the
nvJPEG build) runs in ``chip_smoke.py`` phase 13.
"""

import contextlib
import io
import itertools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

from yet_another_mobilenet_series_tpu.cli import profile as jax_profile_cli
from yet_another_mobilenet_series_tpu.cli import train as jax_train_cli
from yet_another_mobilenet_series_tpu.config import DataConfig as JaxDataConfig
from yet_another_mobilenet_series_tpu.data import make_eval_source as jax_make_eval_source
from yet_another_mobilenet_series_tpu.data import make_train_source as jax_make_train_source
from yet_another_mobilenet_series_tpu.data import native_loader as jax_native_loader
from yet_another_mobilenet_series_tpu.data import pipeline as jax_pipeline

from yet_another_mobilenet_series_tpu_torch import data as port_data
from yet_another_mobilenet_series_tpu_torch.cli import profile as port_profile_cli
from yet_another_mobilenet_series_tpu_torch.cli import train as port_train_cli
from yet_another_mobilenet_series_tpu_torch.config import DataConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.data import jpeg, jpeg_corpus, native_loader, pipeline, tfrecord
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.ops import host_build
from yet_another_mobilenet_series_tpu_torch.utils.treeutil import flatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps")
JAX_APPS = os.path.join(REPO, "yet_another_mobilenet_series_tpu", "apps")
CLASSES = 3
PER_CLASS = {"train": 6, "val": 5}
SIZE, RESIZE = 16, 18
# Eval pixels of the port's TFRecord path (the native loader's eval transform:
# a DCT-scaled decode where it applies, one bilinear pass from the source rect
# of the centre crop) against the JAX package's tf.data eval (a full decode,
# a bilinear resize of the whole image, then the crop), on these smooth
# images, uint8 pixel levels. Measured on the CPU (libjpeg-turbo 2.1.5,
# TensorFlow 2.21): max 13, mean 1.73 over the val set, for 1 and 2 hosts;
# held to 20 and 2.5.
EVAL_PIXEL_MAX, EVAL_PIXEL_MEAN = 20.0, 2.5


def _smooth(rng, h, w, level):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([level + 60 * np.sin(x / 7.0), level + 60 * np.cos(y / 5.0), level + 40 * np.sin((x + y) / 9.0)],
                    -1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{train,val}/class_<k>/<i>.jpg written by PIL, and the same val
    images as two TFRecord shards written by the port."""
    root = str(tmp_path_factory.mktemp("jpegs"))
    rng = np.random.RandomState(0)
    items = {}
    for split, n in PER_CLASS.items():
        items[split] = []
        for k in range(CLASSES):
            d = os.path.join(root, split, f"class_{k}")
            os.makedirs(d)
            for i in range(n):
                h, w = [(30, 40), (44, 36), (36, 52)][(k + i) % 3]
                path = os.path.join(d, f"{i}.jpg")
                Image.fromarray(_smooth(rng, h, w, 60 + 50 * k)).save(path, quality=92)
                items[split].append((path, k))
    jpeg_corpus.write_tfrecords(root, "val", items["val"], 2)
    jpeg_corpus.write_tfrecords(root, "train", items["train"], 3)
    return root, items


def _cfg(root, **kw):
    base = dict(dataset="folder", loader="native", data_dir=root, val_split="val", image_size=SIZE,
                eval_resize=RESIZE, decode_threads=2, color_jitter=0.3, num_train_examples=18, num_eval_examples=15)
    base.update(kw)
    return DataConfig(**base), JaxDataConfig(**base)


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# image folders: the port's native loader against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("uint8", [False, True])
def test_folder_train_batches_equal_the_jax_loader(tree, start_step, ranks, uint8):
    root, _ = tree
    cfg, jcfg = _cfg(root, transfer_uint8=uint8)
    for rank in range(ranks):
        mine = port_data.make_train_source(cfg, 4, 7, rank, ranks, start_step=start_step, device="cpu")
        theirs = jax_make_train_source(jcfg, 4, 7, rank, ranks, start_step=start_step)
        for a, b in itertools.islice(zip(mine, theirs), 5):
            a = _np(a)
            assert a["image"].dtype == (np.uint8 if uint8 else np.float32)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("uint8", [False, True])
def test_folder_eval_pass_equals_the_jax_loader_with_its_padding(tree, ranks, uint8):
    root, items = tree
    cfg, jcfg = _cfg(root, transfer_uint8=uint8)
    seen = []
    for rank in range(ranks):
        mine = [_np(b) for b in port_data.make_eval_source(cfg, 4, rank, ranks, device="cpu")]
        theirs = list(jax_make_eval_source(jcfg, 4, rank, ranks))
        assert len(mine) == len(theirs) == -(-(-(-15 // ranks)) // 4)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
        seen += [int(v) for b in mine for v in b["label"] if v >= 0]
    assert sorted(seen) == sorted(k for _, k in items["val"])  # every example once


def test_corrupt_jpeg_is_masked_in_eval_and_resampled_in_train(tree, tmp_path):
    root, _ = tree
    bad_root = str(tmp_path / "bad")
    for split in ("train", "val"):
        d = os.path.join(bad_root, split, "class_0")
        os.makedirs(d)
        for i in range(4):
            Image.fromarray(np.full((24, 24, 3), 40 * i, np.uint8)).save(os.path.join(d, f"{i}.jpg"))
        with open(os.path.join(d, "9_bad.jpg"), "wb") as f:
            f.write(b"definitely not a jpeg")
    cfg, jcfg = _cfg(bad_root)
    mine = [_np(b) for b in port_data.make_eval_source(cfg, 5, device="cpu")]
    theirs = list(jax_make_eval_source(jcfg, 5))
    assert [list(b["label"]) for b in mine] == [list(b["label"]) for b in theirs] == [[0, 0, 0, 0, -1]]
    a = native_loader.make_native_train_iter(cfg, 5, 3)
    b = jax_native_loader.make_native_train_iter(jcfg, 5, 3)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(x["image"], y["image"])
        assert (x["label"] == 0).all()  # the corrupt file's draws landed on real images
    # the rings decode ahead until they are full (the same depth for both):
    # the counts agree once both have stopped
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        counts = (a.decode_failures, b.decode_failures)
        time.sleep(0.2)
        if counts == (a.decode_failures, b.decode_failures) and counts[0] == counts[1]:
            break
    assert a.decode_failures == b.decode_failures > 0
    assert native_loader.total_decode_failures() >= a.decode_failures
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------


def test_tensorflow_and_the_port_read_each_others_shards(tree, tmp_path):
    tf = jax_pipeline._tf_mod()
    root, items = tree
    payloads = [(open(p, "rb").read(), k) for p, k in items["val"]]
    # TF writes, the port reads
    path = str(tmp_path / "tf-00000-of-00001")
    with tf.io.TFRecordWriter(path) as w:
        for data, k in payloads:
            w.write(tf.train.Example(features=tf.train.Features(feature={
                "image/encoded": tf.train.Feature(bytes_list=tf.train.BytesList(value=[data])),
                "image/class/label": tf.train.Feature(int64_list=tf.train.Int64List(value=[k + 1])),
            })).SerializeToString())
    assert [tfrecord.parse_image_example(r) for r in tfrecord.iter_records(path)] == payloads
    # the port writes (the fixture's shards), TF reads
    shards = sorted(os.path.join(root, f) for f in os.listdir(root) if f.startswith("val-"))
    feats = {"image/encoded": tf.io.FixedLenFeature([], tf.string),
             "image/class/label": tf.io.FixedLenFeature([], tf.int64)}
    got = [tf.io.parse_single_example(r, feats) for r in tf.data.TFRecordDataset(shards)]
    # the writer deals the items round-robin over its two shards
    assert [(g["image/encoded"].numpy(), int(g["image/class/label"]) - 1) for g in got] == payloads[::2] + payloads[1::2]
    # a signed and a multi-valued feature, both ways
    ex = tfrecord.build_example({"a": [-3, 0, 2**40], "b": [b"x", b""]})
    parsed = tf.io.parse_single_example(ex, {"a": tf.io.FixedLenFeature([3], tf.int64),
                                             "b": tf.io.FixedLenFeature([2], tf.string)})
    assert list(parsed["a"].numpy()) == [-3, 0, 2**40] and list(parsed["b"].numpy()) == [b"x", b""]
    assert tfrecord.parse_example(ex) == {"a": [-3, 0, 2**40], "b": [b"x", b""]}


def test_crc32c_is_the_castagnoli_crc():
    """The host library's CRC (hardware or table) against the bitwise
    definition; TensorFlow reading the port's shards checks the masking."""
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3, bytes(range(7))):
        assert tfrecord.crc32c(data) == _crc32c_reference(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def _crc32c_reference(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def test_a_torn_or_rewritten_record_fails_its_crc(tmp_path):
    path = str(tmp_path / "x-00000-of-00001")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"hello")
        w.write(b"world")
    raw = bytearray(open(path, "rb").read())
    raw[12] ^= 0xFF  # the first record's first data byte
    open(path, "wb").write(bytes(raw))
    it = tfrecord.iter_records(path)
    with pytest.raises(tfrecord.CorruptRecord, match="data CRC"):
        next(it)
    open(path, "wb").write(bytes(raw[:-3]))
    with pytest.raises(tfrecord.CorruptRecord, match="overruns"):
        tfrecord.record_index(path)


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_counts_equal_the_jax_functions(tree, hosts):
    root, _ = tree
    cfg, jcfg = _cfg(root, dataset="imagenet", loader="tfdata")
    files = tfrecord._tfrecord_files(cfg, "train")
    assert files == jax_pipeline._tfrecord_files(jcfg, "train")
    assert [tfrecord._count_tfrecord_records(f) for f in files] == [jax_pipeline._count_tfrecord_records(f)
                                                                   for f in files]
    for h in range(hosts):
        host_files = files[h::hosts]
        assert (tfrecord._host_records_per_epoch(cfg, host_files, files)
                == jax_pipeline._host_records_per_epoch(jcfg, host_files, files))
        for batch in (1, 4, 7):
            assert (pipeline.eval_batches_per_host(cfg, batch, hosts)
                    == jax_pipeline.eval_batches_per_host(jcfg, batch, hosts))


@pytest.mark.parametrize("hosts", [1, 2])
def test_record_eval_pixels_match_jax_and_every_example_counts_once(tree, hosts):
    root, items = tree
    cfg, jcfg = _cfg(root, dataset="imagenet", loader="tfdata", transfer_uint8=True)
    labels, diffs = [], []
    for h in range(hosts):
        mine = [_np(b) for b in port_data.make_eval_source(cfg, 4, h, hosts, device="cpu")]
        theirs = list(jax_make_eval_source(jcfg, 4, h, hosts))
        assert len(mine) == len(theirs) == pipeline.eval_batches_per_host(cfg, 4, hosts)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a["label"], b["label"])
            real = a["label"] >= 0
            diffs.append(np.abs(a["image"][real].astype(np.float32) - b["image"][real].astype(np.float32)).ravel())
            labels += [int(v) for v in a["label"][real]]
    assert sorted(labels) == sorted(k for _, k in items["val"])
    d = np.concatenate(diffs)
    assert d.max() <= EVAL_PIXEL_MAX and d.mean() <= EVAL_PIXEL_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("uint8", [False, True])
def test_record_eval_equals_the_folder_eval_bit_for_bit(tree, uint8):
    """The same JPEGs from the shards and from the folder: the same
    transform, so the same pixels (what makes the card's two evals agree)."""
    root, _ = tree
    cfg, _ = _cfg(root, transfer_uint8=uint8)
    rec, _ = _cfg(root, dataset="imagenet", loader="tfdata", transfer_uint8=uint8)
    for a, b in itertools.zip_longest(port_data.make_eval_source(cfg, 4, device="cpu"),
                                      port_data.make_eval_source(rec, 4, device="cpu")):
        np.testing.assert_array_equal(a["label"].numpy(), b["label"].numpy())
        real = a["label"].numpy() >= 0
        np.testing.assert_array_equal(a["image"].numpy()[real], b["image"].numpy()[real])


def test_record_train_stream_resumes_exactly_and_reshuffles_per_epoch(tree):
    root, _ = tree
    cfg, _ = _cfg(root, dataset="imagenet", loader="tfdata", transfer_uint8=True)
    full = [_np(b) for b in itertools.islice(port_data.make_train_source(cfg, 4, 5, device="cpu"), 12)]
    resumed = [_np(b) for b in itertools.islice(port_data.make_train_source(cfg, 4, 5, start_step=7, device="cpu"),
                                                5)]
    for a, b in zip(full[7:], resumed):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    # an epoch is 18 records: the first epoch's labels are each class's six,
    # and the next epoch's order is another
    first = np.concatenate([b["label"] for b in full])[:18]
    assert sorted(first) == sorted([0] * 6 + [1] * 6 + [2] * 6)
    stream = pipeline.RecordTrainStream(cfg, 4, 5)
    assert not np.array_equal(stream._epoch(0)[0], stream._epoch(1)[0]) or len(stream.files) < 3
    stream.close()


def test_record_train_transform_statistics(tree):
    """The shape of the JAX package's test_train_transform_statistics: the
    random-resized crops are normalized, finite, and vary across rows."""
    root, _ = tree
    cfg, _ = _cfg(root, dataset="imagenet", loader="tfdata", rrc_area_min=0.25, color_jitter=0.0)
    batch = _np(next(port_data.make_train_source(cfg, 8, 0, device="cpu")))
    assert batch["image"].shape == (8, SIZE, SIZE, 3) and batch["image"].dtype == np.float32
    assert np.isfinite(batch["image"]).all()
    assert np.std(batch["image"].mean(axis=(1, 2, 3))) > 1e-3


def test_a_corrupt_record_costs_its_batch_and_is_counted(tmp_path):
    """The shape of tests/test_data_resilience.py's tf.data test: a rotten
    JPEG inside a shard costs the batch it lands in, counted, and the stream
    survives."""
    rs = np.random.RandomState(0)
    d = tmp_path / "rec"
    d.mkdir()
    with tfrecord.TFRecordWriter(str(d / "train-00000-of-00001")) as w:
        for i in range(8):
            payload = b"definitely not a jpeg" if i == 3 else jpeg.encode(rs.randint(0, 255, (16, 16, 3), np.uint8),
                                                                           95)
            w.write(tfrecord.image_example(payload, i))
    cfg = DataConfig(dataset="imagenet", loader="tfdata", data_dir=str(d), image_size=8, num_train_examples=8,
                     decode_threads=1)
    reg = get_registry()
    corrupt0 = reg.snapshot().get("data.corrupt_records", 0.0)
    failures0 = reg.snapshot().get("data.record_decode_failures", 0.0)
    got = list(itertools.islice(port_data.make_train_source(cfg, 2, 1, device="cpu"), 6))
    assert len(got) == 6 and all(tuple(b["image"].shape) == (2, 8, 8, 3) for b in got)
    assert reg.snapshot()["data.corrupt_records"] > corrupt0
    assert reg.snapshot()["data.record_decode_failures"] > failures0


# ---------------------------------------------------------------------------
# the prefetch thread (tests/test_data_resilience.py's shape)
# ---------------------------------------------------------------------------


def test_prefetch_worker_preserves_order_and_drains():
    w = pipeline.PrefetchWorker(iter({"label": i} for i in range(7)), depth=3)
    assert [b["label"] for b in w] == list(range(7))
    w.close()


def test_prefetch_worker_restarts_crashed_worker_bounded():
    class Flaky:
        def __init__(self, crash_times):
            self._n, self._crashes = 0, crash_times

        def __iter__(self):
            return self

        def __next__(self):
            self._n += 1
            if self._n in self._crashes:
                raise RuntimeError(f"transient crash #{self._n}")
            if self._n > 8:
                raise StopIteration
            return {"label": self._n}

    snap = get_registry().snapshot()
    crashes0, restarts0 = snap.get("data.worker_crashes", 0.0), snap.get("data.worker_restarts", 0.0)
    w = pipeline.PrefetchWorker(Flaky({3, 5}), depth=2, max_restarts=3)
    assert [b["label"] for b in w] == [1, 2, 4, 6, 7, 8]
    snap = get_registry().snapshot()
    assert snap["data.worker_crashes"] == crashes0 + 2 and snap["data.worker_restarts"] == restarts0 + 2
    w = pipeline.PrefetchWorker(Flaky({1, 2, 3, 4, 5}), depth=2, max_restarts=2)
    with pytest.raises(RuntimeError, match="transient crash #3"):
        list(w)


# ---------------------------------------------------------------------------
# the JPEG library and the reference set
# ---------------------------------------------------------------------------


def test_the_port_encoder_and_decoder_are_libjpegs(tmp_path):
    """Here the host library is built against libjpeg: its encoder writes
    PIL's bytes and its decoder reads PIL's pixels; the committed reference
    decodes (what a host decoding through nvJPEG is held to) are its own."""
    assert jpeg.codec().startswith("libjpeg")
    pix = jpeg_corpus.reference_images()["noise_420"]
    buf = io.BytesIO()
    Image.fromarray(pix).save(buf, format="JPEG", quality=90)
    assert jpeg.encode(pix, 90) == buf.getvalue()
    np.testing.assert_array_equal(jpeg.decode(buf.getvalue()), np.asarray(Image.open(buf).convert("RGB")))
    jpeg_corpus.write_reference(str(tmp_path))
    fixtures = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
    for f in sorted(os.listdir(fixtures)):
        with open(os.path.join(fixtures, f), "rb") as a, open(tmp_path / f, "rb") as b:
            assert a.read() == b.read(), f
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        jpeg.decode(b"nope")


def test_concurrent_builds_land_one_whole_library(tmp_path):
    """Three processes rebuilding the host library at once (as pytest-xdist
    workers do at first use): each compiles to a temporary name and renames
    it into place, so every one of them loads a whole library."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from yet_another_mobilenet_series_tpu_torch.ops import host_build; "
            "from yet_another_mobilenet_series_tpu_torch.data import jpeg; "
            "host_build.build(force=True); print(jpeg.codec())")
    procs = [subprocess.Popen([sys.executable, "-c", code, REPO], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [e[-2000:] for _, e in outs]
    assert all(o.strip().startswith("libjpeg") for o, _ in outs)
    pids = {f".{p.pid}." for p in procs}
    left = [f for f in os.listdir(os.path.dirname(host_build.library_path())) if f.endswith(".tmp")]
    assert not [f for f in left if any(pid in f for pid in pids)], left


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", ["mobilenet_v2", "atomnas_a_search"])
def test_profile_cli_prints_the_jax_clis_lines(app):
    def out(main, apps):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([f"app:{os.path.join(apps, app + '.yml')}"])
        return buf.getvalue().splitlines()

    mine, theirs = out(port_profile_cli.main, PORT_APPS), out(jax_profile_cli.main, JAX_APPS)
    assert len(mine) > 10 and mine == theirs


def _folder_run(root, log_dir, *extra):
    return parse_cli([f"app:{os.path.join(PORT_APPS, 'mobilenet_v2.yml')}", "data.dataset=folder",
                      "data.loader=native", f"data.data_dir={root}", "data.val_split=val",
                      "data.num_train_examples=18", f"data.image_size={SIZE}", f"data.eval_resize={RESIZE}",
                      "model.width_mult=0.35", f"model.num_classes={CLASSES}", "train.batch_size=6",
                      "train.eval_batch_size=4", "train.compute_dtype=float32", "data.decode_threads=2",
                      "train.log_every=1", f"train.log_dir={log_dir}", *extra])


def test_cli_run_from_a_folder_matches_the_jax_clis_counts(tree, tmp_path):
    root, items = tree
    cfg = _folder_run(root, tmp_path / "log", "train.epochs=1", "train.profile_start_step=1",
                      "train.profile_num_steps=50", "data.prefetch_thread=true", "data.transfer_uint8=true",
                      "train.steps_per_dispatch=2")
    out = port_train_cli.run(cfg, device="cpu")
    assert out["eval_n"] == len(items["val"]) and out["finite_steps"] == out["steps"] == 3
    assert out["decode_failures"] == 0 and out["grouped"] is None  # the window forced single steps
    # steps per epoch and the eval pass's batch count are the JAX CLI's
    _, jcfg = _cfg(root)
    assert out["steps_per_epoch"] == max(jax_train_cli._dataset_sizes(_JaxCfg(jcfg))[0] // 6, 1)
    assert len(list(port_data.make_eval_source(cfg.data, 4, device="cpu"))) == len(list(jax_make_eval_source(
        JaxDataConfig(**{**jcfg.__dict__, "transfer_uint8": True}), 4)))
    # the window ran past the end of the run: closed and written on exit
    assert out["profile"]["first_step"] == 2 and out["profile"]["last_step"] == 3
    assert os.path.getsize(out["profile"]["path"]) > 0


class _JaxCfg:
    def __init__(self, data):
        self.data = data


def test_cli_resumes_the_folder_stream(tree, tmp_path):
    root, _ = tree
    extra = ["train.epochs=2", "model.dropout=0.0"]
    _, ts_a, _ = port_train_cli.train(_folder_run(root, tmp_path / "a", *extra), device="cpu")
    c, _, _ = port_train_cli.train(_folder_run(root, tmp_path / "c", *extra, "train.faults.enable=true",
                                               "train.faults.kill_at_step=2"), device="cpu")
    assert c["preempted"] is True and 0 < c["step"] < 6
    d, ts_d, _ = port_train_cli.train(_folder_run(root, tmp_path / "c", *extra), device="cpu")
    assert d["resumed_from"] == c["step"] and d["step"] == 6
    a, b = flatten_tree(ts_a.params), flatten_tree(ts_d.params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)

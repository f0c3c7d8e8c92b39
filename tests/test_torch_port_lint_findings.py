"""The faults the port's analyzer found in the port, each repaired and pinned
here (the suppressions it took are listed in analysis/ANALYZER.md):

- YAMT015: ops/cuda_build.py ran nvcc with no timeout, so a wedged compiler
  hung the launch that built the kernel;
- YAMT019: ckpt/manager.py's writer thread handed ``_error`` and
  ``_digest_warned`` to the caller's thread with no lock;
- YAMT018: cli/train.py's ``_free_port`` socket had no explicit bound;
- YAMT025: ``data.shuffle_buffer``, ``data.deterministic_input`` and
  ``serve.donate_input`` were accepted and read by nothing. The TFRecord
  train stream now applies the first two (its interleave and record buffer,
  F10 repaired); the run's startup log says what mixes the records, and
  acknowledges each field where the port always satisfies it.
"""

import dataclasses
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from yet_another_mobilenet_series_tpu_torch import data as data_sources
from yet_another_mobilenet_series_tpu_torch.analysis import run_lint
from yet_another_mobilenet_series_tpu_torch.ckpt.manager import CheckpointManager
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import DataConfig, ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.data import jpeg, pipeline, tfrecord
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.ops import cuda_build
from yet_another_mobilenet_series_tpu_torch.serve import export

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "yet_another_mobilenet_series_tpu_torch")
TRAIN_APP = os.path.join(PKG, "apps", "mobilenet_v3_large.yml")
SERVE_APP = os.path.join(PKG, "apps", "serve_mobilenet_v3.yml")
TINY = ["data.dataset=fake", "model.width_mult=0.35", "data.image_size=32", "model.num_classes=10",
        "train.batch_size=8", "data.fake_train_size=16", "data.fake_eval_size=8", "train.eval_batch_size=8",
        "train.epochs=1", "train.log_every=2"]


@pytest.mark.parametrize("rule,path", [("YAMT015", "ops/cuda_build.py"), ("YAMT019", "ckpt/manager.py"),
                                       ("YAMT018", "cli/train.py")])
def test_the_rule_no_longer_fires(rule, path):
    # the package's gate lints each file in its project; this pins the three
    # repaired sites by name
    findings = [f for f in run_lint([PKG], select={rule}) if f.path.endswith(path)]
    assert findings == [], "\n".join(f.format() for f in findings)


def test_nvcc_build_gives_up_after_its_timeout(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nexec sleep 30\n")  # a compiler that never returns
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "BUILD_TIMEOUT_S", 0.5)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not finish building fused_depthwise in 0.5 s"):
        cuda_build.build("fused_depthwise")
    assert time.perf_counter() - t0 < 10
    assert cuda_build.BUILD_TIMEOUT_S == 0.5 and not os.path.exists(cuda_build.library_path("fused_depthwise"))


def test_writer_error_is_handed_over_once(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", fail)
    mgr._thread = threading.Thread(target=mgr._write_guarded, args=(1, {}, {}, None))
    mgr._thread.start()
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # taken over by the first wait: nothing left to raise


def test_digest_warning_is_given_once_across_threads(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    mgr._dir = str(blocker)  # every digest write fails
    writers = [threading.Thread(target=mgr._record_digests, args=(s, {})) for s in range(4)]
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    mgr._record_digests(5, {})
    assert capsys.readouterr().out.count("could not write digests.json") == 1


def test_free_port_socket_is_bounded_and_free():
    port = train_cli._free_port()
    assert 0 < port < 65536
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


@pytest.mark.parametrize("dataset,words", [("fake", "per-epoch (seed, epoch) permutation"),
                                           ("imagenet", "no record buffer"), ("folder", "native loader")])
def test_order_note_names_both_input_fields(dataset, words):
    # the record-exact order under data.deterministic_input ...
    note = data_sources.order_note(DataConfig(dataset=dataset, deterministic_input=True))
    assert words in note and "data.deterministic_input=True holds by construction: exact resume" in note
    # ... and the default, which resumes exactly too
    default = data_sources.order_note(DataConfig(dataset=dataset))
    assert "data.deterministic_input=False holds by construction: exact resume" in default
    assert f"data.shuffle_buffer={DataConfig.shuffle_buffer}" in default
    assert "not applied" not in default and "F10" not in default
    if dataset == "imagenet":
        # the TFRecord stream mixes its records as the JAX package's default does
        assert words not in default
        assert f"interleave of data.decode_threads={DataConfig.decode_threads} shards (block 1)" in default
        assert f"record shuffle buffer of data.shuffle_buffer={DataConfig.shuffle_buffer} records" in default


def _shards(root, n, shards):
    """``shards`` TFRecord shards of ``n`` tiny JPEG records, record i
    labelled i and dealt to shard i % shards."""
    rs = np.random.RandomState(0)
    for s in range(shards):
        with tfrecord.TFRecordWriter(os.path.join(root, f"train-{s:05d}-of-{shards:05d}")) as w:
            for i in range(s, n, shards):
                w.write(tfrecord.image_example(jpeg.encode(rs.randint(0, 255, (8, 8, 3), np.uint8), 90), i))


def test_shuffle_buffer_is_refused_where_it_would_size_nothing(tmp_path):
    # the TFRecord train stream accepts a non-default buffer and applies it
    cfg = parse_cli([f"app:{TRAIN_APP}", "data.dataset=imagenet", "data.shuffle_buffer=100",
                     f"data.data_dir={tmp_path}", f"train.log_dir={tmp_path / 'log'}"])
    data_sources._check(cfg.data)
    _shards(str(tmp_path), 40, 2)
    orders = {}
    for buffer in (1, 100):
        data = dataclasses.replace(cfg.data, shuffle_buffer=buffer, decode_threads=1, image_size=8)
        stream = pipeline.RecordTrainStream(data, 8, 3)
        try:
            assert stream.buffer == buffer and stream.cycle == 1
            orders[buffer] = np.concatenate([next(stream)["label"] for _ in range(5)])
        finally:
            stream.close()
    assert sorted(orders[100]) == sorted(orders[1]) == list(range(40))
    assert not np.array_equal(orders[100], orders[1])
    # two shards read back to back without a buffer: one shard's labels, then the other's
    assert {tuple(sorted(orders[1][:20] % 2)), tuple(sorted(orders[1][20:] % 2))} == {(0,) * 20, (1,) * 20}
    data_sources._check(DataConfig(dataset="fake", shuffle_buffer=100))  # the fake stream: nothing to size


def test_train_startup_log_acknowledges_the_input_fields(tmp_path, capsys):
    cfg = parse_cli([f"app:{TRAIN_APP}", *TINY, "data.deterministic_input=true", f"train.log_dir={tmp_path / 'log'}"])
    train_cli.run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert out.count("data.deterministic_input=True holds by construction") == 1


def test_serve_startup_log_acknowledges_donate_input(tmp_path, capsys):
    specs = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25}, {"t": 3, "c": 16, "n": 2, "s": 2}]
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, block_specs=specs, dropout=0.0), image_size=24)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / "bundle"), model_name="tiny")
    result = serve_cli.main([f"app:{SERVE_APP}", f"serve.bundle={tmp_path / 'bundle'}", "data.image_size=24",
                             f"train.log_dir={tmp_path / 'log'}", "serve.requests=8", "serve.clients=2",
                             "serve.donate_input=false", "--device", "cpu"])
    assert result["completed"] == 8
    assert capsys.readouterr().out.count("serve.donate_input=False holds by construction") == 1

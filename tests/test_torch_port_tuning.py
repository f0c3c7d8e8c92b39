"""The port's measurement-to-production loop against the JAX package's.

- ``train/tuning.py`` (a copy): the same tuning files through the JAX
  package's ``validate_tuning``/``apply_tuning_file`` and the port's give
  the same config and lines, or raise alike; a non-empty ``flags`` (XLA
  flags) is the one difference: the JAX package puts it in the env, the
  port refuses it.
- ``cli/train.py`` with ``train.tuning_file`` on the CPU: the tuned knobs
  reach the train step and the grouped step, the provenance is logged, and
  eval stays on exact BN and the stock convs (``tests/test_tuning.py:106``).
- ``bench/tuning_decide.py`` against ``scripts/tpu_watch.py``'s ``decide``
  on synthetic A/B artifacts: the same adoption, case by case.
- ``bench/bn_bench.py`` and ``bench/input_bench.py`` at smoke scale on the
  CPU: one well-formed line each, and the source's argument errors.
- ``data/to_tfrecords.py`` against ``scripts/imagefolder_to_tfrecords.py``
  (TensorFlow's writer): the same shards, whose records parse to the same
  features.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from yet_another_mobilenet_series_tpu.config import config_from_dict as jax_config_from_dict
from yet_another_mobilenet_series_tpu.train import tuning as jax_tuning
from yet_another_mobilenet_series_tpu_torch.bench import bn_bench, input_bench, tuning_decide
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict
from yet_another_mobilenet_series_tpu_torch.data import jpeg_corpus, tfrecord, to_tfrecords
from yet_another_mobilenet_series_tpu_torch.models import specs
from yet_another_mobilenet_series_tpu_torch.parallel import dp
from yet_another_mobilenet_series_tpu_torch.train import tuning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg_dict(tmp_path, **train_over):
    """tests/test_tuning.py's config, on one device."""
    return {
        "name": "tuning_loop",
        "model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
                  "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}]},
        "data": {"dataset": "fake", "image_size": 16, "fake_train_size": 64, "fake_eval_size": 16,
                 "fake_num_classes": 4},
        "optim": {"optimizer": "sgd", "weight_decay": 0.0},
        "schedule": {"schedule": "constant", "base_lr": 0.05, "scale_by_batch": False, "warmup_epochs": 0.0},
        "ema": {"enable": False},
        "train": {"batch_size": 16, "eval_batch_size": 16, "epochs": 1, "compute_dtype": "float32",
                  "log_dir": str(tmp_path / "logs"), "eval_every_epochs": 0.0, **train_over},
        "dist": {"num_devices": 1},
    }


# ---------------------------------------------------------------------------
# train/tuning.py against the JAX package's
# ---------------------------------------------------------------------------

VALIDATE_CASES = [
    {}, {"flags": "--xla_a=1"}, {"source": "x"},
    {"bn_mode": "fused_vjp", "remat": True, "remat_policy": "save_conv", "conv1x1_dot": True, "steps_per_dispatch": 4},
    {"bn_mode": "compute_sdot"}, {"steps_per_dispatch": 1}, {"steps_per_dispatch": 16},
    {"bn_mode": "nope"}, {"remat": "yes"}, {"remat": 1}, {"remat_policy": "none"}, {"conv1x1_dot": 1},
    {"steps_per_dispatch": 0}, {"steps_per_dispatch": 17}, {"steps_per_dispatch": True},
    {"steps_per_dispatch": 2.0}, {"steps_per_dispatch": "4"},
]


@pytest.mark.parametrize("raw", VALIDATE_CASES, ids=[json.dumps(c) for c in VALIDATE_CASES])
def test_validate_tuning_matches_the_jax_package(raw):
    try:
        want = jax_tuning.validate_tuning(dict(raw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tuning.validate_tuning(dict(raw))
        assert str(got.value) == str(e)
    else:
        assert tuning.validate_tuning(dict(raw)) == want


APPLY_CASES = [
    {"bn_mode": "folded", "conv1x1_dot": True, "steps_per_dispatch": 2, "source": "BENCH_BN (1.08x vs exact)"},
    {"bn_mode": "compute", "source": "x", "provisional": "synthetic-fixture parity only"},
    {"bn_mode": "exact", "remat": True, "remat_policy": "save_conv", "contention_invalidated": True,
     "contention_note": "host contention"},
    {"steps_per_dispatch": 4, "steps_per_dispatch_source": "probe"},
    {"source": "a no-win A/B"},
    {"bn_mode": "folded", "flags": "", "flags_source": "sweep"},
    # raise alike
    {"bn_mode": "nope"}, {"steps_per_dispach": 4}, {"bn_mode": "folded", "flags": None},
    {"steps_per_dispatch": True},
]


@pytest.mark.parametrize("raw", APPLY_CASES, ids=[json.dumps(c) for c in APPLY_CASES])
def test_apply_tuning_file_matches_the_jax_package(tmp_path, raw):
    path = tmp_path / "BENCH_TUNING.json"
    path.write_text(json.dumps(raw))
    jcfg = jax_config_from_dict(_cfg_dict(tmp_path, tuning_file=str(path)))
    cfg = config_from_dict(_cfg_dict(tmp_path, tuning_file=str(path)))
    try:
        jcfg2, jlines = jax_tuning.apply_tuning_file(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tuning.apply_tuning_file(cfg)
        assert str(got.value) == str(e)
        return
    cfg2, lines = tuning.apply_tuning_file(cfg)
    assert lines == jlines
    for key in tuning.TUNING_KEYS:
        assert getattr(cfg2.train, key) == getattr(jcfg2.train, key), key


def test_non_empty_flags_go_to_the_env_in_jax_and_are_refused_in_the_port(tmp_path, monkeypatch):
    path = tmp_path / "BENCH_TUNING.json"
    path.write_text(json.dumps({"bn_mode": "folded", "flags": "--xla_tpu_rwb_fusion=false", "flags_source": "s"}))
    monkeypatch.delenv("LIBTPU_INIT_ARGS", raising=False)
    _, jlines = jax_tuning.apply_tuning_file(jax_config_from_dict(_cfg_dict(tmp_path, tuning_file=str(path))))
    assert os.environ["LIBTPU_INIT_ARGS"] == "--xla_tpu_rwb_fusion=false" and any("flags" in ln for ln in jlines)
    with pytest.raises(ValueError, match=r"XLA/libtpu flags.*ROADMAP queue 1, item 12"):
        tuning.apply_tuning_file(config_from_dict(_cfg_dict(tmp_path, tuning_file=str(path))))
    assert tuning.partition_flags("--xla_a=1 --xla_tpu_b=2") == jax_tuning.partition_flags("--xla_a=1 --xla_tpu_b=2")


# ---------------------------------------------------------------------------
# cli/train.py with a tuning file
# ---------------------------------------------------------------------------


def test_cli_runs_the_tuned_step_and_eval_stays_exact(tmp_path, monkeypatch, capsys):
    """The tuned bn_mode and conv1x1_dot reach every training forward and
    steps_per_dispatch the grouped step; every eval forward runs exact BN
    and the stock convs (observed at Network.apply)."""
    path = tmp_path / "BENCH_TUNING_TORCH.json"
    path.write_text(json.dumps({"bn_mode": "folded", "conv1x1_dot": True, "steps_per_dispatch": 2,
                                "source": "test"}))
    calls, grouped_k = [], []
    real_apply, real_grouped = specs.Network.apply, dp.make_grouped_train_step

    def rec_apply(self, params, state, x, *, train=False, **kw):
        calls.append((train, kw.get("bn_mode", "exact"), kw.get("conv1x1_dot", False)))
        return real_apply(self, params, state, x, train=train, **kw)

    def rec_grouped(step, k, *a, **kw):
        grouped_k.append(k)
        return real_grouped(step, k, *a, **kw)

    monkeypatch.setattr(specs.Network, "apply", rec_apply)
    monkeypatch.setattr(dp, "make_grouped_train_step", rec_grouped)
    out = train_cli.run(config_from_dict(_cfg_dict(tmp_path, tuning_file=str(path), log_every=2)), device="cpu")
    logged = capsys.readouterr().out
    assert out["finite_steps"] == 4 and 0.0 <= out["eval_top1"] <= 1.0
    assert grouped_k == [2] and out["log"][0]["grouped_k"] == 2
    assert f"tuning: {path} -> {{'bn_mode': 'folded', 'conv1x1_dot': True, 'steps_per_dispatch': 2}} " \
           "(source: test)" in logged
    assert "train step: bn_mode=folded remat=False remat_policy=full conv1x1_dot=True steps_per_dispatch=2" \
        in logged
    trained = {c for c in calls if c[0]}
    evaluated = {c for c in calls if not c[0]}
    assert trained == {(True, "folded", True)}
    assert evaluated == {(False, "exact", False)}


def test_cli_without_a_tuning_file_logs_the_yaml_step(tmp_path, capsys):
    train_cli.run(config_from_dict(_cfg_dict(tmp_path)), device="cpu")
    logged = capsys.readouterr().out
    assert "tuning:" not in logged
    assert "train step: bn_mode=exact remat=False remat_policy=full conv1x1_dot=False steps_per_dispatch=1" in logged


# ---------------------------------------------------------------------------
# bench/tuning_decide.py against scripts/tpu_watch.py
# ---------------------------------------------------------------------------


@pytest.fixture()
def tw(tmp_path, monkeypatch):
    mod = _load_script("tpu_watch")
    monkeypatch.setattr(mod, "TUNING_PATH", str(tmp_path / "jax" / "BENCH_TUNING.json"))
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    return mod


def _row(mode, ms, remat="off", dot=False, loss=6.9):
    return {"bn_mode": mode, "remat": remat, "conv1x1_dot": dot, "ms_per_step": ms, "loss": loss,
            "img_s_per_chip": 256e3 / ms}


def _probe(eager, graph):
    return {"bn_mode": "exact[graph4]", "remat": "off", "conv1x1_dot": False, "ms_per_step": graph,
            "ms_per_step_chained": eager, "dispatch_tax_ms": eager - graph, "loss": 6.9}


DECIDE_CASES = {
    "folded_wins": ([_row("exact", 35.7), _row("folded", 33.0, loss=6.9001)], {}, False, {}),
    "sub_threshold": ([_row("exact", 35.7), _row("folded", 35.0)], {}, False, {}),
    "loss_sanity": ([_row("exact", 35.7), _row("folded", 30.0, loss=7.0)], {}, False, {}),
    "compute_gated": ([_row("exact", 35.7), _row("compute", 30.0)], {}, False, {}),
    "compute_allowed": ([_row("exact", 35.7), _row("compute", 30.0)], {}, True, {}),
    "remat_and_dot_tokens": ([_row("exact", 35.7), _row("sdot", 30.0, remat="save_conv", dot=True)], {}, False, {}),
    "full_remat": ([_row("exact", 35.7), _row("fused_vjp", 30.0, remat="full")], {}, False, {}),
    "no_win_drops_stale": ([_row("exact", 35.7), _row("folded", 35.5)],
                           {"bn_mode": "folded", "source": "old", "flags": "--xla_a=1", "flags_source": "s"},
                           False, {}),
    "no_baseline": ([_row("folded", 30.0)], {"bn_mode": "folded", "source": "old"}, False, {}),
    "contention": ([_row("exact", 35.7), _row("folded", 20.0)], {"bn_mode": "folded", "source": "old"}, False,
                   {"contention_invalidated": True, "contention_note": "skewed"}),
    "dispatch_adopted": ([_row("exact", 120.0), _row("folded", 119.0), _probe(120.0, 111.0)], {}, False, {}),
    "dispatch_below": ([_row("exact", 120.0), _probe(120.0, 119.0)],
                       {"steps_per_dispatch": 4, "steps_per_dispatch_source": "old"}, False, {}),
    "no_probe_keeps_dispatch": ([_row("exact", 35.7), _row("folded", 35.5)],
                                {"steps_per_dispatch": 4, "steps_per_dispatch_source": "old"}, False, {}),
    "win_over_contention": ([_row("exact", 35.7), _row("folded", 30.0)],
                            {"bn_mode": "exact", "contention_invalidated": True, "contention_note": "x"}, False, {}),
}
# text the two write in their own words
WORDS = ("source", "provisional", "steps_per_dispatch_source", "rule", "ab_source")


def _plain(d):
    if isinstance(d, dict):
        return {k: (bool(v) if k in WORDS else _plain(v)) for k, v in d.items()}
    return d


@pytest.mark.parametrize("case", list(DECIDE_CASES))
def test_tuning_decide_matches_tpu_watch(tw, tmp_path, case):
    rows, prior, allow_compute, extra = DECIDE_CASES[case]
    ab = {"platform": "cuda", "partial": False, "device_kind": "card", "rows": rows, **extra}
    ab_path = tmp_path / "ab.json"
    ab_path.write_text(json.dumps(ab))
    jax_tuning_path, port_tuning_path = tmp_path / "jax" / "BENCH_TUNING.json", tmp_path / "port" / "t.json"
    if prior:
        tw._write_tuning(dict(prior))
        tuning_decide.write_tuning(str(port_tuning_path), dict(prior))
    tw.decide(str(ab_path), str(tmp_path / "jax" / "dec.json"), allow_compute=allow_compute)
    got = tuning_decide.decide(str(ab_path), str(tmp_path / "port" / "dec.json"), str(port_tuning_path),
                               allow_compute=allow_compute)
    want = json.loads((tmp_path / "jax" / "dec.json").read_text())
    assert got == json.loads((tmp_path / "port" / "dec.json").read_text())
    assert _plain(got) == _plain(want)
    assert _plain(tuning_decide.read_tuning(str(port_tuning_path))) == _plain(tw._read_tuning())
    assert port_tuning_path.exists() == jax_tuning_path.exists()
    if port_tuning_path.exists() and "flags" not in prior:
        # what the rule writes is a file that the port's tuning accepts
        cfg, lines = tuning.apply_tuning_file(config_from_dict(_cfg_dict(tmp_path,
                                                                         tuning_file=str(port_tuning_path))))
        assert lines


def test_tuning_decide_refuses_what_the_card_did_not_measure(tmp_path):
    for ab in ({"platform": "cpu", "partial": False, "rows": []}, {"platform": "cuda", "partial": True, "rows": []}):
        (tmp_path / "ab.json").write_text(json.dumps(ab))
        with pytest.raises(ValueError, match="not a complete A/B measured on a card"):
            tuning_decide.decide(str(tmp_path / "ab.json"), str(tmp_path / "d.json"), str(tmp_path / "t.json"))
    assert not (tmp_path / "t.json").exists() and not (tmp_path / "d.json").exists()
    with pytest.raises(ValueError, match="JAX package's tuning file"):
        tuning_decide.write_tuning(str(tmp_path / "BENCH_TUNING.json"), {"bn_mode": "folded"})
    assert tuning_decide.TUNING_PATH.endswith("BENCH_TUNING_TORCH.json")


def test_tuning_decide_constants_are_tpu_watchs(tw):
    for name in ("WIN_THRESHOLD", "PARITY_SAFE_MODES", "COMPUTE_MODES", "LOSS_SANITY_ABS", "DISPATCH_TAX_THRESHOLD",
                 "DISPATCH_K"):
        assert getattr(tuning_decide, name) == getattr(tw, name), name
    assert tuning_decide.AB_KEYS == tw._AB_KEYS and tuning_decide.DISPATCH_KEYS == tw._DISPATCH_KEYS


# ---------------------------------------------------------------------------
# the benches at smoke scale
# ---------------------------------------------------------------------------


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_bn_bench_cpu_rehearsal_prints_one_line(tmp_path):
    out_path = tmp_path / "ab.json"
    rc, line = _main(bn_bench, ["--variants", "exact:0,folded:save_conv:dot", "--dispatch-probe", "--device", "cpu",
                                "--out", str(out_path)])
    assert rc == 0 and "error" not in line, line
    assert line["cpu_rehearsal"] is True and line["partial"] is False and line["batch"] == 8
    assert [(r["bn_mode"], r["remat"], r["conv1x1_dot"]) for r in line["rows"]] == [
        ("exact", "off", False), ("folded", "save_conv", True), ("exact[graph4]", "off", False)]
    assert all(np.isfinite(r["loss"]) and r["ms_per_step"] is None for r in line["rows"])
    assert line["rows"][-1]["mode"] == "eager (cpu)" and line["rows"][-1]["dispatch_tax_ms"] is None
    assert json.loads(out_path.read_text())["rows"] == line["rows"]
    assert line["provenance"]["cpu_rehearsal"] is True


def test_bn_bench_default_variants_are_the_sources():
    src = open(os.path.join(REPO, "scripts", "bench_bn.py")).read()
    assert f'default="{bn_bench.DEFAULT_VARIANTS}"' in src.replace('"\n        "', "").replace("\n", "")
    assert len(bn_bench.parse_variants(bn_bench.DEFAULT_VARIANTS)) == 11


@pytest.mark.parametrize("spec,match", [("exact", "malformed variant"), ("bogus:0", "unknown bn_mode token"),
                                        ("exact:2", "unknown remat token"), ("exact:0:dot:x", "trailing token")])
def test_bn_bench_refuses_a_bad_variant_before_touching_a_device(tmp_path, spec, match):
    # the default device is the card, which this machine lacks: the variant
    # is refused first
    rc, line = _main(bn_bench, ["--variants", spec, "--out", str(tmp_path / "ab.json")])
    assert rc == 1 and match in line["error"] and line["value"] is None
    assert not (tmp_path / "ab.json").exists()


def test_bn_bench_refuses_the_xla_flag_sweep():
    rc, line = _main(bn_bench, ["--xla-flags-sweep", "--device", "cpu"])
    assert rc == 1 and "ROADMAP queue 1, item 12" in line["error"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    train = jpeg_corpus.write_image_folder(root, "train", 3, 4)
    jpeg_corpus.write_tfrecords(root, "train", train, 2)
    return root


@pytest.mark.parametrize("pipeline,extra", [("fake", []), ("native", ["--transfer-uint8"]),
                                            ("tfrecord", ["--deterministic"])])
def test_input_bench_cpu_rehearsal_prints_one_line(corpus, pipeline, extra):
    rc, line = _main(input_bench, ["--pipeline", pipeline, "--data-dir", corpus, "--batch", "4", "--batches", "2",
                                   "--image-size", "16", "--threads", "2", "--device", "cpu", *extra])
    assert rc == 0 and "error" not in line, line
    assert line["images_per_sec"] > 0 and line["batch"] == 4 and line["batches"] == 2
    assert line["pipeline"] == pipeline + "".join({"--transfer-uint8": "+uint8", "--deterministic": "+deterministic"}[e]
                                                  for e in extra)
    assert (line["codec"] is None) == (pipeline == "fake") and line["cpu_rehearsal"] is True


@pytest.mark.parametrize("argv,match", [(["--pipeline", "fake", "--deterministic"], "only applies to --pipeline"),
                                        (["--pipeline", "native", "--deterministic"], "only applies to --pipeline"),
                                        (["--pipeline", "fake", "--transfer-uint8"], "needs a real-JPEG pipeline"),
                                        (["--pipeline", "webdataset"], "invalid choice")])
def test_input_bench_argument_errors_are_the_sources(capsys, argv, match):
    src = _load_script("bench_input")
    for main in (src.main, lambda: input_bench.main(argv)):
        old = sys.argv
        sys.argv = ["bench_input", *argv]
        try:
            with pytest.raises(SystemExit) as e:
                main()
        finally:
            sys.argv = old
        assert e.value.code == 2 and match in capsys.readouterr().err


def test_input_bench_without_data_is_an_error_line(tmp_path):
    rc, line = _main(input_bench, ["--pipeline", "native", "--data-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 1 and line["value"] is None and "FileNotFoundError" in line["error"]


# ---------------------------------------------------------------------------
# data/to_tfrecords.py against the JAX script's TensorFlow writer
# ---------------------------------------------------------------------------


def test_to_tfrecords_writes_what_the_tensorflow_script_writes(tmp_path, monkeypatch, capsys):
    import tensorflow as tf

    src = str(tmp_path / "folder")
    jpeg_corpus.write_image_folder(src, "train", 3, 3)
    src = os.path.join(src, "train")
    script = _load_script("imagefolder_to_tfrecords")
    monkeypatch.setattr(sys, "argv", ["x", "--src", src, "--dst", str(tmp_path / "tf"), "--split", "val",
                                      "--shards", "2"])
    script.main()
    to_tfrecords.main(["--src", src, "--dst", str(tmp_path / "port"), "--split", "val", "--shards", "2"])
    assert sorted(os.listdir(tmp_path / "tf")) == sorted(os.listdir(tmp_path / "port")) == [
        "val-00000-of-00002", "val-00001-of-00002", "val-classes.txt"]
    assert (tmp_path / "tf" / "val-classes.txt").read_text() == (tmp_path / "port" / "val-classes.txt").read_text()
    features = {"image/encoded": tf.io.FixedLenFeature([], tf.string),
                "image/class/label": tf.io.FixedLenFeature([], tf.int64)}
    for shard in ("val-00000-of-00002", "val-00001-of-00002"):
        got = [tf.io.parse_single_example(r, features) for r in tf.data.TFRecordDataset(str(tmp_path / "port" / shard))]
        want = [tf.io.parse_single_example(r, features) for r in tf.data.TFRecordDataset(str(tmp_path / "tf" / shard))]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["image/encoded"].numpy() == w["image/encoded"].numpy()
            assert int(g["image/class/label"]) == int(w["image/class/label"]) >= 1
        # and the port's own reader parses TensorFlow's records to its own
        assert [tfrecord.parse_image_example(r) for r in tfrecord.iter_records(str(tmp_path / "tf" / shard))] == \
            [tfrecord.parse_image_example(r) for r in tfrecord.iter_records(str(tmp_path / "port" / shard))]

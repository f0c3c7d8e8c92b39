"""Repairs of the port's main path, on the CPU: the TF32 switches of
``cli/train.py`` (F1), the ``entry()`` twin, the bf16 eval forward against
the JAX package's, the copies of JAX-free modules held equal to their
sources, and the cost counts from shapes (``obs/device.py``) that the
engine and the training CLI record.
"""

import ast
import difflib
import json
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs import device as obs_device
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.utils.device import set_tf32
from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

from test_torch_port_models import TINY_SPECS, _both, _jax_tree, _jax_weights_with_seeded_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch")
APPS = os.path.join(PORT, "apps")


@pytest.fixture
def tf32_restored():
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# F1: cli/train.py sets TF32 from the compute dtype
# ---------------------------------------------------------------------------


def _train_args(tmp_path, dtype):
    return [f"app:{os.path.join(APPS, 'mobilenet_v3_large.yml')}", "data.dataset=fake", "model.width_mult=0.35",
            "model.num_classes=10", "data.image_size=32", "train.batch_size=4", "data.fake_train_size=8",
            "data.fake_eval_size=4", "train.eval_batch_size=4", "train.epochs=1", "train.log_every=1",
            f"train.compute_dtype={dtype}", f"train.log_dir={tmp_path / dtype}"]


@pytest.mark.parametrize("dtype,want", [("float32", False), ("bfloat16", True)])
def test_train_cli_sets_tf32_from_the_compute_dtype(tmp_path, tf32_restored, dtype, want):
    """Whatever the process set before, the run sets both switches from
    train.compute_dtype (off for float32) and logs them in its first row."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not want
    summary = train_cli.run(parse_cli(_train_args(tmp_path, dtype)), device="cpu")
    assert torch.backends.cudnn.allow_tf32 is want and torch.backends.cuda.matmul.allow_tf32 is want
    assert summary["tf32"] == {"tf32_cudnn": want, "tf32_matmul": want}
    first, second = summary["log"][:2]
    assert first["tf32_cudnn"] == first["tf32_matmul"] == float(want)
    assert "tf32_cudnn" not in second
    with open(tmp_path / dtype / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert any(row.get("train/tf32_cudnn") == float(want) for row in rows), rows[:2]


def test_set_tf32_refuses_an_unknown_dtype(tf32_restored):
    with pytest.raises(ValueError, match="float16"):
        set_tf32("float16")


def test_train_step_cost_is_three_forwards(tmp_path, tf32_restored):
    """The CLI records the step's cost once per Trainer: forward and a
    backward of twice the forward, 2 FLOPs a MAC, at the run's batch."""
    cfg = parse_cli(_train_args(tmp_path, "float32"))
    trainer = train_cli.Trainer(cfg, get_model(cfg.model, 32), "cpu")
    macs = profile_network(trainer.net, 32).total_macs
    assert obs_device.flops_for("train_step") == trainer.step_cost["flops"] == 6 * macs * 4
    fwd = obs_device.forward_cost(trainer.net, 32, 4, 4)
    assert trainer.step_cost["bytes"] == 3 * fwd["bytes"] and fwd["bytes"] > 4 * 4 * 32 * 32 * 3
    assert get_registry().snapshot()["obs.cost_flops.train_step"] == 6 * macs * 4


# ---------------------------------------------------------------------------
# the entry() twin and the bf16 eval forward
# ---------------------------------------------------------------------------


def test_entry_twin_is_the_bf16_eval_forward():
    from yet_another_mobilenet_series_tpu_torch.graft_entry import entry

    fn, (params, state, x) = entry(device="cpu", batch=2, image_size=32)
    assert x.shape == (2, 32, 32, 3) and x.dtype == torch.float32
    x = torch.from_numpy(np.random.RandomState(0).normal(0, 1, (2, 32, 32, 3)).astype(np.float32))
    got = fn(params, state, x)
    net = get_model(ModelConfig(arch="mobilenet_v3_large"), image_size=32)
    want = net.apply(params, state, x, train=False, compute_dtype=torch.bfloat16)
    f32 = net.apply(params, state, x, train=False)
    assert got.shape == (2, 1000) and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want) and not torch.equal(got, f32)


def test_entry_twin_refuses_cuda_without_a_card():
    from yet_another_mobilenet_series_tpu_torch.graft_entry import entry

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


# The port's bf16 eval forward against the JAX package's on the same
# weights and inputs. Each rounds to bf16 at its own points, so they differ
# by about what either differs from float32. Measured on the CPU: max
# |delta| 7.7e-4 on the tiny net (logits up to 0.26; JAX bf16 against f32:
# 7.0e-4) and 8.8e-5 on MobileNetV3-Large 0.35 at 64 (logits up to 0.087).
BF16_FORWARD_ATOL = 2e-3


@pytest.mark.parametrize("arch,width,size,kw", [
    ("mobilenet_v2", 1.0, 24, dict(num_classes=10, block_specs=TINY_SPECS, dropout=0.0)),
    ("mobilenet_v3_large", 0.35, 64, dict(num_classes=10)),
])
def test_bf16_eval_forward_matches_jax_bf16(arch, width, size, kw):
    jnet, pnet = _both(arch, width, size, **kw)
    params, state = _jax_weights_with_seeded_stats(jnet, pnet, seed=1)
    x = np.random.RandomState(11).normal(0, 1, (4, size, size, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=False, compute_dtype=jnp.bfloat16))(
        _jax_tree(params), _jax_tree(state), jnp.asarray(x))
    with torch.inference_mode():
        got = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x),
                         compute_dtype=torch.bfloat16)
        f32 = pnet.apply(convert.from_jax(params), convert.from_jax(state), torch.from_numpy(x))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and np.abs(want).max() > 5e-2  # the bar compares real numbers
    assert not torch.equal(got, f32)  # it really computed in bf16
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_FORWARD_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# copies held equal to their sources
# ---------------------------------------------------------------------------


# the comment that opens a header line, by file type
COMMENT = {".py": "#", ".yml": "#", ".cc": "//"}


def _comment(path):
    return COMMENT[os.path.splitext(path)[1]]


def _copies():
    """(port file, source path) of every file of the port whose first line
    is ``# Copy of <path>`` (``// Copy of <path>`` in C++)."""
    out = []
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            path = os.path.join(root, f)
            if os.path.splitext(f)[1] not in COMMENT:
                continue
            with open(path) as fh:
                first = fh.readline()
            tag = f"{_comment(f)} Copy of "
            if first.startswith(tag):
                src = first[len(tag):].split()[0].rstrip(":")
                out.append((os.path.relpath(path, REPO), src))
    return sorted(out)


COPIES = _copies()
# The copies that differ from their source on purpose, and how.
DIFFERENT = {
    # the source's comment names a change by its number; the copy drops it
    "yet_another_mobilenet_series_tpu_torch/serve/ring.py": "one line",
    # the port's own run comments; every setting is the source's
    "yet_another_mobilenet_series_tpu_torch/apps/serve_mobilenet_v3.yml": "comments",
    # the numpy helpers copied (their docstrings name torch), the two
    # device functions rewritten in torch
    "yet_another_mobilenet_series_tpu_torch/serve/quant.py": "reduced",
    # the replicas it spawns are the port's, --device reaches each of them,
    # and two docstring lines drop the change numbers of their source
    "yet_another_mobilenet_series_tpu_torch/cli/fleet.py": "hunks",
    # F5 (ROADMAP queue 3): a request on a connection kept alive past stop()
    # is answered "draining" instead of meeting the stopped batcher; F4: an
    # unknown X-Model is answered by its own "unknown_model" row
    "yet_another_mobilenet_series_tpu_torch/serve/frontend.py": "hunks",
    # the batches are tensors on the device: the NaN goes into a clone of
    # the image tensor, not a numpy copy
    "yet_another_mobilenet_series_tpu_torch/train/faults.py": "hunks",
    # the library is the port's, built from csrc/ by ops/host_build.py into
    # build/, never make in native/
    "yet_another_mobilenet_series_tpu_torch/data/native_loader.py": "hunks",
}
CHANGE_NUMBER = re.compile(r" \(PR \d+\)|PR-\d+ ")
FRONTEND_DIFF = [
    ([], ["        if fe._draining:",
          "            # a request on a connection kept alive past stop(): the batcher",
          "            # is draining or stopped, so the verdict is \"draining\", and the",
          "            # connection closes",
          "            self.close_connection = True",
          "            self._send_error_json(503, \"draining\", \"the server is draining; send elsewhere\",",
          "                                  {\"Connection\": \"close\"})",
          "            return"]),
    ([], ["        except UnknownModel as e:",
          "            # its own _ERROR_MAP row, before the ValueError branch below",
          "            self._send_typed_error(e, rid_hdr)",
          "            return"]),
]
FAULTS_DIFF = [
    (["", "import numpy as np"], []),
    (['            image = np.array(batch["image"], dtype=np.float32, copy=True)', "            image[0] = np.nan"],
     ['            image = batch["image"].clone()', '            image[0] = float("nan")']),
]
NATIVE_LOADER_DIFF = [
    (["import subprocess"], []),
    ([], ["from ..ops import host_build"]),
    (['_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), '
      '"native", "libyamt_loader.so")'], []),
    (['    """Compiles native/libyamt_loader.so (g++ + libjpeg). Always runs make —',
      "    a no-op when up to date — so a stale prebuilt library can never be used",
      "    against newer ctypes signatures (the C ABI has grown arguments before;",
      '    extra args are silently dropped by the calling convention)."""',
      "    # timeout per YAMT015: a wedged compiler must fail the load loudly, not",
      "    # hang the training process before its watchdog even exists",
      "    if force:",
      '        subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH), "-B"],',
      "                       check=True, capture_output=True, timeout=600)",
      "    else:",
      '        subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],',
      "                       check=True, capture_output=True, timeout=600)",
      "    return _LIB_PATH"],
     ["    \"\"\"The port's host library (csrc/jpeg_io.cc with the copied",
      "    csrc/yamt_loader.cc, ops/host_build.py): built at first use into build/,",
      "    keyed by its sources, so a stale library can never be loaded against",
      '    newer ctypes signatures."""',
      "    host_build.load(force)",
      "    return host_build.library_path()"]),
]
# cli/fleet.py's differences from its source, (source lines, copy lines), once
# the two change numbers its docstring names are taken out of the source
# (CHANGE_NUMBER)
FLEET_DIFF = [
    ([], ["from .serve import parse_device"]),
    (['            sys.executable, "-m", "yet_another_mobilenet_series_tpu.cli.serve",'],
     ['            sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.serve",']),
    ([], ["    # --device (cuda unless the operator asks for the CPU) goes to every replica",
          "    cleaned, device = parse_device(cleaned)"]),
    (["    return run(cfg, cleaned)"], ['    return run(cfg, cleaned + ["--device", device])']),
]


def _lines(path):
    with open(os.path.join(REPO, path)) as f:
        return f.read().splitlines()


def test_every_copy_is_found():
    names = {c for c, _ in COPIES}
    for mod in ("config.py", "obs/registry.py", "obs/trace.py", "utils/logging.py", "serve/ring.py",
                "serve/batcher.py", "serve/pipeline.py", "models/zoo.py", "models/serialize.py",
                "models/__init__.py", "serve/quant.py", "utils/profiling.py", "utils/meters.py",
                "utils/cadence.py", "nas/latency.py", "apps/base.yml", "apps/mobilenet_v3_large.yml",
                "apps/serve_mobilenet_v3.yml", "apps/atomnas_a_search.yml", "apps/atomnas_b_search.yml",
                "apps/atomnas_c_search.yml", "apps/atomnas_c_se.yml", "apps/retrain_searched.yml",
                # copied with the serving bench's open-loop arm
                "serve/context.py", "serve/admission.py", "serve/faults.py",
                # the zoo, the front door, the router, the cascade and the fleet
                "serve/zoo.py", "serve/client.py", "serve/hedge.py", "serve/signals.py", "serve/router.py",
                "serve/cascade.py", "serve/brownout.py", "serve/frontend.py", "serve/autoscale.py",
                "serve/netchaos.py", "obs/fleet.py", "obs/watchdog.py", "cli/fleet.py", "apps/serve_fleet.yml",
                # the life of a run: the fault injector and the apps ROADMAP item 10 listed
                "train/faults.py", "apps/mobilenet_v2.yml", "apps/eval_mobilenet_v2.yml", "apps/mobilenet_v3_small.yml",
                "apps/efficientnet_b0.yml", "apps/mobilenet_v1.yml", "apps/mnasnet_a1_v4_8.yml",
                # the real-data input path: the native loader, its C++ and the profiling CLI
                "data/native_loader.py", "csrc/yamt_loader.cc", "cli/profile.py"):
        assert f"yet_another_mobilenet_series_tpu_torch/{mod}" in names, mod
    assert set(DIFFERENT) <= names


@pytest.mark.parametrize("copy,src", COPIES, ids=[c for c, _ in COPIES])
def test_copy_equals_its_source_apart_from_the_header(copy, src):
    assert src.startswith(("yet_another_mobilenet_series_tpu/", "native/")), src
    assert os.path.exists(os.path.join(REPO, src)), src
    got, want = _lines(copy), _lines(src)
    # the header: the copy's leading comment lines before the source's text
    c = _comment(copy)
    n = next(i for i, line in enumerate(got) if not line.startswith(c) or i >= 6)
    assert 2 <= n <= 6 and all(line.startswith(c) for line in got[:n]), got[:n]
    kind = DIFFERENT.get(copy)
    if kind is None:
        for h in range(2, n + 1):
            if got[h:] == want:
                return
        pytest.fail(f"{copy} differs from {src} beyond its {n}-line header")
    elif kind == "one line":
        body = got[2:]
        diff = [(a, b) for a, b in zip(body, want) if a != b]
        assert len(body) == len(want) and len(diff) == 1, diff
        # the source's line names the change that made it; the copy starts at its second word
        (line, src_line), = diff
        assert line == "Back-to-back runs removed the completion WAKE-UP between batches on", line
        assert src_line.endswith(" back-to-back runs removed the completion WAKE-UP between batches on"), src_line
    elif kind == "hunks":
        body = got[2:]
        if copy.endswith("cli/fleet.py"):
            renumbered = [CHANGE_NUMBER.sub("", line) for line in want]
            assert sum(a != b for a, b in zip(want, renumbered)) == 2
            want = renumbered
        hunks = []
        for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(a=want, b=body, autojunk=False).get_opcodes():
            if tag != "equal":
                hunks.append((want[i1:i2], body[j1:j2]))
        want_hunks = {"cli/fleet.py": FLEET_DIFF, "serve/frontend.py": FRONTEND_DIFF, "train/faults.py": FAULTS_DIFF,
                      "data/native_loader.py": NATIVE_LOADER_DIFF}
        assert hunks == next(v for k, v in want_hunks.items() if copy.endswith(k)), hunks
    elif kind == "comments":
        def settings(lines):
            return [line for line in lines if line.strip() and not line.lstrip().startswith("#")]

        assert settings(got) == settings(want)
    else:
        _same_numpy_helpers(copy, src)


def _same_numpy_helpers(copy, src):
    """Every top-level function and class of the source is in the copy; all
    but the two torch twins have the same code (docstrings aside), and the
    module-level assignments are the same."""
    def defs(path):
        tree = ast.parse("\n".join(_lines(path)))
        out, assigns = {}, []
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                body = node.body[1:] if (node.body and isinstance(node.body[0], ast.Expr)
                                         and isinstance(node.body[0].value, ast.Constant)) else node.body
                out[node.name] = ast.dump(ast.Module(body=body, type_ignores=[])) + ast.dump(node.args) \
                    if isinstance(node, ast.FunctionDef) else ast.dump(ast.Module(body=body, type_ignores=[]))
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                assigns.append(ast.dump(node))
        return out, assigns

    got, got_assigns = defs(copy)
    want, want_assigns = defs(src)
    twins = {"denormalize_device", "calibrate_and_quantize"}
    assert set(got) == set(want)
    assert {k for k in want if got[k] != want[k]} == twins
    assert got_assigns == want_assigns


# ---------------------------------------------------------------------------
# costs from shapes: per dispatch, per fused K, per ring window
# ---------------------------------------------------------------------------


def test_dispatched_flops_are_twice_the_profiler_macs_per_row(tmp_path):
    net = get_model(ModelConfig(arch="mobilenet_v3_small", width_mult=0.35, num_classes=10), image_size=32)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    bundle = export.load_bundle(export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / "b")))
    eng = InferenceEngine(bundle, device="cpu", buckets=(2, 4), fuse_ladder=(2,), overlap_staging=True,
                          ring_slots=2)
    eng.warmup()
    per_image = 2.0 * profile_network(net, 32).total_macs
    reg = get_registry()
    assert reg.snapshot()["obs.cost_flops.serve_b2_s32_k1"] == obs_device.flops_for("serve_b2_s32_k1") == 2 * per_image
    assert obs_device.flops_for("serve_b4_s32_k2") == 8 * per_image
    assert obs_device.flops_for("serve_b4_s32_ring2") == 8 * per_image
    assert obs_device.bytes_for("serve_b4_s32_k2") > 0

    def dispatched(fn):
        s0 = reg.snapshot()
        fn()
        s1 = reg.snapshot()
        return (s1["serve.dispatched_flops"] - s0.get("serve.dispatched_flops", 0),
                s1["serve.dispatched_bytes"] - s0.get("serve.dispatched_bytes", 0))

    x = np.zeros((8, 32, 32, 3), np.float32)
    flops, nbytes = dispatched(lambda: eng.predict(x[:1]))  # a bucket-2 dispatch: its padded row computes too
    assert flops == 2 * per_image and nbytes == obs_device.bytes_for("serve_b2_s32_k1")
    flops, nbytes = dispatched(lambda: eng.predict(x))  # 8 rows: one fused K=2 dispatch at bucket 4
    assert flops == 2 * 4 * per_image and nbytes == obs_device.bytes_for("serve_b4_s32_k2")
    flops, _ = dispatched(lambda: eng.ring_dispatch([eng.ring_stage(x[:3])]).result())  # 1 of 2 slots
    assert flops == 4 * per_image
    snap = reg.snapshot()
    assert snap["serve.achieved_flops_per_s"] > 0


def test_engine_cost_keys_are_tagged_by_wire_weights_and_dtype(tmp_path):
    net = get_model(ModelConfig(arch="mobilenet_v3_small", width_mult=0.35, num_classes=10), image_size=32)
    gen = torch.Generator().manual_seed(1)
    params, _ = net.init(gen)
    bundle = export.load_bundle(export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / "b")))
    f32 = obs_device.forward_cost(net, 32, 1, 4)
    InferenceEngine(bundle, device="cpu", buckets=(1,), wire="uint8", compute_dtype="bfloat16").warmup()
    assert obs_device.flops_for("serve_b1_s32_k1_u8_bf16") == f32["flops"]
    assert obs_device.bytes_for("serve_b1_s32_k1_u8_bf16") == f32["bytes"] / 2  # bf16 moves half the bytes

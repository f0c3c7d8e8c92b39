"""Import hygiene of the port: it never imports JAX or the JAX package.

The port has to run on a CUDA machine that has no JAX, and it keeps its
own copies of the JAX package's modules that are free of JAX. A fresh
subprocess imports every module of the port and chip_smoke.py, runs a tiny
forward on the CPU, a fused-K and a ring dispatch, one train step, a
data-parallel step, a grouped step and the replica check over a gloo world
of one, one step of ``cli/train.py``, a checkpoint saved and restored, a warm start
from the run's checkpoint and an export from it, one prune event, one rematerialization, the
training bench's CPU rehearsal, a two-tenant engine behind a started
``Frontend`` answering one ``/predict`` (with ``cli/fleet.py`` imported), a
``cli/train.py`` run from an image folder and an eval pass over TFRecord
shards, a tuning file decided and applied, the BN A/B's, the input bench's
and the chaos round's CPU rehearsals and the TFRecord writer, a serving
mesh of two CPU lanes, the serve bench's overload and partition rounds and
the data-parallel dry run in one gloo rank, one run of the analyzer, a
buffered TFRecord train stream, the post-run report and the trace merge, and
checks ``sys.modules`` (no TensorFlow either); an AST scan of
the sources catches an import on a path that the subprocess does not run.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import yet_another_mobilenet_series_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "yet_another_mobilenet_series_tpu")

_CHILD = r"""
import importlib, os, pkgutil, sys
import numpy as np
import torch
import yet_another_mobilenet_series_tpu_torch as port

names = sorted(m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."))
for name in names:
    if not name.endswith(".__main__"):  # analysis/__main__.py runs the analyzer's CLI and exits
        importlib.import_module(name)
import chip_smoke

_, shapes = chip_smoke.mbv3_depthwise_shapes(32)
assert len(shapes) == 15, shapes

from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

net = get_model(ModelConfig(arch="mobilenet_v3_small", width_mult=0.35, num_classes=10), image_size=32)
gen = torch.Generator().manual_seed(0)
params, _ = net.init(gen)
bundle_dir = sys.argv[1]
export.export_bundle(net, params, random_bn_state(net, gen), bundle_dir)
out = InferenceEngine(export.load_bundle(bundle_dir), device="cpu", buckets=(2,)).predict(
    np.zeros((3, 32, 32, 3), np.float32))
assert out.shape == (3, 10) and np.isfinite(out).all()
# the engine's other paths: a fused K=2 dispatch through overlapped staging
# on the uint8 wire, and a ring window
eng = InferenceEngine(export.load_bundle(bundle_dir), device="cpu", buckets=(2,), fuse_ladder=(2,),
                      overlap_staging=True, ring_slots=2, wire="uint8")
eng.warmup()
h = eng.predict_async(np.zeros((4, 32, 32, 3), np.uint8))
assert h.dispatches == 1 and h.result().shape == (4, 10)
ring = eng.ring_dispatch([eng.ring_stage(np.zeros((2, 32, 32, 3), np.uint8)),
                          eng.ring_stage(np.zeros((1, 32, 32, 3), np.uint8))]).result()
assert ring.shape == (3, 10) and np.isfinite(ring).all()
# the training path: one step of make_train_step, one step of cli/train.py
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.config import config_from_dict, parse_cli
from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

cfg = config_from_dict({"model": {"arch": "mobilenet_v3_small", "width_mult": 0.35, "num_classes": 10},
                        "train": {"compute_dtype": "float32"}})
tnet = get_model(cfg.model, image_size=32)
lr_fn = schedules.make_lr_schedule(cfg.schedule, 4, 1, 1)
opt = optim.make_optimizer(cfg.optim, lr_fn, tnet.init(torch.Generator().manual_seed(0))[0])
ts = steps.init_train_state(tnet, cfg, opt, torch.Generator().manual_seed(0), device="cpu")
ts, m = steps.make_train_step(tnet, cfg, opt, lr_fn)(
    ts, {"image": torch.zeros(4, 32, 32, 3), "label": torch.arange(4)}, torch.Generator().manual_seed(1))
assert int(ts.step) == 1 and np.isfinite(float(m["loss"]))
# data parallel: a gloo world of one, its DP step, a grouped step and the
# replica check
import torch.distributed as dist
from yet_another_mobilenet_series_tpu_torch.parallel import dp, make_mesh

dist.init_process_group("gloo", init_method="file://" + sys.argv[1] + "_store", rank=0, world_size=1)
mesh = make_mesh("cpu", dist.group.WORLD)
dstep = dp.make_dp_train_step(tnet, cfg, opt, lr_fn, mesh)
dbatch = {"image": torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(2)), "label": torch.arange(4)}
dgen = dp.rank_generator(0, mesh)
ts2, _ = dstep(steps.init_train_state(tnet, cfg, opt, torch.Generator().manual_seed(0), device="cpu"), dbatch, dgen)
ts3, ms = dp.make_grouped_train_step(dstep, 2, mesh=mesh)(ts2, [dbatch, dbatch], dgen)
assert int(ts3.step) == 3 and len(ms) == 2 and float(dp.make_replica_sync_check(mesh)(ts3.params)) == 0.0
dist.destroy_process_group()
summary = train_cli.run(parse_cli([
    "app:" + os.path.join(os.path.dirname(port.__file__), "apps", "mobilenet_v3_large.yml"), "data.dataset=fake",
    "model.width_mult=0.35", "model.num_classes=10", "data.image_size=32", "train.batch_size=4",
    "data.fake_train_size=4", "data.fake_eval_size=4", "train.eval_batch_size=4", "train.epochs=1",
    "train.log_dir=" + sys.argv[1] + "_train"]), device="cpu")
assert summary["steps"] == 1 and summary["finite_steps"] == 1, summary
# the life of a run: a save and its restore, a warm start from the run's
# checkpoint, and an export from it
from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager

mgr = CheckpointManager(sys.argv[1] + "_ckpt")
mgr.save(1, tnet, ts, extra={"epoch": 1.0}, items={"generator": torch.Generator().get_state()})
mgr.wait()
rstep, rnet, _ = mgr.restore_spec()
tree = mgr.restore_tree(rstep, steps.train_state_to_dict(ts))
assert rnet == tnet and int(tree["step"]) == 1 and tree["generator"].dtype == torch.uint8
mgr.close()
warm = train_cli.run(parse_cli([
    "app:" + os.path.join(os.path.dirname(port.__file__), "apps", "mobilenet_v3_large.yml"), "data.dataset=fake",
    "model.width_mult=0.35", "model.num_classes=10", "data.image_size=32", "train.batch_size=4",
    "data.fake_train_size=4", "data.fake_eval_size=4", "train.eval_batch_size=4", "train.epochs=1",
    "train.pretrained=" + sys.argv[1] + "_train/ckpt", "train.log_dir=" + sys.argv[1] + "_warm"]), device="cpu")
assert warm["steps"] == 1 and warm["resumed_from"] is None, warm
exported = export.export_checkpoint(sys.argv[1] + "_train/ckpt", sys.argv[1] + "_exported", device="cpu")
assert export.load_bundle(exported).meta["step"] == 1
# the search: one prune event on a supernet whose block-1 gammas are below
# the threshold, then one rematerialization
from yet_another_mobilenet_series_tpu_torch.config import PruneConfig
from yet_another_mobilenet_series_tpu_torch.nas import masking, rematerialize
from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

snet = get_model(ModelConfig(arch="atomnas_supernet", width_mult=0.35, num_classes=10), image_size=32)
sp, ss = snet.init(torch.Generator().manual_seed(0))
sp["blocks"]["1"]["dw_bn"]["gamma"][::2] = 0.0
event = masking.make_prune_event(snet, PruneConfig(enable=True, mask_interval=1), stop_step=10, device="cpu")
masks, _ = event(sp, masking.init_masks(snet, "cpu"), None, torch.ones((), dtype=torch.int32))
assert masking.mask_summary(snet, masks)["alive_atoms"] < sum(m.numel() for m in masks.values())
small, *_ = rematerialize.rematerialize(snet, sp, ss, masks)
assert profile_network(small).total_macs < profile_network(snet).total_macs
# a bench: the training bench's CPU rehearsal, one JSON line
import contextlib, io, json
from yet_another_mobilenet_series_tpu_torch.bench import train_bench
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = train_bench.main(["--device", "cpu", "--batch", "2", "--image-size", "32", "--width-mult", "0.35",
                           "--num-classes", "10", "--steps", "1", "--warmup", "1", "--profile-steps", "0"])
line = json.loads(buf.getvalue())
assert rc == 0 and line["cpu_rehearsal"] is True and line["value"] is None, line
# the serving tier: a two-tenant engine behind the front door, one request
from yet_another_mobilenet_series_tpu_torch.cli import fleet as fleet_cli
from yet_another_mobilenet_series_tpu_torch.serve.admission import AdmissionController
from yet_another_mobilenet_series_tpu_torch.serve.client import ReplicaClient
from yet_another_mobilenet_series_tpu_torch.serve.frontend import Frontend
from yet_another_mobilenet_series_tpu_torch.serve.pipeline import PipelinedBatcher

b = export.load_bundle(bundle_dir)
zoo_eng = InferenceEngine(models={"small": b, "big": b}, device="cpu", buckets=(1,))
zoo_eng.warmup()
batcher = PipelinedBatcher(zoo_eng, max_batch=1, max_wait_ms=1.0).start()
fe = Frontend(AdmissionController(batcher, models=zoo_eng.models, default_model="small"), port=0).start()
client = ReplicaClient("127.0.0.1", fe.port, timeout_s=60.0)
x = np.zeros((32, 32, 3), np.float32)
assert np.array_equal(client.predict(x, model="big"), zoo_eng.predict(x[None], model="big")[0])
client.close()
fe.stop()
batcher.stop(drain=True)
assert fleet_cli.FleetSupervisor is not None
# the real-data input path: a training run from an image folder (the native
# loader) and the same images read back from TFRecord shards
from yet_another_mobilenet_series_tpu_torch.data import jpeg_corpus, make_eval_source
from yet_another_mobilenet_series_tpu_torch.config import DataConfig

jroot = sys.argv[1] + "_jpegs"
jpeg_corpus.write_image_folder(jroot, "train", 2, 4)
val = jpeg_corpus.write_image_folder(jroot, "val", 2, 3)
jpeg_corpus.write_tfrecords(jroot, "val", val, 2)
folder = train_cli.run(parse_cli([
    "app:" + os.path.join(os.path.dirname(port.__file__), "apps", "mobilenet_v2.yml"), "data.dataset=folder",
    "data.loader=native", "data.data_dir=" + jroot, "data.val_split=val", "data.num_train_examples=8",
    "data.image_size=32", "data.eval_resize=36", "model.width_mult=0.35", "model.num_classes=2",
    "train.batch_size=4", "train.eval_batch_size=4", "train.epochs=1", "data.decode_threads=2",
    "train.log_dir=" + sys.argv[1] + "_folder"]), device="cpu")
assert folder["steps"] == 2 and folder["eval_n"] == 6, folder
recs = list(make_eval_source(DataConfig(dataset="imagenet", data_dir=jroot, val_split="val", image_size=32,
                                        eval_resize=36, num_eval_examples=6), 4, device="cpu"))
assert len(recs) == 2 and int((recs[1]["label"] >= 0).sum()) == 2
# the training-side tools: a tuning file applied, an A/B decided, each
# bench's CPU rehearsal, the chaos round and the TFRecord writer
from yet_another_mobilenet_series_tpu_torch.bench import bn_bench, input_bench, train_chaos, tuning_decide
from yet_another_mobilenet_series_tpu_torch.data import to_tfrecords
from yet_another_mobilenet_series_tpu_torch.train import tuning

tdir = sys.argv[1] + "_tools"
os.makedirs(tdir)
with open(tdir + "/ab.json", "w") as f:
    json.dump({"platform": "cuda", "partial": False, "device_kind": "card", "rows": [
        {"bn_mode": "exact", "remat": "off", "conv1x1_dot": False, "ms_per_step": 100.0, "loss": 6.9},
        {"bn_mode": "folded", "remat": "off", "conv1x1_dot": False, "ms_per_step": 90.0, "loss": 6.9}]}, f)
tuning_decide.decide(tdir + "/ab.json", tdir + "/decision.json", tdir + "/tuning.json")
tcfg, tlines = tuning.apply_tuning_file(parse_cli(["train.tuning_file=" + tdir + "/tuning.json"]))
assert tcfg.train.bn_mode == "folded" and tlines, tlines
for mod, argv in ((bn_bench, ["--variants", "exact:0", "--iters", "1", "--batch", "2", "--device", "cpu"]),
                  (input_bench, ["--pipeline", "native", "--data-dir", jroot, "--batch", "2", "--batches", "1",
                                 "--image-size", "16", "--threads", "1", "--device", "cpu"]),
                  (train_chaos, ["--device", "cpu", "--log-dir", tdir + "/chaos"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    line = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and "error" not in line, line
assert len(to_tfrecords.convert(jroot + "/train", tdir + "/records", "train", 2)) == 2
# the serving mesh (two CPU lanes), the serve bench's overload storm round
# over it and its partition round over an echo replica behind the router,
# and the data-parallel dry run in one gloo rank
from yet_another_mobilenet_series_tpu_torch import graft_entry
from yet_another_mobilenet_series_tpu_torch.bench import serve_bench
from yet_another_mobilenet_series_tpu_torch.parallel import make_serving_mesh
from yet_another_mobilenet_series_tpu_torch.serve.router import Router

meng = InferenceEngine(export.load_bundle(bundle_dir), device="cpu", buckets=(2,), mesh=make_serving_mesh(2, "cpu"))
assert meng.predict(np.zeros((3, 32, 32, 3), np.float32)).shape == (3, 10)
ob = PipelinedBatcher(meng, max_batch=2, max_wait_ms=1.0).start()
orn = serve_bench._overload_round(AdmissionController(ob), {c: np.zeros((32, 32, 3), np.float32)
                                                            for c in serve_bench.OVERLOAD_CLASS_MIX},
                                  seed=0, n_requests=6, target_qps=200.0, deadline_ms_by_class={})
ob.stop(drain=True)
assert orn["unresolved"] == 0 and sum(c["completed"] for c in orn["classes"].values()) == 6, orn
eb = PipelinedBatcher(serve_bench._EchoEngine(), max_batch=2, max_wait_ms=1.0).start()
efe = Frontend(AdmissionController(eb), port=0).start()
router = Router([("127.0.0.1", efe.port)], poll_interval_s=0.1).start()
prn = serve_bench._partition_round(router, np.full((8, 8, 3), 3.0, np.float32), n_requests=4, target_qps=100.0,
                                   seed=0)
router.stop()
efe.stop()
eb.stop()
assert prn["completed"] == 4, prn
dry = graft_entry.dryrun_multichip(1, device="cpu")
assert dry["backend"] == "gloo" and dry["ranks"][0]["steps"] == [1, 2], dry
# one run of the port's analyzer over a fixture of one of its torch twins
from yet_another_mobilenet_series_tpu_torch.analysis import run_lint

lint_dir = os.path.join(os.path.dirname(os.path.dirname(port.__file__)), "tests", "fixtures", "torch_lint",
                        "yamt001", "bad")
assert {f.rule for f in run_lint([lint_dir])} == {"YAMT001"}
# the TFRecord train stream with its interleave and record buffer, and the
# post-run tools: the report of the folder run, a merge of one trace
from yet_another_mobilenet_series_tpu_torch.data import pipeline as data_pipeline
from yet_another_mobilenet_series_tpu_torch.obs import report as obs_report
from yet_another_mobilenet_series_tpu_torch.obs import trace_merge

rstream = data_pipeline.RecordTrainStream(DataConfig(dataset="imagenet", data_dir=tdir + "/records", image_size=16,
                                                     decode_threads=2, shuffle_buffer=4), 2, 0)
assert rstream.buffer == 4 and next(rstream)["image"].shape == (2, 16, 16, 3)
rstream.close()
os.makedirs(tdir + "/fleet/r0")
with open(tdir + "/fleet/r0/obs_trace.json", "w") as f:
    json.dump({"pid": 1, "process_name": "r0", "origin_unix": 1.0, "traceEvents": []}, f)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert obs_report.main([sys.argv[1] + "_folder"]) == 0 and trace_merge.main([tdir + "/fleet"]) == 0
assert "## training (host syncs / checkpoints / input)" in buf.getvalue(), buf.getvalue()
# the zoo's remaining families, each from chip_smoke.py's phase 17 config
# (its shipped app), one eval forward at a tiny width
for arch, _, _ in chip_smoke.FAMILIES:
    fcfg = chip_smoke.family_cfg(arch, tdir, "model.width_mult=0.35", "model.num_classes=10")
    fnet = get_model(fcfg.model, image_size=32)
    fgen = torch.Generator().manual_seed(1)
    flog = fnet.apply(fnet.init(fgen)[0], random_bn_state(fnet, fgen), torch.zeros((1, 32, 32, 3)))
    assert fcfg.model.arch == arch and flog.shape == (1, 10) and torch.isfinite(flog).all(), arch
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "yet_another_mobilenet_series_tpu", "tensorflow")
             or m.startswith(("jax.", "jaxlib.", "yet_another_mobilenet_series_tpu.", "tensorflow.")))
print("MODULES", len(names), "FORBIDDEN", bad)
"""


def test_fresh_process_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # one torch thread: the child's work is small, and beside the suite's
    # other workers every core it would spread over is busy
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path / "bundle")], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("MODULES"))
    n_modules = int(line.split()[1])
    assert n_modules >= 40, line  # every module of the port was imported
    assert line.endswith("FORBIDDEN []"), line


def _sources():
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    """(absolute module name, node) of every import in ``path``; relative
    imports are resolved against the file's package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    # the package a relative import starts from (a.b for a/b/c.py and a/b/__init__.py)
    pkg = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".").split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert len(pkg) >= node.level, (path, node.lineno)  # not above the repo root
                base = pkg[: len(pkg) - (node.level - 1)]
                yield ".".join(base + ([node.module] if node.module else [])), node
            else:
                yield node.module, node


def test_ast_scan_finds_no_jax_import():
    seen = 0
    for path in _sources():
        for name, node in _imports(path):
            seen += 1
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
    assert seen > 50


def test_relative_imports_stay_inside_the_port():
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue
        for name, node in _imports(path):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert name.startswith("yet_another_mobilenet_series_tpu_torch"), \
                    f"{os.path.relpath(path, REPO)}:{node.lineno} resolves to {name}"


def test_every_module_is_reachable_by_walk_packages():
    """The subprocess imports what walk_packages finds: every directory of
    the port with Python files is a package, so no module escapes it."""
    names = {m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")}
    for path in _sources():
        if path.endswith("chip_smoke.py") or path.endswith("__init__.py"):
            continue
        mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        assert mod in names, mod


ANALYZER_DIR = os.path.join(PORT_DIR, "analysis")


def test_analyzer_imports_neither_torch_nor_jax():
    """The analyzer is pure-stdlib AST: no module of it imports torch, numpy
    or jax (an AST scan), and a fresh process that loads every rule and lints
    a fixture has none of them in ``sys.modules``."""
    for f in sorted(os.listdir(ANALYZER_DIR)):
        if f.endswith(".py"):
            for name, node in _imports(os.path.join(ANALYZER_DIR, f)):
                assert name.split(".")[0] not in ("torch", "numpy", *FORBIDDEN), f"analysis/{f}:{node.lineno} {name}"
    code = ("import sys\n"
            "from yet_another_mobilenet_series_tpu_torch.analysis import load_rules, run_lint\n"
            f"assert len(load_rules()) == 25 and run_lint([{os.path.join(REPO, 'tests', 'fixtures', 'torch_lint')!r}])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax', 'jaxlib')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]", proc.stdout

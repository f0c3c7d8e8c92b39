"""Import hygiene of the port: it never imports JAX or the JAX package.

The port has to run on a CUDA machine that has no JAX, and it keeps its
own copies of the JAX package's modules that are free of JAX. A fresh
subprocess imports every module of the port and chip_smoke.py, runs a tiny
forward on the CPU, a fused-K and a ring dispatch, one train step, one
step of ``cli/train.py``, a checkpoint saved and restored, a warm start
from the run's checkpoint and an export from it, one prune event, one rematerialization, the
training bench's CPU rehearsal, and a two-tenant engine behind a started
``Frontend`` answering one ``/predict`` (with ``cli/fleet.py`` imported), and
checks ``sys.modules``; an AST scan of the sources catches an import on a
path that the subprocess does not run.
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
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "yet_another_mobilenet_series_tpu")
             or m.startswith(("jax.", "jaxlib.", "yet_another_mobilenet_series_tpu.")))
print("MODULES", len(names), "FORBIDDEN", bad)
"""


def test_fresh_process_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
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

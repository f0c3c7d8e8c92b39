"""Training entry point of the port: ``python -m
yet_another_mobilenet_series_tpu_torch.cli.train app:<yaml> [key=value ...]
[--device cpu]``, the torch twin of ``yet_another_mobilenet_series_tpu/cli/train.py``.

It trains on ``cuda`` unless ``--device cpu`` (parsed as ``cli/serve.py``
parses it), and asking for CUDA without a card raises. The loop is the JAX
package's: the epoch/step loops, the log cadence, the step guard, eval on
the EMA shadow weights at the eval cadence and at the end, and the
telemetry files in ``train.log_dir`` (``metrics.jsonl``,
``obs_registry.json`` and, with ``obs.trace``, the span trace).
TensorBoard is off: the card's machine has no TensorFlow.

**Data parallel** (``parallel/``): one process (rank) per device, in a
process group whose backend follows the device (NCCL on cards, gloo on the
CPU). ``dist.multihost=true`` joins torchrun's ``env://`` rendezvous
(``python -m torch.distributed.run --nproc_per_node N -m
yet_another_mobilenet_series_tpu_torch.cli.train ...``);
``dist.num_devices=N > 1`` without it has :func:`run` start N local ranks
itself on a loopback store (0 is every card; asking for more cards than
the machine has raises). ``train.batch_size`` and ``train.eval_batch_size``
are global: each rank draws its slice of every batch. SyncBN
(``dist.sync_bn``), the gradient and metric averages and the ZeRO update
(``dist.shard_optimizer``) are the step's (``parallel/dp.py``). Only the
coordinator (rank 0) logs and writes files; checkpoints hold the gathered
optimizer state, so a run resumes at any world size. Every
``train.param_checksum_every`` steps the replica check reads how far any
rank's weights are from rank 0's, and a non-zero answer stops the run.

**The grouped step** (``train.steps_per_dispatch`` = K > 1): K steps in
one dispatch while an epoch has K steps left, single steps for the rest,
as the JAX CLI does. On a card it is one CUDA graph of K steps (with the
prune event after each in a search), captured at its first dispatch and
rebuilt after a rematerialization; over gloo and on the CPU the K steps
run eagerly: the grouped step's log line says which, and the first log
row carries ``grouped_k`` and ``grouped_graph`` (1 for a graph).

Each step is eager PyTorch (``train/steps.py``) and never waits on the
device: the metrics stay on it until a log point (every
``train.log_every`` steps) reads them, with the guard's verdicts, in one
go.

**The data** (``data/``): the fake dataset made on the device, or real
JPEGs decoded on the host, from an image folder (``data.dataset=folder``,
the port's copy of the native C++ loader) or ImageNet TFRecord shards
(``imagenet``, read without TensorFlow). ``steps_per_epoch`` is the
dataset's size (``data.num_train_examples`` for real data, as in the JAX
CLI) over ``train.batch_size``. Host batches reach the device through
``parallel/mesh.py`` ``prefetch_to_device`` (pinned memory, a copy stream,
``data.device_prefetch`` deep), and RandAugment runs on the device after
it (``data/randaugment.py``). The loaders' decode failures are logged at
the end of every epoch and counted in the summary (``decode_failures``).

**The profiler window** (``train.profile_start_step`` = S > 0): on the
coordinator, a ``torch.profiler`` window opens after step S and closes
after step S + ``train.profile_num_steps`` (the device synchronised
first), written as a Chrome trace into ``<train.log_dir>/trace``; an exit
inside the window, a raise included, closes and writes it. It needs single
steps, so ``train.steps_per_dispatch`` > 1 is forced to 1 with a warning,
as in the JAX CLI. The summary's ``profile`` says where the trace went.

TF32 follows ``train.compute_dtype`` (``utils/device.py`` ``set_tf32``):
off for float32, on for bfloat16, set when the run starts whatever the
process set before, and logged in the first log row (``tf32_cudnn``,
``tf32_matmul``). The step's cost, counted from shapes, lands in the
``train_step`` cost gauges once per Trainer (``obs/device.py``).

With ``prune.enable`` it runs the AtomNAS search as the JAX CLI does: the
FLOPs-weighted gamma penalty inside the step, the prune event on the
device every ``prune.mask_interval`` steps up to ``prune_stop_step``
(``nas/masking.py``; it waits on nothing), the effective MACs (and, for the
adaptive schedule, rho_mult) read at log points, a rematerialization every
``prune.remat_epochs`` that rebuilds the Trainer on the shrunk network
(``nas/rematerialize.py``), and at the end a last one that writes
``searched_arch.json`` into ``train.log_dir``. With
``prune.cost=latency_table`` a rebuilt Trainer keeps each surviving atom's
measured cost (``_sliced_costs``): the table holds the supernet's blocks
only, and the JAX CLI, which looks the shrunk blocks up, fails there.

The life of a run is the JAX CLI's (``ckpt/manager.py``):

- **checkpoints** in ``<train.log_dir>/ckpt`` every
  ``train.checkpoint_every_epochs`` and at the end (``train.max_checkpoints``
  kept), each with the network spec, the TrainState, the step generator's
  state, and ``epoch``/``best_top1`` (and, in a latency-table search, the
  penalty's sliced atom costs); with ``train.keep_best``, the best eval's in
  ``ckpt_best/``. A save returns once the state is snapshotted to host
  memory; a thread writes it. Every exit path waits for the writes, then
  closes the managers. Without ``train.log_dir`` nothing is saved;
- **resume** (``train.resume``, on by default): the newest checkpoint that
  restores, walking back over a corrupt or half-written one (digest-verified;
  ``ckpt.restore_fallbacks``); the spec first, so an AtomNAS run is rebuilt
  at its pruned shape before a weight loads; the data stream continues at the
  restored step, and the step generator where it was. A
  ``preempt_marker.json`` left by a preempted run is consumed;
- **warm starts** from ``train.torch_pretrained`` (a torchvision-layout
  ``state_dict``, ``ckpt/torch_import.py``) or ``train.pretrained`` (a port
  checkpoint dir), with a fresh optimizer, step and EMA shadow;
- **eval-only runs** (``train.test_only``): one eval pass of the imported
  weights, of ``train.pretrained``'s newest checkpoint or of the run's own;
- **preemption**: SIGTERM or SIGINT stops the loop at the next step
  boundary, saves a checkpoint synchronously, writes ``preempt_marker.json``
  and returns ``preempted`` (``train.preemptions``);
- **the fault injector** (``train.faults``, ``train/faults.py``) under the
  corrupt-record skip, and the stall watchdog (``obs.watchdog_deadline_s``).

**The tuning file** (``train.tuning_file``, ``train/tuning.py``): a JSON
file that ``bench/tuning_decide.py`` writes from ``bench/bn_bench.py``'s A/B
on the card. :func:`run` applies it first, before the group, the mesh or any
CUDA touch, as the JAX CLI does: its ``bn_mode``, ``remat``,
``remat_policy``, ``conv1x1_dot`` and ``steps_per_dispatch`` override the
YAML's (a tuned K > 1 takes the grouped step), and its provenance lines are
logged once the logger exists, with the step config that runs. A malformed
file, an unknown key, or XLA flags (``flags``, which mean nothing to torch)
raise. Eval stays on exact BN and the stock convs whatever the file says
(``train/steps.py`` ``make_eval_step``).
"""

from __future__ import annotations

import dataclasses as dc
import json
import multiprocessing
import os
import queue as queue_lib
import signal
import socket
import sys
import time

import numpy as np
import torch

from ..ckpt.manager import CheckpointCorrupt, CheckpointManager
from .. import data as data_sources
from ..config import Config, parse_cli
from ..data import pipeline as data_lib
from ..models import get_model
from ..models.serialize import network_to_dict
from ..models.specs import Network
from ..nas import masking, penalty, rematerialize
from ..obs import device as obs_device
from ..obs import registry as obs_registry
from ..obs import trace as obs_trace
from ..obs.watchdog import StallWatchdog
from ..parallel import dp, mesh as mesh_lib, zero
from ..train import optim, schedules, steps
from ..train.guard import StepGuard
from ..utils.cadence import StepCadence
from ..utils.device import set_tf32
from ..utils.logging import Logger
from ..utils.meters import MetricLogger, format_metrics
from ..utils.profiling import profile_network
from .serve import parse_device

# written next to the checkpoint on a clean preemption exit; consumed (and
# removed) by the next resumed run
PREEMPT_MARKER_NAME = "preempt_marker.json"


def _apply_tuning(cfg: Config) -> tuple[Config, list[str]]:
    """``cfg`` with ``train.tuning_file``'s step config applied, and the
    provenance lines to log; ``cfg`` and no lines without a file."""
    if not cfg.train.tuning_file:
        return cfg, []
    from ..train import tuning as tuning_lib

    return tuning_lib.apply_tuning_file(cfg)


def _dataset_sizes(cfg: Config) -> tuple[int, int]:
    if cfg.data.dataset == "fake":
        return cfg.data.fake_train_size, cfg.data.fake_eval_size
    return cfg.data.num_train_examples, cfg.data.num_eval_examples


def _decode_failures() -> int:
    """Records the real-data loaders could not decode, in this process: the
    native loaders' (live ones) and the TFRecord streams' counter. A run
    reports its own: the difference from its start."""
    from ..data import native_loader

    return (native_loader.total_decode_failures()
            + int(obs_registry.get_registry().counter("data.record_decode_failures").value))


class Trainer:
    """Builds and owns the step functions of one rank's run; rebuilt whole by
    a rematerialization (the network's shapes changed). ``mesh`` is the
    rank's data-parallel world (default: one process on ``device``).
    ``atom_costs`` replaces the penalty's cost vectors (a rebuild in
    latency-table mode passes its predecessor's, sliced)."""

    def __init__(self, cfg: Config, net: Network, device: str | torch.device = "cuda",
                 atom_costs: dict | None = None, mesh: mesh_lib.Mesh | None = None):
        self.cfg = cfg
        self.net = net
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(device)
        self.device = self.mesh.device
        self.local_batch = mesh_lib.local_batch_slice(cfg.train.batch_size, self.mesh)
        self.steps_per_epoch = max(_dataset_sizes(cfg)[0] // cfg.train.batch_size, 1)
        self.lr_fn = schedules.make_lr_schedule(cfg.schedule, cfg.train.batch_size, self.steps_per_epoch,
                                                cfg.train.epochs)
        params_example, _ = net.init(torch.Generator().manual_seed(0))
        self.zero = cfg.dist.shard_optimizer
        self.optimizer = optim.make_optimizer(cfg.optim, self.lr_fn, params_example,
                                              shard_group=self.mesh.group if self.zero else None)
        prune = cfg.prune.enable
        self.atom_costs = (atom_costs if atom_costs is not None else penalty.atom_cost_table(net, cfg.prune)
                           ) if prune else None
        self.penalty_fn = (penalty.make_penalty_fn(net, cfg.prune, self.steps_per_epoch, device=self.device,
                                                   costs=self.atom_costs) if prune else None)
        # the event's own gate is true exactly when the loop's host gate is
        self.prune_stop_step = int(cfg.prune.stop_epoch_frac * cfg.train.epochs * self.steps_per_epoch)
        self.prune_event = (masking.make_prune_event(net, cfg.prune, self.prune_stop_step, device=self.device)
                            if prune else None)
        # the guard's device half (a non-finite step rolled back on the
        # device, train/guard.py) wraps the step; StepGuard does the host
        # accounting
        self.train_step = dp.make_dp_train_step(net, cfg, self.optimizer, self.lr_fn, self.mesh,
                                                penalty_fn=self.penalty_fn, clip_shard_aware=self.zero)
        self.eval_step = dp.make_dp_eval_step(net, cfg, self.mesh)
        self.sync_check = dp.make_replica_sync_check(self.mesh)
        # the step's cost from shapes, as the JAX CLI records its cost_analysis:
        # the forward, and a backward that costs twice the forward (this
        # rank's share of the batch)
        itemsize = 2 if cfg.train.compute_dtype == "bfloat16" else 4
        fwd = obs_device.forward_cost(net, cfg.data.image_size, self.local_batch, itemsize)
        self.step_cost = obs_device.record_cost("train_step", {k: 3 * v for k, v in fwd.items()})

    def fresh_state(self, seed: int) -> steps.TrainState:
        """A new TrainState in the checkpoint form (the optimizer state
        params-shaped), on this rank's device."""
        return steps.init_train_state(self.net, self.cfg, self.optimizer, torch.Generator().manual_seed(seed),
                                      device=self.device)

    def place_state(self, ts: steps.TrainState) -> steps.TrainState:
        """A checkpoint-form TrainState made live: rank 0's values on every
        rank, and under ZeRO the optimizer state cut to this rank's shards
        (at this world's size, whatever the saved one's)."""
        ts = steps.train_state_from_dict(mesh_lib.replicate(steps.train_state_to_dict(ts), self.mesh))
        return ts.replace(opt_state=zero.scatter_opt_state(ts.opt_state, self.mesh)) if self.zero else ts

    def init_state(self, seed: int) -> steps.TrainState:
        return self.place_state(self.fresh_state(seed))

    def checkpoint_view(self, ts: steps.TrainState) -> steps.TrainState:
        """The live TrainState in the checkpoint form: the ZeRO shards
        gathered (a collective: every rank calls it)."""
        return ts.replace(opt_state=zero.gather_opt_state(ts.opt_state, ts.params, self.mesh)) if self.zero else ts


def evaluate(trainer: Trainer, ts: steps.TrainState, cfg: Config, fake: data_lib.FakeImages | None = None,
             watchdog: StallWatchdog | None = None) -> dict:
    """One eval pass on the EMA shadow weights (the live ones when EMA is
    off), over the configured eval set (``data.make_eval_source``; ``fake``:
    a ``FakeImages`` to evaluate on instead). The per-batch counts add up on
    the device (summed over the ranks by the eval step); the host reads them
    once, at the end. ``train.eval_batch_size`` is global: each rank takes
    its share of it (rounded up), over its shard of the eval set, and every
    rank runs the same number of batches (padded with label -1)."""
    tracer = obs_trace.get_tracer()
    params = ts.ema_params if cfg.ema.enable else ts.params
    state = ts.ema_state if cfg.ema.enable else ts.state
    mesh = trainer.mesh
    local_eval = -(-cfg.train.eval_batch_size // mesh.size)
    if fake is not None:
        batches = fake.eval_batches(local_eval, mesh.rank, mesh.size)
    else:
        batches = data_sources.make_eval_source(cfg.data, local_eval, mesh.rank, mesh.size, device=mesh.device)
        if data_sources.is_real(cfg.data):
            batches = mesh_lib.prefetch_to_device(batches, mesh.device, depth=cfg.data.device_prefetch)
    totals = None
    with tracer.span("eval/pass", "eval"):
        for batch in batches:
            m = trainer.eval_step(params, state, batch, ts.masks)
            totals = m if totals is None else {k: totals[k] + m[k] for k in m}
            if watchdog is not None:
                watchdog.arm(phase="eval")
        with tracer.span("sync/eval_gather", "sync"):
            host = ({k: float(v) for k, v in totals.items()} if totals is not None
                    else {"top1": 0.0, "top5": 0.0, "n": 0.0, "loss_sum": 0.0})
    obs_registry.get_registry().counter("eval.passes").inc()
    n = max(host["n"], 1.0)
    return {"top1": host["top1"] / n, "top5": host["top5"] / n, "loss": host["loss_sum"] / n, "n": int(host["n"])}


class _Preemption:
    """SIGTERM/SIGINT -> cooperative stop flag. The loop checks ``requested``
    at step boundaries and exits through the synchronous checkpoint (a
    preemption loses at most the in-flight step, not the epoch).

    Handlers install only in the main thread (embedded runs keep their
    own); the previous handlers are restored on uninstall, so an in-process
    caller (pytest) is left untouched."""

    def __init__(self, log: Logger):
        self._log = log
        self.requested = False
        self.reason = ""
        self._prev: dict = {}

    def _handle(self, signum, frame):
        self.requested = True
        self.reason = signal.Signals(signum).name
        self._log.log(f"{self.reason} received: will checkpoint and exit at the next step boundary")

    def install(self) -> "_Preemption":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:
                break  # not the main thread: cooperative flag only
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass  # uninstall from a non-main thread: nothing was installed
        self._prev.clear()


def _restore_tree(ckpt: CheckpointManager, step: int, target: dict, log: Logger) -> dict:
    """restore_tree with the NARROW legacy-rho_mult retry (the JAX CLI's):
    only when the saved tree demonstrably lacks the rho_mult item (or its
    item list is unreadable) is the step restored without it and the
    neutral multiplier put in; digest mismatches and the failures of a step
    that HAS the item propagate to the fallback walk."""
    try:
        return ckpt.restore_tree(step, target)
    except CheckpointCorrupt:
        raise  # verified corruption is never a legacy-layout quirk
    except Exception as e:  # noqa: BLE001 — a read error or a layout the target does not match
        if target.get("rho_mult") is None:
            raise
        saved = ckpt.tree_keys(step)
        if saved is not None and "rho_mult" in saved:
            log.log(f"restore at step {step} failed ({type(e).__name__}: {e}); saved tree HAS rho_mult, so this "
                    "is not a legacy checkpoint")
            raise
        log.log(f"restore with rho_mult failed ({type(e).__name__}); retrying as legacy checkpoint")
        tree = ckpt.restore_tree(step, {k: v for k, v in target.items() if k != "rho_mult"})
        tree["rho_mult"] = torch.ones((), device=target["rho_mult"].device)
        return tree


def _saved_costs(extra: dict) -> dict | None:
    """The penalty's atom costs a latency-table search saved with its
    checkpoint (``_extra``), as the Trainer takes them."""
    costs = extra.get("atom_costs")
    return None if costs is None else {k: np.asarray(v, dtype=np.float32) for k, v in costs.items()}


def _restore(ckpt: CheckpointManager, cfg: Config, mesh: mesh_lib.Mesh, log: Logger):
    """Two-phase resume (SURVEY.md §3.5): spec -> Trainer rebuilt at the
    (pruned) shape -> weights. Returns (trainer, ts, extra, this rank's
    generator state or None), or None when no checkpoint exists. The state
    comes back live (:meth:`Trainer.place_state`), at this world's size.

    Candidates are tried NEWEST FIRST; a step whose spec sidecar is
    unreadable, whose tree fails to restore, or whose bytes fail digest
    verification is logged, counted (``ckpt.restore_fallbacks``) and
    skipped for the previous step. Raises only when checkpoints exist but
    none restores."""
    candidates = ckpt.all_steps()
    if not candidates:
        return None
    last_err = None
    for i, step in enumerate(candidates):
        if i:
            obs_registry.get_registry().counter("ckpt.restore_fallbacks").inc()
            log.log(f"falling back to checkpoint step {step}")
        try:
            _, net, extra = ckpt.restore_spec(step)
        except Exception as e:  # noqa: BLE001 — a torn sidecar must not end resume
            log.log(f"checkpoint step {step}: spec sidecar unreadable ({type(e).__name__}: {e})")
            last_err = e
            continue
        costs = _saved_costs(extra) if cfg.prune.enable and cfg.prune.cost == "latency_table" else None
        trainer = Trainer(cfg, net, atom_costs=costs, mesh=mesh)
        try:
            tree = _restore_tree(ckpt, step, steps.train_state_to_dict(trainer.fresh_state(0)), log)
        except Exception as e:  # noqa: BLE001 — corrupt tree: walk back one step
            log.log(f"checkpoint step {step}: tree restore failed ({type(e).__name__}: {e})")
            last_err = e
            continue
        ts = trainer.place_state(steps.train_state_from_dict(tree))
        return trainer, ts, extra, _rank_generator_state(tree, mesh)
    raise RuntimeError(f"no restorable checkpoint: all {len(candidates)} candidate step(s) {candidates} failed — "
                       "see the per-step causes above") from last_err


def _rank_generator_state(tree: dict, mesh: mesh_lib.Mesh):
    """This rank's step-generator state from a restored tree: its row of
    ``rank_generators`` (saved by a world of several ranks), else, on rank
    0, ``generator``; None for a rank the saving world did not have."""
    rows = tree.get("rank_generators")
    if rows is not None and mesh.rank < rows.shape[0]:
        return rows[mesh.rank].contiguous()
    return tree.get("generator") if mesh.rank == 0 else None


def _generator_items(generator: torch.Generator, mesh: mesh_lib.Mesh) -> dict:
    """The step generators' states a save keeps: rank 0's as ``generator``
    and, in a world of several ranks, every rank's as ``rank_generators``
    (gathered: every rank calls this)."""
    state = generator.get_state()
    if mesh.group is None:
        return {"generator": state}
    rows = torch.empty(mesh.size * state.numel(), dtype=torch.uint8, device=mesh.device)
    torch.distributed.all_gather_into_tensor(rows, state.to(mesh.device), group=mesh.group)
    rows = rows.cpu().view(mesh.size, -1)
    return {"generator": rows[0].clone(), "rank_generators": rows}


def _init_or_warm_start(cfg: Config, net: Network, mesh: mesh_lib.Mesh,
                        log: Logger) -> tuple[Trainer, steps.TrainState]:
    """A fresh TrainState, or, with train.torch_pretrained / train.pretrained,
    a warm start: the weights and BN stats (and the masks of a pruned
    source) of the source, with a FRESH optimizer, step and EMA shadow (the
    EMA a copy of the weights, never an alias)."""
    if cfg.train.torch_pretrained:
        from ..ckpt.torch_import import load_torch_checkpoint

        params, state = load_torch_checkpoint(cfg.train.torch_pretrained, net)
        trainer = Trainer(cfg, net, mesh=mesh)
        ts = steps.with_weights(trainer.init_state(cfg.train.seed), cfg, params, state)
        log.log(f"warm start from torch checkpoint {cfg.train.torch_pretrained}")
        return trainer, ts
    if cfg.train.pretrained:
        mgr = CheckpointManager(cfg.train.pretrained, group=mesh.group)
        try:
            src = _restore(mgr, cfg, mesh, log)
        finally:
            mgr.close()
        if src is None:
            raise FileNotFoundError(f"train.pretrained={cfg.train.pretrained!r} holds no checkpoint")
        trainer, src_ts, _, _ = src  # the trainer is built on the source's (possibly pruned) net
        ts = steps.with_weights(trainer.init_state(cfg.train.seed), cfg, src_ts.params, src_ts.state,
                                masks=src_ts.masks)
        log.log(f"warm start from checkpoint {cfg.train.pretrained} (step {int(src_ts.step)} weights, fresh "
                "optimizer)")
        return trainer, ts
    trainer = Trainer(cfg, net, mesh=mesh)
    return trainer, trainer.init_state(cfg.train.seed)


def _extra(trainer: Trainer, epoch: float, best_top1: float, **more) -> dict:
    """The JSON sidecar's ``extra`` of a save: the epoch and best top-1, and
    in a latency-table search the penalty's (sliced) atom costs, which a
    resumed Trainer cannot look up for a shrunk block."""
    out = {"epoch": epoch, "best_top1": best_top1, **more}
    if trainer.cfg.prune.enable and trainer.cfg.prune.cost == "latency_table":
        out["atom_costs"] = {k: np.asarray(v, dtype=np.float32).tolist() for k, v in trainer.atom_costs.items()}
    return out


def _write_marker(cfg: Config, marker: dict) -> str:
    path = os.path.join(cfg.train.log_dir, PREEMPT_MARKER_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(marker, f, indent=1)
    os.replace(tmp, path)
    return path


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    """Train (or, with ``train.test_only``, evaluate) on ``device`` (CUDA
    unless the caller asks for the CPU) and return the summary: the final
    epoch and step, the eval result on the EMA weights (``eval_*``), the
    count of finite steps, the metrics of every log point (``log``), the
    steps checkpointed, the step resumed from, ``preempted``, the device,
    and the rank and world size.

    With ``dist.num_devices`` = N > 1 and no ``dist.multihost`` it starts N
    local ranks, a process each, on a loopback store, and returns rank 0's
    summary with every rank's under ``ranks``.

    ``train.tuning_file`` is applied first, before anything touches a group
    or the card."""
    cfg, tuning_lines = _apply_tuning(cfg)
    world = 1 if cfg.dist.multihost else mesh_lib.requested_world(cfg.dist.num_devices, device)
    if world > 1:
        return _run_ranks(cfg, device, world, tuning_lines)
    return train(cfg, device, tuning_lines=tuning_lines)[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.settimeout(5.0)  # bind() never blocks, but every socket of the package has an explicit bound (YAMT018)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, cfg: Config, device: str, results,
               tuning_lines: list[str]) -> None:
    """One local rank of :func:`_run_ranks`: join the group, train, report."""
    try:
        mesh = mesh_lib.init_mesh(device, rank=rank, world=world, init_method=init_method)
        try:
            results.put((rank, train(cfg, device, mesh=mesh, tuning_lines=tuning_lines)[0], None))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — reported to the parent, then re-raised
        results.put((rank, None, f"{type(e).__name__}: {e}"))
        raise


def _run_ranks(cfg: Config, device: str | torch.device, world: int, tuning_lines: list[str]) -> dict:
    """``world`` local ranks, each a spawned process, on ``cfg`` as tuned
    (``tuning_lines``: its provenance); raises what a rank raised, and stops
    the others (which would wait in a collective)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(r, world, init_method, cfg, str(device), results, tuning_lines),
                         name=f"rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    summaries: dict = {}
    failure = None
    try:
        while len(summaries) < world and failure is None:
            try:
                rank, summary, err = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = next((p for p in procs if p.exitcode not in (None, 0)), None)
                if dead is not None:
                    failure = f"{dead.name} exited with code {dead.exitcode} before it reported"
                continue
            if err is not None:
                failure = f"rank {rank}: {err}"
            else:
                summaries[rank] = summary
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"data-parallel run of {world} ranks failed: {failure}")
    return {**summaries[0], "ranks": [summaries[r] for r in range(world)]}


def train(cfg: Config, device: str | torch.device = "cuda", *, mesh: mesh_lib.Mesh | None = None,
          tuning_lines: list[str] | None = None) -> tuple[dict, steps.TrainState, Network]:
    """:func:`run` of one rank, also returning the final TrainState and the
    network (what an export of the trained weights needs). ``mesh`` is the
    rank's world when the caller made it; otherwise ``dist.multihost`` joins
    torchrun's (and leaves it at the end), and a run of one process has
    none. ``tuning_lines`` are the provenance of a tuning file the caller
    applied to ``cfg``; without them ``train.tuning_file`` is applied here."""
    if tuning_lines is None:
        cfg, tuning_lines = _apply_tuning(cfg)
    data_sources._check(cfg.data)  # the data config's own refusals (the JAX package's)
    own_group = False
    if mesh is None:
        if cfg.dist.multihost:
            own_group = not torch.distributed.is_initialized()
            mesh = mesh_lib.init_mesh(device)
            if cfg.dist.num_devices not in (0, mesh.size):
                raise ValueError(f"dist.num_devices={cfg.dist.num_devices} but torchrun started {mesh.size} ranks; "
                                 "set it to 0 or to the world's size")
        else:
            world = mesh_lib.requested_world(cfg.dist.num_devices, device)
            if world > 1:
                raise ValueError(f"dist.num_devices={cfg.dist.num_devices} is a world of {world} ranks: start them "
                                 "with run(), or with torchrun and dist.multihost=true")
            mesh = mesh_lib.make_mesh(device)
    try:
        return _train_rank(cfg, mesh, tuning_lines)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train_rank(cfg: Config, mesh: mesh_lib.Mesh, tuning_lines: list[str]) -> tuple[dict, steps.TrainState, Network]:
    dev = mesh.device
    if cfg.data.fake_num_classes is None:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    coord = mesh.is_coordinator
    log = Logger(cfg.train.log_dir, enabled=coord, tensorboard=False)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tf32 = set_tf32(cfg.train.compute_dtype)
    ckpt = (CheckpointManager(os.path.join(cfg.train.log_dir, "ckpt"), max_to_keep=cfg.train.max_checkpoints,
                              group=mesh.group) if cfg.train.log_dir else None)
    world = f"; rank {mesh.rank} of {mesh.size} ({mesh.backend})" if mesh.group is not None else ""
    log.log(f"device: {dev} ({name}){world}; {cfg.train.compute_dtype}: TF32 cudnn {tf32['tf32_cudnn']}, matmul "
            f"{tf32['tf32_matmul']}; "
            + (f"checkpoints in {cfg.train.log_dir}/ckpt every {cfg.train.checkpoint_every_epochs} epochs and at "
               "the end" if ckpt is not None else "no train.log_dir: no checkpoints"))
    for line in tuning_lines:  # provenance of measured-winner overrides
        log.log(line)
    t = cfg.train
    log.log(f"train step: bn_mode={t.bn_mode} remat={t.remat} remat_policy={t.remat_policy} "
            f"conv1x1_dot={t.conv1x1_dot} steps_per_dispatch={t.steps_per_dispatch}")
    log.log(data_sources.order_note(cfg.data))
    reg = obs_registry.get_registry()
    if cfg.obs.histogram_buckets:
        reg.set_default_buckets(cfg.obs.histogram_buckets)
    reg.set_build_info(obs_device.build_info(rank=mesh.rank, world=mesh.size))
    obs_device.install_memory_gauges(reg)
    log.set_registry(reg)
    tracer = obs_trace.configure(enabled=bool(cfg.obs.trace), ring_size=cfg.obs.trace_ring_size)
    watchdog = None
    if cfg.obs.watchdog_deadline_s > 0 and cfg.train.log_dir and coord:
        watchdog = StallWatchdog(cfg.train.log_dir, cfg.obs.watchdog_deadline_s, tracer=tracer, registry=reg,
                                 poll_s=cfg.obs.watchdog_poll_s, logger=log)
        watchdog.start()
    managers = [ckpt] if ckpt is not None else []  # the best-checkpoint manager joins lazily
    try:
        return _train(cfg, log, mesh, tracer, tf32, watchdog, managers)
    finally:
        # every exit path, a raise included, waits for the in-flight writes
        # BEFORE closing, so a checkpoint is never abandoned half-written; a
        # failed wait is logged and never masks the original exception
        for mgr in reversed(managers):
            try:
                mgr.wait()
            except Exception as e:  # noqa: BLE001 — shutdown must reach close()
                log.log(f"checkpoint wait on shutdown failed ({type(e).__name__}: {e})")
            try:
                mgr.close()
            except Exception as e:  # noqa: BLE001 — best-effort shutdown
                log.log(f"checkpoint close on shutdown failed ({type(e).__name__}: {e})")
        if watchdog is not None:
            watchdog.stop()
        # flush telemetry on every exit: a crash mid-epoch is when it matters
        if tracer.enabled and cfg.train.log_dir and coord:
            path = tracer.write(os.path.join(cfg.train.log_dir, "obs_trace.json"))
            log.log(f"span trace -> {path}")
        if cfg.train.log_dir and coord:
            os.makedirs(cfg.train.log_dir, exist_ok=True)
            with open(os.path.join(cfg.train.log_dir, "obs_registry.json"), "w") as f:
                json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
        log.close()


class _ProfilerWindow:
    """``train.profile_start_step``'s ``torch.profiler`` window on the
    coordinator: opened after step S, closed after step S +
    ``train.profile_num_steps`` once the device has finished, and written as
    ``<train.log_dir>/trace/train_trace_<S>.json``. :meth:`close` is the
    loop's ``finally``: a window still open is closed and written there, and
    a failure to write is logged, never raised over the run's own error."""

    def __init__(self, cfg: Config, device: torch.device, log: Logger):
        self.start_step = cfg.train.profile_start_step
        self.stop_step = self.start_step + cfg.train.profile_num_steps
        self.device = device
        self.log = log
        self.trace_dir = os.path.join(cfg.train.log_dir or ".", "trace")
        self._prof = None
        self._last = 0
        self.result: dict | None = None

    def after_step(self, step: int) -> None:
        self._last = step
        if step == self.start_step and self._prof is None and self.result is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()  # yamt-lint: disable=YAMT013 — the window spans training steps; train()'s finally calls close(), which stops it
            self._t0 = time.perf_counter()
        elif self._prof is not None and step >= self.stop_step:
            self._stop(step)

    def _stop(self, step: int) -> None:
        prof, self._prof = self._prof, None
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the window holds the steps' kernels, not their enqueue
        finally:
            prof.stop()
        seconds = time.perf_counter() - self._t0
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"train_trace_{self.start_step}.json")
        prof.export_chrome_trace(path)
        self.result = {"path": path, "first_step": self.start_step + 1, "last_step": step, "seconds": seconds}
        self.log.log(f"profiler trace of steps {self.start_step + 1}..{step} ({seconds:.3f}s) -> {path}")

    def close(self) -> None:
        if self._prof is None:
            return
        try:
            self._stop(self._last)
        except Exception as e:  # noqa: BLE001 — a failed flush must not mask the run's exception
            self.log.log(f"profiler stop on exit failed ({type(e).__name__}: {e})")


def _one_step(trainer: Trainer, ts: steps.TrainState, train_iter, generator: torch.Generator, tracer):
    """One step between log points: the next batch (made on the device) and
    the step. Nothing here waits on the device."""
    with tracer.span("data/next", "data"):
        batch = next(train_iter)
    with tracer.span("dispatch/train_step", "dispatch"):
        return trainer.train_step(ts, batch, generator)


def _prune_event(trainer: Trainer, ts: steps.TrainState, step_i: int, tracer) -> steps.TrainState:
    """The prune event after step ``step_i``, dispatched like a step: the
    reached-target check, the adaptive-rho feedback and the mask update all
    run on the device (``nas/masking.py``), and nothing here waits on it."""
    with tracer.span("prune/mask_event", "prune", step=step_i):
        masks, rho_mult = trainer.prune_event(ts.params, ts.masks, ts.rho_mult, ts.step)
    return ts.replace(masks=masks, rho_mult=rho_mult)


def _prune_metrics(trainer: Trainer, ts: steps.TrainState, tracer) -> dict:
    """The search's log-point metrics: the effective MACs of the masked
    network and, under the adaptive schedule, rho_mult (one counted sync)."""
    out = {"effective_macs": masking.mask_summary(trainer.net, ts.masks)["effective_macs"]}
    if trainer.cfg.prune.rho_schedule == "adaptive":
        with tracer.span("sync/rho_mult", "sync"):
            out["rho_mult"] = float(ts.rho_mult)
        obs_registry.get_registry().counter("train.forced_host_syncs").inc()
    return out


def _grouped_row(grouped_step) -> dict:
    """The first log row's record of the grouped step: K, and 1 when it
    runs as a CUDA graph, 0 when it runs eagerly (gloo, the CPU)."""
    if grouped_step is None:
        return {}
    return {"grouped_k": float(grouped_step.k), "grouped_graph": float(grouped_step.mode == "cuda graph")}


def _log_point(step_i: int, metric_log: MetricLogger, guard: StepGuard | None, log: Logger, tracer,
               extra=None, num_chips: int = 1) -> dict:
    """The log boundary: the one place the loop reads the device (the
    pending metrics, the guard's verdicts and ``extra()``'s metrics)."""
    with tracer.span("sync/log_metrics", "sync", step=step_i):
        snap = metric_log.snapshot_and_reset(num_chips=num_chips)
    if extra is not None:
        snap.update(extra())
    obs_registry.get_registry().gauge("train.step").set(step_i)
    log.log(format_metrics(f"step {step_i}:", snap))
    log.scalars(step_i, snap, "train/")
    if guard is not None:
        guard.check(step_i)  # the guard rolled back any non-finite step already
    elif snap.get("finite", 1.0) < 1.0:
        log.error("non-finite loss detected; aborting")
        raise FloatingPointError("non-finite loss")
    return snap


def _maybe_rematerialize(trainer: Trainer, ts: steps.TrainState, step_i: int, log: Logger):
    """The physical shrink: returns (trainer, ts, report), the trainer
    rebuilt on the smaller network (a new optimizer, new step functions and
    a new guard wrapper) and the state sliced to it on the device, or the
    same pair and None when no atom died. The caller drops the old pair,
    which frees the old network's tensors."""
    summary = masking.mask_summary(trainer.net, ts.masks)
    if summary["alive_atoms"] == summary["total_atoms"]:
        return trainer, ts, None
    ts = trainer.checkpoint_view(ts)  # the ZeRO shards gathered: the slicers take params-shaped trees
    new_net, new_p, new_s, new_masks, extras, report = rematerialize.rematerialize(
        trainer.net, ts.params, ts.state, ts.masks,
        opt_state=ts.opt_state, ema_params=ts.ema_params, ema_state=ts.ema_state)
    macs_before, macs_after = profile_network(trainer.net).total_macs, profile_network(new_net).total_macs
    log.log(f"rematerialize at step {step_i}: atoms {report.atoms_before}->{report.atoms_after}, dropped blocks "
            f"{report.dropped_blocks}, dropped branches {report.dropped_branches}, "
            f"MACs {macs_before / 1e6:.1f}M->{macs_after / 1e6:.1f}M")
    new_trainer = Trainer(trainer.cfg, new_net, atom_costs=(
        _sliced_costs(trainer.atom_costs, ts.masks, report) if trainer.cfg.prune.cost == "latency_table" else None),
        mesh=trainer.mesh)
    new_ts = steps.TrainState(step=ts.step, params=new_p, state=new_s, opt_state=extras["opt_state"],
                              ema_params=extras.get("ema_params"), ema_state=extras.get("ema_state"),
                              masks=new_masks, rho_mult=ts.rho_mult)
    if new_trainer.zero:
        new_ts = new_ts.replace(opt_state=zero.scatter_opt_state(new_ts.opt_state, trainer.mesh))
    return new_trainer, new_ts, {"step": step_i, "atoms_before": report.atoms_before,
                                 "atoms_after": report.atoms_after, "dropped_blocks": report.dropped_blocks,
                                 "macs_before": macs_before, "macs_after": macs_after}


def _sliced_costs(costs: dict, masks, report) -> dict:
    """The penalty's per-atom costs of a rebuilt network in latency-table
    mode: each surviving atom keeps its cost (the slope of its block
    family, measured at the supernet's widths), and the normalizer stays
    the supernet's measured total. The table is keyed by the supernet's
    blocks, so a shrunk block has no entry of its own; the JAX package
    looks one up and raises KeyError at the first rebuild that drops an
    atom (ROADMAP queue 3, F2)."""
    host = masking.masks_to_host(masks)
    return {str(report.index_map[int(k)]): v[np.flatnonzero(host[k] > 0)] if k in host else v
            for k, v in costs.items() if int(k) in report.index_map}


def _write_searched(trainer: Trainer, ts: steps.TrainState, cfg: Config, log: Logger, write: bool = True) -> dict:
    """The searched architecture as a standalone spec, ``searched_arch.json``
    in ``train.log_dir`` (the ``model.network_spec`` of a retrain), written
    when ``write`` (by the coordinator)."""
    prof = profile_network(trainer.net)
    payload = {"network": network_to_dict(trainer.net), "macs": int(prof.total_macs),
               "params": int(prof.total_params), "step": int(ts.step)}
    path = os.path.join(cfg.train.log_dir, "searched_arch.json")
    if write:
        os.makedirs(cfg.train.log_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
    log.log(f"searched architecture -> {path} ({prof.total_macs / 1e6:.1f}M MACs, "
            f"{prof.total_params / 1e6:.2f}M params)")
    return {"path": path, "macs": payload["macs"], "params": payload["params"], "step": payload["step"]}


def _eval_only(cfg: Config, net: Network, log: Logger, mesh: mesh_lib.Mesh, watchdog,
               ckpt: CheckpointManager | None) -> tuple[dict, steps.TrainState, Network]:
    """``train.test_only``: one eval pass of the torchvision import, of
    ``train.pretrained``'s newest restorable checkpoint, or of the run's own
    (a fresh init when there is none: the smoke mode)."""
    dev = mesh.device
    if cfg.train.torch_pretrained:
        trainer, ts = _init_or_warm_start(cfg, net, mesh, log)
    else:
        mgr = CheckpointManager(cfg.train.pretrained, group=mesh.group) if cfg.train.pretrained else ckpt
        try:
            restored = _restore(mgr, cfg, mesh, log) if mgr is not None else None
        finally:
            if mgr is not ckpt:
                mgr.close()
        if restored is None:
            log.log("no checkpoint found; evaluating fresh init (smoke mode)")
            trainer = Trainer(cfg, net, mesh=mesh)
            ts = trainer.init_state(cfg.train.seed)
        else:
            trainer, ts, _, _ = restored
    result = evaluate(trainer, ts, cfg, None, watchdog)
    log.log(format_metrics("eval:", result))
    summary = {"test_only": True, "step": int(ts.step), "device": str(dev), "rank": mesh.rank, "world": mesh.size,
               **{f"eval_{k}": v for k, v in result.items()}}
    return summary, ts, trainer.net


def _train(cfg: Config, log: Logger, mesh: mesh_lib.Mesh, tracer, tf32: dict, watchdog,
           managers: list) -> tuple[dict, steps.TrainState, Network]:
    dev, coord = mesh.device, mesh.is_coordinator
    net = get_model(cfg.model, cfg.data.image_size)
    prof = profile_network(net)
    arch_name = cfg.model.network_spec or f"{cfg.model.arch} x{cfg.model.width_mult}"
    log.log(f"model {arch_name}: {prof.total_params / 1e6:.2f}M params, {prof.total_macs / 1e6:.1f}M MACs")
    ckpt = managers[0] if managers else None
    if cfg.train.test_only:
        return _eval_only(cfg, net, log, mesh, watchdog, ckpt)
    reg = obs_registry.get_registry()
    restored = _restore(ckpt, cfg, mesh, log) if cfg.train.resume and ckpt is not None else None
    start_epoch, best_top1, gen_state = 0.0, 0.0, None
    if restored is not None:
        trainer, ts, extra, gen_state = restored
        start_epoch = float(extra.get("epoch", int(ts.step) / trainer.steps_per_epoch))
        best_top1 = float(extra.get("best_top1", 0.0))
        log.log(f"resumed at step {int(ts.step)} (epoch {start_epoch:.2f})")
        marker = os.path.join(cfg.train.log_dir, PREEMPT_MARKER_NAME)
        if coord and os.path.exists(marker):
            # the marker's job (telling the scheduler a clean resume point
            # exists) is done once the resume happened
            os.remove(marker)
            log.log("preemption resume marker consumed")
    else:
        log.mark_fresh_run()  # truncate metrics.jsonl: steps restart at 0
        trainer, ts = _init_or_warm_start(cfg, net, mesh, log)
    log.log(f"train step cost (from shapes): {trainer.step_cost['flops'] / 1e9:.3f} GFLOP, "
            f"{trainer.step_cost['bytes'] / 1e6:.1f} MB per step")
    start_step = host_step = int(ts.step)  # one read at (re)start, then host-side counting
    generator = dp.rank_generator(cfg.train.seed, mesh)
    if gen_state is not None:
        if gen_state.numel() == generator.get_state().numel():
            generator.set_state(gen_state)
        else:  # saved by a run on another kind of device: its stream cannot continue here
            log.log("the checkpoint's step generator is another device's; reseeded from train.seed")
    real = data_sources.is_real(cfg.data)
    fake = None if real else data_lib.FakeImages(cfg.data, dev)
    failures0 = _decode_failures() if real else 0
    inject = None
    if cfg.train.faults.enable:
        # seeded train-side chaos: wraps the RAW stream, so injected corrupt
        # records travel the real resilience path
        from ..train.faults import FaultyTrainSource

        def inject(it):
            return FaultyTrainSource.from_config(it, cfg.train.faults, start_step=start_step)
    # a resumed run continues the data order at the restored step
    train_src = data_sources.make_train_source(cfg.data, trainer.local_batch, cfg.train.seed, mesh.rank, mesh.size,
                                               start_step=start_step, inject=inject, device=dev, fake=fake)
    train_iter = train_src
    if real:
        train_iter = mesh_lib.prefetch_to_device(train_src, dev, depth=cfg.data.device_prefetch)
        if cfg.data.randaugment_layers > 0:
            from ..data import randaugment

            train_iter = randaugment.device_stage(train_iter, cfg.data, cfg.train.seed + mesh.rank)
        log.log(f"data: {cfg.data.dataset}/{cfg.data.loader} from {cfg.data.data_dir}, {cfg.data.decode_threads} "
                f"decode threads, {trainer.steps_per_epoch} steps per epoch of {_dataset_sizes(cfg)[0]} images")
    guard = StepGuard(cfg.train.guard, cfg.train.log_dir if coord else None, log) if cfg.train.guard.enable else None
    if guard is not None and watchdog is not None:
        watchdog.register_info("train_guard", guard.info)

    spe = trainer.steps_per_epoch
    metric_log = MetricLogger()
    eval_result: dict = {}
    snaps: list[dict] = []
    saved: list[int] = []
    finite = torch.zeros((), device=dev)  # finite steps, counted on the device
    epoch = start_epoch
    eval_cad = StepCadence(cfg.train.eval_every_epochs, spe, host_step)
    ckpt_cad = StepCadence(cfg.train.checkpoint_every_epochs, spe, host_step)
    remat_cad = StepCadence(cfg.prune.remat_epochs, spe, host_step)
    remats: list[dict] = []
    replica_checks: list[dict] = []
    preempt = _Preemption(log).install()
    preempted = False
    k_dispatch = max(1, cfg.train.steps_per_dispatch)
    if k_dispatch > 1 and cfg.train.profile_start_step:
        # the window opens and closes at exact steps: single dispatches only
        log.log("WARNING: steps_per_dispatch>1 is incompatible with the profiler window; forcing 1")
        k_dispatch = 1
    window = _ProfilerWindow(cfg, dev, log) if cfg.train.profile_start_step and coord else None

    def build_grouped():
        if k_dispatch < 2:
            return None
        with tracer.span("rebuild/grouped_step", "rebuild"):
            return dp.make_grouped_train_step(trainer.train_step, k_dispatch, event_fn=trainer.prune_event,
                                              mesh=trainer.mesh)

    grouped_step = build_grouped()
    if grouped_step is not None:
        log.log(f"grouped step: {k_dispatch} steps per dispatch, {grouped_step.mode}")

    def remat_point():
        """One rematerialization: its span, the rebuild count, and the
        allocated device memory before it and after the old state is gone."""
        nonlocal trainer, ts, grouped_step
        mem_before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        with tracer.span("rebuild/rematerialize", "rebuild", step=host_step):
            new_trainer, new_ts, report = _maybe_rematerialize(trainer, ts, host_step, log)
        if report is None:
            return
        # the last references to the old network's tensors go, the grouped
        # step's graph (captured on the old shapes) with them
        trainer, ts, grouped_step = new_trainer, new_ts, None
        del new_trainer, new_ts
        grouped_step = build_grouped()
        reg.counter("train.rebuilds").inc()
        if mem_before is not None:
            report.update(memory_allocated_before=mem_before, memory_allocated_after=torch.cuda.memory_allocated(dev))
            log.log(f"device memory allocated {mem_before / 1e9:.3f} GB -> "
                    f"{report['memory_allocated_after'] / 1e9:.3f} GB")
        remats.append(report)

    def save(mgr: CheckpointManager, **more):
        # collectives under data parallel: every rank saves, rank 0 writes
        mgr.save(host_step, trainer.net, trainer.checkpoint_view(ts), extra=_extra(trainer, epoch, best_top1, **more),
                 items=_generator_items(generator, mesh))

    t_run = time.perf_counter()
    try:
        while epoch < cfg.train.epochs:
            epoch_steps = min(spe, max(int((cfg.train.epochs - epoch) * spe), 1))
            t_epoch = time.perf_counter()
            steps_done = 0
            while steps_done < epoch_steps:
                if preempt.requested:
                    preempted = True
                    break
                if grouped_step is not None and epoch_steps - steps_done >= k_dispatch:
                    with tracer.span("data/next", "data", batches=k_dispatch):
                        batches = [next(train_iter) for _ in range(k_dispatch)]
                    with tracer.span("dispatch/grouped_step", "dispatch", steps=k_dispatch):
                        ts, metric_list = grouped_step(ts, batches, generator)
                else:
                    ts, metrics = _one_step(trainer, ts, train_iter, generator, tracer)
                    metric_list = [metrics]
                steps_done += len(metric_list)
                for metrics in metric_list:
                    host_step += 1  # host-side count: reading ts.step would wait on the device
                    finite = finite + metrics["finite"]
                    metric_log.update(metrics, batch_images=cfg.train.batch_size)
                    if guard is not None:
                        guard.observe(host_step, metrics)
                    if watchdog is not None:
                        watchdog.arm(host_step)
                    if window is not None:
                        window.after_step(host_step)
                    # inside a grouped dispatch the event ran on the device
                    # after every sub-step; a single step takes it here
                    if (len(metric_list) == 1 and trainer.prune_event is not None
                            and host_step % cfg.prune.mask_interval == 0 and host_step <= trainer.prune_stop_step):
                        ts = _prune_event(trainer, ts, host_step, tracer)
                    if host_step % cfg.train.log_every == 0:
                        extra = (lambda: _prune_metrics(trainer, ts, tracer)) if cfg.prune.enable else None
                        if not snaps:  # the first log row carries the TF32 flags and the grouped step's mode
                            extra = (lambda f=extra: {**{k: float(v) for k, v in tf32.items()},
                                                      **_grouped_row(grouped_step), **(f() if f else {})})
                        snaps.append({"step": host_step, **_log_point(host_step, metric_log, guard, log, tracer,
                                                                      extra, mesh.size)})
                    if cfg.train.check_finite_every and host_step % cfg.train.check_finite_every == 0:
                        # a forced host sync: a debug guard, off by default
                        with tracer.span("sync/finite_check", "sync", step=host_step):
                            ok = float(metrics["finite"])
                        reg.counter("train.forced_host_syncs").inc()
                        if ok < 1.0:
                            log.error(f"non-finite loss at step {host_step}")
                            raise FloatingPointError("non-finite loss")
                    if cfg.train.param_checksum_every and host_step % cfg.train.param_checksum_every == 0:
                        # the replica check (every rank calls it): a forced
                        # host sync, a debug knob, off by default
                        with tracer.span("sync/replica_checksum", "sync", step=host_step):
                            divergence = float(trainer.sync_check(ts.params))
                        reg.counter("train.forced_host_syncs").inc()
                        replica_checks.append({"step": host_step, "divergence": divergence})
                        if divergence != 0.0:
                            log.error(f"replica divergence {divergence} at step {host_step}")
                            raise RuntimeError(f"replica divergence {divergence} at step {host_step}")
            if preempted:
                epoch = host_step / spe  # the exact mid-epoch position
                log.log(f"preemption ({preempt.reason}): stopping at step {host_step} (epoch {epoch:.2f})")
                break
            epoch += epoch_steps / spe
            log.log(f"epoch {epoch:.2f} done in {time.perf_counter() - t_epoch:.1f}s"
                    + (f"; decode failures so far: {_decode_failures() - failures0}" if real else ""))
            if cfg.prune.enable and remat_cad.due(host_step):
                remat_point()
                if watchdog is not None:
                    watchdog.arm(host_step, phase="rematerialize")
            # the final eval and the final checkpoint always run, even with
            # the periodic knobs at 0
            last = epoch >= cfg.train.epochs
            if eval_cad.due(host_step) or last:
                eval_result = evaluate(trainer, ts, cfg, fake, watchdog)
                if eval_result["top1"] > best_top1:
                    best_top1 = eval_result["top1"]
                    if cfg.train.keep_best and cfg.train.log_dir:
                        # one best checkpoint, in its own dir: resume always
                        # takes the latest, train.pretrained can take the best
                        if len(managers) < 2:
                            best_dir = os.path.join(cfg.train.log_dir, "ckpt_best")
                            managers.append(CheckpointManager(best_dir, max_to_keep=1, group=mesh.group))
                        save(managers[1])
                eval_result["best_top1"] = best_top1
                log.log(format_metrics(f"eval @ epoch {epoch:.2f}:", eval_result))
                log.scalars(host_step, eval_result, "eval/")
            if ckpt is not None and (ckpt_cad.due(host_step) or last):
                save(ckpt)
                saved.append(host_step)
                if watchdog is not None:
                    watchdog.arm(host_step, phase="checkpoint")
    finally:
        preempt.uninstall()
        if window is not None:
            window.close()  # a run that ended (or raised) inside the window still writes its trace
        if hasattr(train_src, "close"):
            train_src.close()
    if guard is not None:
        guard.check(host_step)  # the verdicts the last log window missed
    base = {"epoch": epoch, "steps": host_step - start_step, "step": host_step,
            "finite_steps": int(finite.item()), "seconds": time.perf_counter() - t_run, "device": str(dev),
            "rank": mesh.rank, "world": mesh.size, "checkpoints": saved,
            "resumed_from": start_step if restored is not None else None, "tf32": tf32, "log": snaps,
            "grouped": {"k": k_dispatch, "mode": grouped_step.mode} if grouped_step is not None else None,
            "replica_checks": replica_checks, "steps_per_epoch": spe,
            "decode_failures": _decode_failures() - failures0 if real else 0,
            "profile": window.result if window is not None else None}
    if preempted:
        # a SYNCHRONOUS checkpoint: the process exits right after, so a
        # write left to a thread could be reaped half-written
        if ckpt is not None:
            log.log(f"preemption checkpoint: saving step {host_step} synchronously")
            save(ckpt, preempted=True)
            ckpt.wait()
            saved.append(host_step)
            if coord:
                path = _write_marker(cfg, {"step": host_step, "epoch": epoch, "reason": preempt.reason,
                                           "checkpoint_dir": os.path.join(cfg.train.log_dir, "ckpt")})
                log.log(f"resume marker -> {path}; restart with train.resume=true to continue from here")
        reg.counter("train.preemptions").inc()
        final = {**base, "preempted": True, **{f"eval_{k}": v for k, v in eval_result.items()}}
        log.log(format_metrics("preempted:", {k: v for k, v in final.items() if isinstance(v, (int, float))}))
        return final, ts, trainer.net
    searched = None
    if cfg.prune.enable:
        # the remaining masks applied physically, and the searched network
        # written as a standalone spec
        remat_point()
        searched = _write_searched(trainer, ts, cfg, log, write=coord)
    final = {**base, "preempted": False, **{f"eval_{k}": v for k, v in eval_result.items()}}
    if guard is not None:
        final["skipped_steps"] = guard.skipped_total
    if searched is not None:
        final.update(searched=searched, remats=remats)
    log.log(format_metrics("done:", {k: v for k, v in final.items() if isinstance(v, (int, float))})
            + f"; checkpoints at steps {saved}")
    return final, ts, trainer.net


def main(argv=None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return run(parse_cli(argv), device=device)


if __name__ == "__main__":
    main()

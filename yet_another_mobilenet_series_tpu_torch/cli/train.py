"""Training entry point of the port: ``python -m
yet_another_mobilenet_series_tpu_torch.cli.train app:<yaml> [key=value ...]
[--device cpu]``, the torch twin of ``yet_another_mobilenet_series_tpu/cli/train.py``.

It trains on one device: ``cuda`` unless ``--device cpu`` (parsed as
``cli/serve.py`` parses it), and asking for CUDA without a card raises. The
loop is the JAX package's, reduced to one device: the epoch/step loops,
the log cadence, the step guard, eval on the EMA shadow weights at the eval
cadence and at the end, and the telemetry files in ``train.log_dir``
(``metrics.jsonl``, ``obs_registry.json`` and, with ``obs.trace``, the span
trace). TensorBoard is off: the card's machine has no TensorFlow.

Each step is eager PyTorch (``train/steps.py``) and never waits on the
device: the metrics stay on it until a log point (every
``train.log_every`` steps) reads them, with the guard's verdicts, in one
go. The data is the fake dataset made on the device (``data/pipeline.py``).

With ``prune.enable`` it runs the AtomNAS search as the JAX CLI does: the
FLOPs-weighted gamma penalty inside the step, the prune event on the
device every ``prune.mask_interval`` steps up to ``prune_stop_step``
(``nas/masking.py``; it waits on nothing), the effective MACs (and, for the
adaptive schedule, rho_mult) read at log points, a rematerialization every
``prune.remat_epochs`` that rebuilds the Trainer on the shrunk network
(``nas/rematerialize.py``), and at the end a last one that writes
``searched_arch.json`` into ``train.log_dir``.

Not ported yet, each refused with a ``ValueError`` that names its entry in
``ROADMAP.md``: more than one device and the grouped step (queue 1, item
8), resume, warm starts and eval-only runs (item 9), the tuning file (item
12), and the watchdog, the fault injector and the profiler window (item
10). Periodic checkpoints are not written (item 9): the first log line and
the returned summary say so.
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
import sys
import time

import torch

from ..config import Config, parse_cli
from ..data import pipeline as data_lib
from ..models import get_model
from ..models.serialize import network_to_dict
from ..models.specs import Network
from ..nas import masking, penalty, rematerialize
from ..obs import device as obs_device
from ..obs import registry as obs_registry
from ..obs import trace as obs_trace
from ..train import optim, schedules, steps
from ..train.guard import StepGuard, wrap_step_fn
from ..utils.cadence import StepCadence
from ..utils.device import resolve_device
from ..utils.logging import Logger
from ..utils.meters import MetricLogger, format_metrics
from ..utils.profiling import profile_network
from .serve import parse_device

NO_CHECKPOINTS = "periodic checkpoints are not written by the port yet (ROADMAP queue 1, item 9)"


def _refuse_unported(cfg: Config) -> None:
    """A ValueError, naming its ROADMAP entry, for what the port lacks."""
    refused = [
        (cfg.dist.num_devices > 1, f"dist.num_devices={cfg.dist.num_devices}", "queue 1, item 8: data parallel"),
        (cfg.dist.multihost, "dist.multihost", "queue 1, item 8: data parallel"),
        (cfg.train.steps_per_dispatch > 1, f"train.steps_per_dispatch={cfg.train.steps_per_dispatch}",
         "queue 1, item 8: the grouped train step"),
        (cfg.train.param_checksum_every > 0, "train.param_checksum_every", "queue 1, item 8: the replica check"),
        (bool(cfg.train.pretrained), "train.pretrained", "queue 1, item 9: checkpoints"),
        (bool(cfg.train.torch_pretrained), "train.torch_pretrained", "queue 1, item 9: checkpoints"),
        (cfg.train.test_only, "train.test_only", "queue 1, item 9: checkpoints"),
        (bool(cfg.train.tuning_file), "train.tuning_file", "queue 1, item 12: the tuning file"),
        (cfg.obs.watchdog_deadline_s > 0, "obs.watchdog_deadline_s", "queue 1, item 10: the rest of the CLI"),
        (cfg.train.faults.enable, "train.faults.enable", "queue 1, item 10: the rest of the CLI"),
        (cfg.train.profile_start_step > 0, "train.profile_start_step", "queue 1, item 10: the rest of the CLI"),
    ]
    for bad, what, entry in refused:
        if bad:
            raise ValueError(f"{what} is not ported yet (ROADMAP {entry})")
    ckpt_dir = os.path.join(cfg.train.log_dir, "ckpt")
    if cfg.train.resume and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        raise ValueError(f"{ckpt_dir!r} holds a checkpoint and train.resume is on; resume is not ported yet "
                         "(ROADMAP queue 1, item 9: checkpoints); set train.resume=false or another train.log_dir")
    data_lib.check(cfg.data)


class Trainer:
    """Builds and owns the step functions of one run on one device; rebuilt
    whole by a rematerialization (the network's shapes changed)."""

    def __init__(self, cfg: Config, net: Network, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.net = net
        self.device = resolve_device(device)
        self.steps_per_epoch = max(cfg.data.fake_train_size // cfg.train.batch_size, 1)
        self.lr_fn = schedules.make_lr_schedule(cfg.schedule, cfg.train.batch_size, self.steps_per_epoch,
                                                cfg.train.epochs)
        params_example, _ = net.init(torch.Generator().manual_seed(0))
        self.optimizer = optim.make_optimizer(cfg.optim, self.lr_fn, params_example)
        prune = cfg.prune.enable
        self.penalty_fn = (penalty.make_penalty_fn(net, cfg.prune, self.steps_per_epoch, device=self.device)
                           if prune else None)
        # the event's own gate is true exactly when the loop's host gate is
        self.prune_stop_step = int(cfg.prune.stop_epoch_frac * cfg.train.epochs * self.steps_per_epoch)
        self.prune_event = (masking.make_prune_event(net, cfg.prune, self.prune_stop_step, device=self.device)
                            if prune else None)
        step = steps.make_train_step(net, cfg, self.optimizer, self.lr_fn, penalty_fn=self.penalty_fn)
        # the guard's device half: a non-finite step is rolled back on the
        # device (train/guard.py); StepGuard below does the host accounting
        self.train_step = wrap_step_fn(step) if cfg.train.guard.enable else step
        self.eval_step = steps.make_eval_step(net, cfg)

    def init_state(self, seed: int) -> steps.TrainState:
        return steps.init_train_state(self.net, self.cfg, self.optimizer, torch.Generator().manual_seed(seed),
                                      device=self.device)


def evaluate(trainer: Trainer, ts: steps.TrainState, cfg: Config, fake: data_lib.FakeImages) -> dict:
    """One eval pass on the EMA shadow weights (the live ones when EMA is
    off). The per-batch counts add up on the device; the host reads them
    once, at the end."""
    tracer = obs_trace.get_tracer()
    params = ts.ema_params if cfg.ema.enable else ts.params
    state = ts.ema_state if cfg.ema.enable else ts.state
    totals = None
    with tracer.span("eval/pass", "eval"):
        for batch in fake.eval_batches(cfg.train.eval_batch_size):
            m = trainer.eval_step(params, state, batch, ts.masks)
            totals = m if totals is None else {k: totals[k] + m[k] for k in m}
        with tracer.span("sync/eval_gather", "sync"):
            host = ({k: float(v) for k, v in totals.items()} if totals is not None
                    else {"top1": 0.0, "top5": 0.0, "n": 0.0, "loss_sum": 0.0})
    obs_registry.get_registry().counter("eval.passes").inc()
    n = max(host["n"], 1.0)
    return {"top1": host["top1"] / n, "top5": host["top5"] / n, "loss": host["loss_sum"] / n, "n": int(host["n"])}


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    """Train on ``device`` (CUDA unless the caller asks for the CPU) and
    return the summary: the final epoch and step, the eval result on the EMA
    weights (``eval_*``), the count of finite steps, the metrics of every log
    point (``log``), and the device."""
    return train(cfg, device)[0]


def train(cfg: Config, device: str | torch.device = "cuda") -> tuple[dict, steps.TrainState, Network]:
    """:func:`run`, also returning the final TrainState and the network (what
    an export of the trained weights needs)."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    if cfg.data.fake_num_classes is None:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    log = Logger(cfg.train.log_dir, enabled=True, tensorboard=False)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.log(f"device: {dev} ({name}); {NO_CHECKPOINTS}")
    reg = obs_registry.get_registry()
    if cfg.obs.histogram_buckets:
        reg.set_default_buckets(cfg.obs.histogram_buckets)
    reg.set_build_info(obs_device.build_info())
    obs_device.install_memory_gauges(reg)
    log.set_registry(reg)
    tracer = obs_trace.configure(enabled=bool(cfg.obs.trace), ring_size=cfg.obs.trace_ring_size)
    try:
        return _train(cfg, log, dev, tracer)
    finally:
        # flush telemetry on every exit: a crash mid-epoch is when it matters
        if tracer.enabled and cfg.train.log_dir:
            path = tracer.write(os.path.join(cfg.train.log_dir, "obs_trace.json"))
            log.log(f"span trace -> {path}")
        if cfg.train.log_dir:
            os.makedirs(cfg.train.log_dir, exist_ok=True)
            with open(os.path.join(cfg.train.log_dir, "obs_registry.json"), "w") as f:
                json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
        log.close()


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


def _log_point(step_i: int, metric_log: MetricLogger, guard: StepGuard | None, log: Logger, tracer,
               extra=None) -> dict:
    """The log boundary: the one place the loop reads the device (the
    pending metrics, the guard's verdicts and ``extra()``'s metrics)."""
    with tracer.span("sync/log_metrics", "sync", step=step_i):
        snap = metric_log.snapshot_and_reset(num_chips=1)
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
    new_net, new_p, new_s, new_masks, extras, report = rematerialize.rematerialize(
        trainer.net, ts.params, ts.state, ts.masks,
        opt_state=ts.opt_state, ema_params=ts.ema_params, ema_state=ts.ema_state)
    macs_before, macs_after = profile_network(trainer.net).total_macs, profile_network(new_net).total_macs
    log.log(f"rematerialize at step {step_i}: atoms {report.atoms_before}->{report.atoms_after}, dropped blocks "
            f"{report.dropped_blocks}, dropped branches {report.dropped_branches}, "
            f"MACs {macs_before / 1e6:.1f}M->{macs_after / 1e6:.1f}M")
    new_trainer = Trainer(trainer.cfg, new_net, trainer.device)
    new_ts = steps.TrainState(step=ts.step, params=new_p, state=new_s, opt_state=extras["opt_state"],
                              ema_params=extras.get("ema_params"), ema_state=extras.get("ema_state"),
                              masks=new_masks, rho_mult=ts.rho_mult)
    return new_trainer, new_ts, {"step": step_i, "atoms_before": report.atoms_before,
                                 "atoms_after": report.atoms_after, "dropped_blocks": report.dropped_blocks,
                                 "macs_before": macs_before, "macs_after": macs_after}


def _write_searched(trainer: Trainer, ts: steps.TrainState, cfg: Config, log: Logger) -> dict:
    """The searched architecture as a standalone spec, ``searched_arch.json``
    in ``train.log_dir`` (the ``model.network_spec`` of a retrain)."""
    prof = profile_network(trainer.net)
    payload = {"network": network_to_dict(trainer.net), "macs": int(prof.total_macs),
               "params": int(prof.total_params), "step": int(ts.step)}
    os.makedirs(cfg.train.log_dir, exist_ok=True)
    path = os.path.join(cfg.train.log_dir, "searched_arch.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    log.log(f"searched architecture -> {path} ({prof.total_macs / 1e6:.1f}M MACs, "
            f"{prof.total_params / 1e6:.2f}M params)")
    return {"path": path, "macs": payload["macs"], "params": payload["params"], "step": payload["step"]}


def _train(cfg: Config, log: Logger, dev: torch.device, tracer) -> tuple[dict, steps.TrainState, Network]:
    net = get_model(cfg.model, cfg.data.image_size)
    prof = profile_network(net)
    arch_name = cfg.model.network_spec or f"{cfg.model.arch} x{cfg.model.width_mult}"
    log.log(f"model {arch_name}: {prof.total_params / 1e6:.2f}M params, {prof.total_macs / 1e6:.1f}M MACs")
    reg = obs_registry.get_registry()
    trainer = Trainer(cfg, net, dev)
    ts = trainer.init_state(cfg.train.seed)
    log.mark_fresh_run()  # truncate metrics.jsonl: steps restart at 0
    fake = data_lib.FakeImages(cfg.data, dev)
    train_iter = data_lib.make_train_source(cfg.data, cfg.train.batch_size, cfg.train.seed, device=dev, fake=fake)
    generator = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    guard = StepGuard(cfg.train.guard, cfg.train.log_dir, log) if cfg.train.guard.enable else None

    spe = trainer.steps_per_epoch
    metric_log = MetricLogger()
    eval_result: dict = {}
    snaps: list[dict] = []
    finite = torch.zeros((), device=dev)  # finite steps, counted on the device
    epoch, host_step = 0.0, 0
    eval_cad = StepCadence(cfg.train.eval_every_epochs, spe, host_step)
    remat_cad = StepCadence(cfg.prune.remat_epochs, spe, host_step)
    remats: list[dict] = []

    def remat_point():
        """One rematerialization: its span, the rebuild count, and the
        allocated device memory before it and after the old state is gone."""
        nonlocal trainer, ts
        mem_before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        with tracer.span("rebuild/rematerialize", "rebuild", step=host_step):
            new_trainer, new_ts, report = _maybe_rematerialize(trainer, ts, host_step, log)
        if report is None:
            return
        trainer, ts = new_trainer, new_ts  # the last references to the old network's tensors go
        del new_trainer, new_ts
        reg.counter("train.rebuilds").inc()
        if mem_before is not None:
            report.update(memory_allocated_before=mem_before, memory_allocated_after=torch.cuda.memory_allocated(dev))
            log.log(f"device memory allocated {mem_before / 1e9:.3f} GB -> "
                    f"{report['memory_allocated_after'] / 1e9:.3f} GB")
        remats.append(report)

    t_run = time.perf_counter()
    while epoch < cfg.train.epochs:
        epoch_steps = min(spe, max(int((cfg.train.epochs - epoch) * spe), 1))
        t_epoch = time.perf_counter()
        for _ in range(epoch_steps):
            ts, metrics = _one_step(trainer, ts, train_iter, generator, tracer)
            host_step += 1  # host-side count: reading ts.step would wait on the device
            finite = finite + metrics["finite"]
            metric_log.update(metrics, batch_images=cfg.train.batch_size)
            if guard is not None:
                guard.observe(host_step, metrics)
            if (trainer.prune_event is not None and host_step % cfg.prune.mask_interval == 0
                    and host_step <= trainer.prune_stop_step):
                ts = _prune_event(trainer, ts, host_step, tracer)
            if host_step % cfg.train.log_every == 0:
                extra = (lambda: _prune_metrics(trainer, ts, tracer)) if cfg.prune.enable else None
                snaps.append({"step": host_step, **_log_point(host_step, metric_log, guard, log, tracer, extra)})
            if cfg.train.check_finite_every and host_step % cfg.train.check_finite_every == 0:
                # a forced host sync: a debug guard, off by default
                with tracer.span("sync/finite_check", "sync", step=host_step):
                    ok = float(metrics["finite"])
                reg.counter("train.forced_host_syncs").inc()
                if ok < 1.0:
                    log.error(f"non-finite loss at step {host_step}")
                    raise FloatingPointError("non-finite loss")
        epoch += epoch_steps / spe
        log.log(f"epoch {epoch:.2f} done in {time.perf_counter() - t_epoch:.1f}s")
        if cfg.prune.enable and remat_cad.due(host_step):
            remat_point()
        if eval_cad.due(host_step) or epoch >= cfg.train.epochs:
            eval_result = evaluate(trainer, ts, cfg, fake)
            log.log(format_metrics(f"eval @ epoch {epoch:.2f}:", eval_result))
            log.scalars(host_step, eval_result, "eval/")
    if guard is not None:
        guard.check(host_step)  # the verdicts the last log window missed
    searched = None
    if cfg.prune.enable:
        # the remaining masks applied physically, and the searched network
        # written as a standalone spec
        remat_point()
        searched = _write_searched(trainer, ts, cfg, log)
    final = {"epoch": epoch, "steps": host_step, "step": int(ts.step), "finite_steps": int(finite.item()),
             "seconds": time.perf_counter() - t_run, "device": str(dev), "checkpoints": NO_CHECKPOINTS,
             "log": snaps, **{f"eval_{k}": v for k, v in eval_result.items()}}
    if guard is not None:
        final["skipped_steps"] = guard.skipped_total
    if searched is not None:
        final.update(searched=searched, remats=remats)
    log.log(format_metrics("done:", {k: v for k, v in final.items() if isinstance(v, (int, float))})
            + f"; {NO_CHECKPOINTS}")
    return final, ts, trainer.net


def main(argv=None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return run(parse_cli(argv), device=device)


if __name__ == "__main__":
    main()

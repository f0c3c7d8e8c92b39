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

Not ported yet, each refused with a ``ValueError`` that names its entry in
``ROADMAP.md``: more than one device and the grouped step (queue 1, item
8), the AtomNAS search (item 7), resume, warm starts and eval-only runs
(item 9), the tuning file (item 12), and the watchdog, the fault injector
and the profiler window (item 10). Periodic checkpoints are not written
(item 9): the first log line and the returned summary say so.
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
from ..models.specs import Network
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
        (cfg.prune.enable, "prune.enable", "queue 1, item 7: the AtomNAS search"),
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
    """Builds and owns the step functions of one run on one device."""

    def __init__(self, cfg: Config, net: Network, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.net = net
        self.device = resolve_device(device)
        self.steps_per_epoch = max(cfg.data.fake_train_size // cfg.train.batch_size, 1)
        self.lr_fn = schedules.make_lr_schedule(cfg.schedule, cfg.train.batch_size, self.steps_per_epoch,
                                                cfg.train.epochs)
        params_example, _ = net.init(torch.Generator().manual_seed(0))
        self.optimizer = optim.make_optimizer(cfg.optim, self.lr_fn, params_example)
        step = steps.make_train_step(net, cfg, self.optimizer, self.lr_fn)
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


def _log_point(step_i: int, metric_log: MetricLogger, guard: StepGuard | None, log: Logger, tracer) -> dict:
    """The log boundary: the one place the loop reads the device (the
    pending metrics and the guard's verdicts)."""
    with tracer.span("sync/log_metrics", "sync", step=step_i):
        snap = metric_log.snapshot_and_reset(num_chips=1)
    obs_registry.get_registry().gauge("train.step").set(step_i)
    log.log(format_metrics(f"step {step_i}:", snap))
    log.scalars(step_i, snap, "train/")
    if guard is not None:
        guard.check(step_i)  # the guard rolled back any non-finite step already
    elif snap.get("finite", 1.0) < 1.0:
        log.error("non-finite loss detected; aborting")
        raise FloatingPointError("non-finite loss")
    return snap


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
            if host_step % cfg.train.log_every == 0:
                snaps.append({"step": host_step, **_log_point(host_step, metric_log, guard, log, tracer)})
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
        if eval_cad.due(host_step) or epoch >= cfg.train.epochs:
            eval_result = evaluate(trainer, ts, cfg, fake)
            log.log(format_metrics(f"eval @ epoch {epoch:.2f}:", eval_result))
            log.scalars(host_step, eval_result, "eval/")
    if guard is not None:
        guard.check(host_step)  # the verdicts the last log window missed
    final = {"epoch": epoch, "steps": host_step, "step": int(ts.step), "finite_steps": int(finite.item()),
             "seconds": time.perf_counter() - t_run, "device": str(dev), "checkpoints": NO_CHECKPOINTS,
             "log": snaps, **{f"eval_{k}": v for k, v in eval_result.items()}}
    if guard is not None:
        final["skipped_steps"] = guard.skipped_total
    log.log(format_metrics("done:", {k: v for k, v in final.items() if isinstance(v, (int, float))})
            + f"; {NO_CHECKPOINTS}")
    return final, ts, net


def main(argv=None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return run(parse_cli(argv), device=device)


if __name__ == "__main__":
    main()

"""Serving entry point of the port — ``python -m yet_another_mobilenet_series_tpu_torch.cli.serve
app:<yaml> [key=value ...] [--device cpu]``: the torch twin of the JAX
package's ``cli/serve.py``.

This slice ports its synthetic-load phase: load the bundle at
``serve.bundle``, build the engine as the JAX CLI does (the fused-K ladder
``serve.fuse_chunks``, overlapped staging and back-to-back runs
``serve.overlap``, the request ring ``serve.ring`` and the uint8 wire
``serve.quant.wire``, denormalized with ``data.mean``/``data.std``), capture
its graphs at warmup, and drive a closed-loop load of ``serve.requests``
single-image requests from ``serve.clients`` client threads through the
batcher (the pipelined continuous-batching one by default,
``serve.pipelined``). It prints p50/p99 end-to-end latency and QPS; with
``train.log_dir`` set, ``metrics`` rows, ``obs_registry.json`` and (with
``obs.trace``) ``obs_trace.json`` land there.

The engine runs on ``cuda``; ``--device cpu`` (parsed like the JAX CLI's
``--listen``, so the config schema stays the same) runs it on the CPU.

``serve.quant.weights`` applies at export, as in the JAX CLI, and export
from a checkpoint is not ported: an int8 bundle (exported with
``serve.export.export_bundle(quant_weights="int8")``) is served as int8
whatever the setting, and the run logs what it serves.

Refused while enabled, each naming its ROADMAP item: ``serve.export_from``,
``serve.zoo.models``, ``serve.listen``, ``serve.faults`` and
``serve.data_parallel``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

from ..config import Config, parse_cli
from ..obs import device as obs_device
from ..obs import registry as obs_registry
from ..obs import trace as obs_trace
from ..serve.batcher import MicroBatcher, QueueFull
from ..serve.engine import InferenceEngine
from ..serve.export import load_bundle
from ..serve.pipeline import PipelinedBatcher
from ..utils.benchkit import percentile
from ..utils.logging import Logger


def _refuse_unported(cfg: Config) -> None:
    s = cfg.serve
    refused = [
        (bool(s.export_from), "serve.export_from", "queue 1, item 9: checkpoints"),
        (bool(s.zoo.models), "serve.zoo.models", "queue 1b, S5: the model zoo"),
        (s.listen.enable, "serve.listen.enable", "queue 1b, S6: the front door and the fleet"),
        (s.faults.enable, "serve.faults.enable", "queue 1b, S6: the front door and the fleet"),
        (s.data_parallel, "serve.data_parallel", "queue 1, item 8: data parallel"),
    ]
    for enabled, key, item in refused:
        if enabled:
            raise ValueError(f"{key} is not ported yet (ROADMAP {item}); turn it off for the port's serve CLI")


def _synthetic_image(rng, image_size: int, wire: str) -> np.ndarray:
    """One synthetic client image in the configured wire's input space:
    normalized f32 pixels on the float32 wire (pipeline semantics), raw u8
    pixels on the uint8 wire (the engine denormalizes on device)."""
    if wire == "uint8":
        return rng.randint(0, 256, (image_size, image_size, 3)).astype(np.uint8)
    return rng.normal(0, 1, (image_size, image_size, 3)).astype(np.float32)


def _drive_load(cfg: Config, batcher: MicroBatcher, image_size: int, log: Logger) -> dict:
    """Closed-loop synthetic clients: each thread submits one request, waits
    for its logits, repeats. Returns the latency/QPS summary."""
    n_total = cfg.serve.requests
    n_clients = max(1, cfg.serve.clients)
    rng = np.random.RandomState(0)
    image = _synthetic_image(rng, image_size, cfg.serve.quant.wire)
    latencies: list[float] = []
    errors = {"shed": 0, "rejected": 0, "crashed": 0}
    lock = threading.Lock()
    counter = {"left": n_total}

    def client_inner():
        while True:
            with lock:
                if counter["left"] <= 0:
                    return
                counter["left"] -= 1
            t0 = time.perf_counter()
            try:
                fut = batcher.submit(image, deadline_ms=cfg.serve.deadline_ms or None)
                fut.result(timeout=60)
            except QueueFull:
                with lock:
                    errors["rejected"] += 1
                time.sleep(0.001)  # back off, as a real client would
                continue
            except Exception:  # noqa: BLE001 — shed/engine failure: count, keep driving
                with lock:
                    errors["shed"] += 1
                continue
            with lock:
                latencies.append(time.perf_counter() - t0)  # in completion order

    def client():
        # a silently-dead client thread would skew the measured load
        try:
            client_inner()
        except Exception:  # noqa: BLE001 — count the loss, keep the run honest
            with lock:
                errors["crashed"] += 1

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    by_completion = [v * 1e3 for v in latencies]
    latencies.sort()
    summary = {
        "requests": n_total,
        "completed": len(latencies),
        "shed": errors["shed"],
        "rejected_full": errors["rejected"],
        "client_crashes": errors["crashed"],
        "wall_s": wall,
        "qps": len(latencies) / wall if wall > 0 else 0.0,
        "p50_ms": percentile(latencies, 0.50) * 1e3,
        "p99_ms": percentile(latencies, 0.99) * 1e3,
        "latency_ms_by_completion": by_completion,
    }
    log.log(
        f"load: {summary['completed']}/{n_total} ok ({summary['shed']} shed, "
        f"{summary['rejected_full']} rejected), {summary['qps']:.1f} qps, "
        f"p50 {summary['p50_ms']:.2f} ms, p99 {summary['p99_ms']:.2f} ms"
    )
    return summary


def _make_batcher(cfg: Config, engine) -> MicroBatcher:
    common = dict(
        max_batch=cfg.serve.max_batch,
        max_wait_ms=cfg.serve.max_wait_ms,
        queue_depth=cfg.serve.queue_depth,
        default_deadline_ms=cfg.serve.deadline_ms,
        drain_timeout_s=cfg.serve.drain_timeout_s,
        wire_dtype=engine.wire_np_dtype,
    )
    if cfg.serve.pipelined:
        return PipelinedBatcher(
            engine,
            max_inflight=cfg.serve.max_inflight,
            # back-to-back dispatch rides the overlap block: a saturated
            # bucket dispatches runs with one completion wake-up per run
            run_max=cfg.serve.overlap.run_max if cfg.serve.overlap.enable else 1,
            # ring feed/drain engages iff the ENGINE has ring_slots > 0;
            # min_fill only sets the engagement threshold here
            ring_min_fill=cfg.serve.ring.min_fill,
            **common,
        )
    return MicroBatcher(engine.predict, **common)


def engine_kwargs(cfg: Config) -> dict:
    """The engine's keyword arguments from the config, as the JAX CLI wires
    them (``eng_kw``), without the mesh (data parallel is refused)."""
    return dict(
        buckets=cfg.serve.buckets,
        compute_dtype=cfg.serve.compute_dtype,
        image_size=cfg.data.image_size,
        image_sizes=cfg.serve.image_sizes,
        fuse_ladder=cfg.serve.fuse_chunks.ladder if cfg.serve.fuse_chunks.enable else (),
        offladder_cache=cfg.serve.offladder_cache,
        overlap_staging=cfg.serve.overlap.enable,
        staging_slots=cfg.serve.overlap.staging_slots,
        wire=cfg.serve.quant.wire,
        wire_mean=cfg.data.mean,
        wire_std=cfg.data.std,
        ring_slots=cfg.serve.ring.slots if cfg.serve.ring.enable else 0,
    )


def run(cfg: Config, device: str = "cuda") -> dict:
    """Load the bundle, capture the ladder, drive the synthetic load on
    ``device``; returns the load summary (with ``device``, the engine's
    ``dispatches``/``warmup_forwards``/``replays`` counts and its
    ``graph_report()`` as ``graphs``)."""
    _refuse_unported(cfg)
    if not cfg.serve.bundle:
        raise ValueError("serve: needs serve.bundle (export from a checkpoint is not ported yet)")
    log = Logger(cfg.train.log_dir, enabled=True, tensorboard=False)
    reg = obs_registry.get_registry()
    if cfg.obs.histogram_buckets:
        reg.set_default_buckets(cfg.obs.histogram_buckets)
    reg.set_build_info(obs_device.build_info())
    obs_device.install_memory_gauges(reg)
    log.set_registry(reg)
    tracer = obs_trace.configure(enabled=bool(cfg.obs.trace), ring_size=cfg.obs.trace_ring_size,
                                 process_name=f"replica pid-{os.getpid()}")
    result: dict = {}
    try:
        engine = InferenceEngine(load_bundle(cfg.serve.bundle), device=device, **engine_kwargs(cfg))
        result["device"] = str(engine.device)
        reg.set_build_info({**obs_device.build_info(), "quant_mode": engine.quant_mode})
        if cfg.serve.quant.weights != engine.weights:
            log.log(f"serve.quant.weights={cfg.serve.quant.weights} applies at export (serve.export_from, not "
                    f"ported); serving the bundle's {engine.weights} weights")
        before = reg.snapshot()
        if cfg.serve.warmup:
            t0 = time.perf_counter()
            engine.warmup()
            log.log(f"warmup: captured buckets {engine.buckets} x sizes {engine.image_sizes}"
                    + (f" + fused K {engine.fuse_ladder}" if engine.fuse_ladder else "")
                    + (f" + ring R={engine.ring_slots}" if engine.ring_slots else "")
                    + f" on {engine.device} ({engine.quant_mode}) in {time.perf_counter() - t0:.1f}s")
        if cfg.serve.requests > 0:
            batcher = _make_batcher(cfg, engine)
            batcher.start()
            try:
                result.update(_drive_load(cfg, batcher, cfg.data.image_size, log))
            finally:
                batcher.stop()
        after = reg.snapshot()

        def delta(key: str) -> int:
            return int(after.get(key, 0) - before.get(key, 0))

        # the pieces dispatched (a ring window is one), the keys captured at
        # warmup (one per ladder key), and the graph replays
        result["dispatches"] = delta("serve.dispatch_seconds.count")
        result["warmup_forwards"] = delta("serve.compile_seconds.count")
        result["replays"] = delta("serve.graph_replays")
        result["graphs"] = engine.graph_report()
        return result
    finally:
        if tracer.enabled and cfg.train.log_dir:
            path = tracer.write(os.path.join(cfg.train.log_dir, "obs_trace.json"))
            log.log(f"span trace -> {path}")
        if cfg.train.log_dir:
            os.makedirs(cfg.train.log_dir, exist_ok=True)
            with open(os.path.join(cfg.train.log_dir, "obs_registry.json"), "w") as f:
                json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
        log.close()


def parse_device(argv: list[str]) -> tuple[list[str], str]:
    """Strip ``--device <name>`` / ``--device=<name>`` from argv; returns the
    rest and the device (default ``cuda``)."""
    rest, device, i = [], "cuda", 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise ValueError("--device needs a value (cuda or cpu)")
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def main(argv=None):
    argv, device = parse_device(list(sys.argv[1:] if argv is None else argv))
    return run(parse_cli(argv), device=device)


if __name__ == "__main__":
    main()

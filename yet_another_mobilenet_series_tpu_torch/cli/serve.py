"""Serving entry point of the port — ``python -m yet_another_mobilenet_series_tpu_torch.cli.serve
app:<yaml> [key=value ...] [--device cpu]``: the torch twin of the JAX
package's ``cli/serve.py``.

It loads the bundle at ``serve.bundle``, or the named bundles of
``serve.zoo.models`` (``serve/zoo.py``: one engine serves them all, each
request naming its tenant); with ``serve.export_from`` it first exports that
checkpoint dir (``serve/export.py`` ``export_checkpoint``: the EMA weights
unless ``serve.use_ema=false``, dead masks applied, ``serve.quant.weights``
at export) into ``serve.bundle`` (default ``<train.log_dir>/bundle``) and
serves it. It builds the engine as the JAX CLI does (the
fused-K ladder ``serve.fuse_chunks``, overlapped staging and back-to-back
runs ``serve.overlap``, the request ring ``serve.ring`` and the uint8 wire
``serve.quant.wire``, denormalized with ``data.mean``/``data.std``),
captures its graphs at warmup, and wraps it in the seeded fault injector
when ``serve.faults.enable`` (``serve/faults.py``). Then two phases, both
optional:

1. **synthetic load** (``serve.requests`` > 0): a closed-loop load of
   single-image requests from ``serve.clients`` client threads through the
   batcher (the pipelined continuous-batching one by default,
   ``serve.pipelined``); it prints p50/p99 end-to-end latency and QPS.
2. **listen** (``serve.listen.enable``, or ``--listen``): the front door,
   ``serve/frontend.py`` on ``serve.listen.host``/``port`` before
   admission control (with the zoo's model vocabulary and quotas), the
   brownout ladder (``serve.brownout``) and the batcher, until SIGTERM or
   SIGINT, which stop accepting and drain in-flight work within
   ``serve.drain_timeout_s``. The bound address lands atomically in
   ``<train.log_dir>/listen_addr.json``; ``/profile/start`` and ``/stop``
   open a ``torch.profiler`` window written under ``<log_dir>/trace`` (or
   ``serve.listen.profile_dir``), closed at the drain if still open. With
   ``serve.listen.register_to`` the replica holds a TTL lease at a fleet
   router, advertising ``{model: digest}``; a replica spawned by
   ``cli/fleet.py`` drains itself when its supervisor process is gone.

With ``train.log_dir`` set, ``metrics`` rows, ``obs_registry.json`` and
(with ``obs.trace``) ``obs_trace.json`` land there.

The engine runs on ``cuda``; ``--device cpu`` (parsed like ``--listen``, so
the config schema stays the same) runs it on the CPU. A replica asked for
the card on a machine without one fails before it binds.

``serve.quant.weights`` applies at export, as in the JAX CLI: with
``serve.export_from`` and ``int8`` the export calibrates on seeded
synthetic pixels (``serve.quant.calib_*``) and is gated by
``serve.quant.int8_top1_min``; a bundle given as it is is served with its
own weights, and the run logs what it serves.

Refused while enabled, each naming its ROADMAP entry:
``serve.data_parallel``, and ``serve.faults`` together with
``serve.zoo.models`` (queue 3, F3: the fault injector's ``predict_async``
takes no ``model=``, so the batcher would send every request to the
default tenant).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

import numpy as np

from ..config import Config, parse_cli
from ..obs import device as obs_device
from ..obs import registry as obs_registry
from ..obs import trace as obs_trace
from ..obs.watchdog import StallWatchdog
from ..serve.admission import AdmissionController
from ..serve.batcher import MicroBatcher, QueueFull
from ..serve.brownout import BrownoutController
from ..serve.engine import InferenceEngine
from ..serve import quant
from ..serve.export import export_checkpoint, load_bundle
from ..serve.faults import FaultyEngine
from ..serve.frontend import Frontend, write_listen_addr
from ..serve.pipeline import PipelinedBatcher
from ..serve.signals import SignalReader
from ..utils.benchkit import percentile
from ..utils.logging import Logger


def _refuse_unported(cfg: Config) -> None:
    s = cfg.serve
    refused = [
        (s.data_parallel, "serve.data_parallel (the serving mesh) is not ported yet",
         "queue 1, item 8: what it left"),
        (s.faults.enable and bool(s.zoo.models), "serve.faults with serve.zoo.models would send every request "
         "to the default tenant", "queue 3, F3"),
    ]
    for enabled, what, item in refused:
        if enabled:
            raise ValueError(f"{what} (ROADMAP {item}); turn it off for the port's serve CLI")


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


def _serving_info(batcher, admission) -> dict:
    """The watchdog hang report's ``serving`` section: the batcher's threads
    and in-flight window, the breaker and queues, and the oldest in-flight
    request (which hop it is stuck at)."""
    info: dict = {"admission": admission.state(), "oldest_request": admission.oldest_inflight()}
    if hasattr(batcher, "worker_threads"):
        info["batcher_threads"] = batcher.worker_threads()
        info["inflight"] = batcher.inflight()
    else:
        t = batcher._thread
        info["batcher_threads"] = [] if t is None else [{"name": t.name, "alive": t.is_alive()}]
    return info


def _listen(cfg: Config, engine, log: Logger, reg, tracer, zoo=None, stop_event=None) -> dict:
    """The front door: HTTP frontend, admission and batcher, until SIGTERM or
    SIGINT (or ``stop_event``, for a run embedded in a thread), then a
    bounded drain."""
    stop_event = stop_event or threading.Event()

    def _on_signal(signum, frame):
        log.log(f"signal {signum}: stopping accept loop, draining in-flight work")
        stop_event.set()

    # only the main thread may install handlers; an embedded run is stopped
    # through stop_event
    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:
        pass

    # a replica spawned by cli/fleet.py (which sets YAMT_FLEET_PARENT) drains
    # itself when its supervisor process is gone: a supervisor killed with -9
    # runs no drain, and an orphan would hold its port and the card forever
    supervisor_pid = os.environ.get("YAMT_FLEET_PARENT")

    def _orphan_watch():
        try:
            parent = int(supervisor_pid)
            while not stop_event.wait(0.5):
                if os.getppid() != parent:
                    log.log(f"supervisor {parent} gone (now child of {os.getppid()}): orphaned — draining")
                    reg.counter("serve.orphan_exits").inc()
                    stop_event.set()
                    return
        except Exception as e:  # noqa: BLE001 — a dead watcher would silently drop orphan protection
            reg.counter("serve.thread_crashes").inc()
            log.log(f"[serve] orphan watcher crashed: {type(e).__name__}: {e}")

    if supervisor_pid:
        threading.Thread(target=_orphan_watch, name="serve-orphan-watch", daemon=True).start()

    batcher = _make_batcher(cfg, engine).start()
    watchdog = None
    if cfg.obs.watchdog_deadline_s > 0 and cfg.train.log_dir:
        watchdog = StallWatchdog(cfg.train.log_dir, cfg.obs.watchdog_deadline_s, tracer=tracer, registry=reg,
                                 poll_s=cfg.obs.watchdog_poll_s, logger=log)
    admission = AdmissionController.from_config(
        batcher,
        cfg.serve.admission,
        heartbeat=(lambda: watchdog.arm(phase="serve")) if watchdog is not None else None,
        # a zoo replica checks X-Model at the door and meters per-model quotas
        **(zoo.admission_kwargs() if zoo is not None else {}),
    )
    if watchdog is not None:
        watchdog.register_info("serving", lambda: _serving_info(batcher, admission))
        watchdog.start()
    # the brownout ladder at the replica tier: this process's own signals
    # (windowed per-class p99, admitted backlog, breaker) acting on the
    # batcher and admission
    brownout = None
    if cfg.serve.brownout.enable:
        brownout = BrownoutController.from_config(
            cfg.serve.brownout,
            SignalReader(latency_family="serve.latency_seconds", signal_class=cfg.serve.brownout.signal_class,
                         queue_depth_fn=admission.queued_total),
            targets=(batcher, admission),
        ).start()
        log.log(f"brownout ladder armed (L0..L{cfg.serve.brownout.max_level}, up p99 > "
                f"{cfg.serve.brownout.up_p99_ms:.0f}ms or queue > {cfg.serve.brownout.up_queue_depth:.0f})")
    # the HTTP-triggered torch.profiler window (obs/device.py); the drain
    # below closes one still open
    profile_dir = cfg.serve.listen.profile_dir or (
        os.path.join(cfg.train.log_dir, "trace") if cfg.train.log_dir else "")
    profiler = obs_device.ProfilerCapture(profile_dir) if profile_dir else None
    frontend = Frontend(
        admission,
        host=cfg.serve.listen.host,
        port=cfg.serve.listen.port,
        request_timeout_s=cfg.serve.listen.request_timeout_s,
        retry_after_s=cfg.serve.admission.breaker_cooldown_s,
        profiler=profiler,
        replica_id=cfg.serve.listen.replica_id,
    ).start()
    # the bound port (listen.port=0 is ephemeral), published atomically so
    # that a polling supervisor never reads a partial file
    addr = {"host": cfg.serve.listen.host, "port": frontend.port, "pid": os.getpid(),
            "replica_id": frontend.replica_id}
    if cfg.train.log_dir:
        write_listen_addr(cfg.train.log_dir, addr)
    log.log(f"listening on {frontend.url} (POST /predict, GET /healthz|/metrics|/varz)")
    # TTL-lease self-registration at a fleet router that never spawned this
    # replica (serve.listen.register_to), advertising {model: digest}
    reg_client = None
    if cfg.serve.listen.register_to:
        from ..serve.client import ClientHTTPError, ReplicaClient
        r_host, r_port = cfg.serve.listen.register_to.rsplit(":", 1)
        ttl_s = cfg.serve.listen.register_ttl_s
        reg_client = ReplicaClient(r_host, int(r_port), timeout_s=5.0, connect_timeout_s=2.0)
        lease_models = zoo.lease_models() if zoo is not None else None

        def _heartbeat():
            try:
                period = max(ttl_s / 3.0, 0.1)
                while not stop_event.is_set():
                    try:
                        reg_client.register(addr["host"], addr["port"], ttl_s=ttl_s,
                                            replica_id=frontend.replica_id, models=lease_models)
                        reg.counter("serve.register_heartbeats").inc()
                    except ClientHTTPError as e:
                        if e.tag == "digest_conflict":
                            # the fleet serves another artifact under one of
                            # our names: renewing can never succeed
                            reg.counter("serve.register_conflicts").inc()
                            log.log(f"[serve] register REFUSED (digest conflict): {e}")
                            return
                        reg.counter("serve.register_failures").inc()
                    except Exception:  # noqa: BLE001 — the router may be down; the next renewal re-admits us
                        reg.counter("serve.register_failures").inc()
                    stop_event.wait(period)
            except Exception as e:  # noqa: BLE001 — a dead heartbeat would let the lease lapse silently
                reg.counter("serve.thread_crashes").inc()
                log.log(f"[serve] register heartbeat crashed: {type(e).__name__}: {e}")

        threading.Thread(target=_heartbeat, name="serve-register", daemon=True).start()
        log.log(f"registering with {cfg.serve.listen.register_to} (ttl={ttl_s:.1f}s)")
    try:
        stop_event.wait()
    finally:
        t0 = time.perf_counter()
        if reg_client is not None:
            try:
                # a clean drain leaves the fleet now, not at the lease's end
                reg_client.deregister(addr["host"], addr["port"])
            except Exception:  # noqa: BLE001 — the router may be gone; the lease lapses on its own
                reg.counter("serve.deregister_failures").inc()
            reg_client.close()
        frontend.stop()
        if brownout is not None:
            brownout.stop()
        if profiler is not None:
            profiler.stop_if_active()
        batcher.stop(drain=True)  # bounded by serve.drain_timeout_s
        if watchdog is not None:
            watchdog.stop()
        drain_s = time.perf_counter() - t0
        timeouts = int(reg.snapshot().get("serve.drain_timeouts", 0))
        log.log(f"drained in {drain_s:.2f}s ({'clean' if not timeouts else 'DRAIN TIMEOUT'})")
    return {"listened": True, **addr, "drain_s": drain_s, "drain_timeouts": timeouts}


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


def run(cfg: Config, device: str = "cuda", stop_event: threading.Event | None = None) -> dict:
    """Load the bundle (or the zoo), capture the ladder, drive the synthetic
    load and/or listen on ``device``; returns the load summary (with
    ``device``, the engine's ``dispatches``/``warmup_forwards``/``replays``
    counts and its ``graph_report()`` as ``graphs``) and, after a listen,
    its address and drain. ``stop_event`` ends a listen run embedded in a
    thread, where no signal handler can be installed."""
    _refuse_unported(cfg)
    if not cfg.serve.bundle and not cfg.serve.zoo.models and not cfg.serve.export_from:
        raise ValueError("serve: needs serve.bundle, serve.zoo.models, and/or serve.export_from")
    log = Logger(cfg.train.log_dir, enabled=True, tensorboard=False)
    reg = obs_registry.get_registry()
    if cfg.obs.histogram_buckets:
        reg.set_default_buckets(cfg.obs.histogram_buckets)
    reg.set_build_info(obs_device.build_info())
    obs_device.install_memory_gauges(reg)
    log.set_registry(reg)
    # the merged fleet trace's lane label: the supervisor-assigned replica id
    tracer = obs_trace.configure(enabled=bool(cfg.obs.trace), ring_size=cfg.obs.trace_ring_size,
                                 process_name=cfg.serve.listen.replica_id or f"replica pid-{os.getpid()}")
    result: dict = {}
    try:
        bundle_dir = cfg.serve.bundle
        if cfg.serve.export_from:
            bundle_dir = bundle_dir or os.path.join(cfg.train.log_dir, "bundle")
            calib = None
            if cfg.serve.quant.weights == "int8":
                # the int8 gate's held-out batch: seeded synthetic u8 pixels
                # normalized as the pipeline would (no dataset is wired into
                # the serve CLI; the bundle's provenance records it)
                q = cfg.serve.quant
                raw = np.random.RandomState(q.calib_seed).randint(
                    0, 256, (q.calib_batches * q.calib_batch_size, cfg.data.image_size, cfg.data.image_size, 3)
                ).astype(np.uint8)
                calib = quant.normalize_reference(raw, cfg.data.mean, cfg.data.std)
            export_checkpoint(cfg.serve.export_from, bundle_dir, use_ema=cfg.serve.use_ema,
                              quant_weights=cfg.serve.quant.weights, calib_images=calib,
                              int8_top1_min=cfg.serve.quant.int8_top1_min, device=device)
            log.log(f"exported {cfg.serve.export_from} -> {bundle_dir}"
                    + (" (int8 weights, parity-gated)" if calib is not None else ""))
            result["bundle"] = bundle_dir
        # the zoo (serve.zoo.models): several named bundles behind one engine
        zoo = None
        if cfg.serve.zoo.models:
            from ..serve.zoo import ModelZoo
            zoo = ModelZoo.from_config(cfg.serve.zoo)
            log.log(f"zoo: serving {', '.join(zoo.models)} (default {zoo.default})")
            engine = InferenceEngine(**zoo.engine_kwargs(), device=device, **engine_kwargs(cfg))
        else:
            engine = InferenceEngine(load_bundle(bundle_dir), device=device, **engine_kwargs(cfg))
        result["device"] = str(engine.device)
        reg.set_build_info({**obs_device.build_info(), "quant_mode": engine.quant_mode})
        if cfg.serve.quant.weights != engine.weights:
            log.log(f"serve.quant.weights={cfg.serve.quant.weights} applies at export (serve.export_from); "
                    f"serving the bundle's {engine.weights} weights")
        before = reg.snapshot()
        if cfg.serve.warmup:
            t0 = time.perf_counter()
            engine.warmup()
            log.log(f"warmup: captured buckets {engine.buckets} x sizes "
                    + ", ".join(f"{m} {engine.model_image_ladder(m)} ({engine.model_weights(m)})"
                                for m in engine.models)
                    + (f" + fused K {engine.fuse_ladder}" if engine.fuse_ladder else "")
                    + (f" + ring R={engine.ring_slots}" if engine.ring_slots else "")
                    + f" on {engine.device} ({engine.quant_mode}) in {time.perf_counter() - t0:.1f}s")
        served = FaultyEngine.from_config(engine, cfg.serve.faults)
        if cfg.serve.faults.enable:
            log.log(f"CHAOS: fault injection on (seed={cfg.serve.faults.seed}, failure_rate="
                    f"{cfg.serve.faults.failure_rate}, fail_first_n={cfg.serve.faults.fail_first_n})")
        if cfg.serve.requests > 0:
            batcher = _make_batcher(cfg, served)
            batcher.start()
            try:
                result.update(_drive_load(cfg, batcher, cfg.data.image_size, log))
            finally:
                batcher.stop()
        if cfg.serve.listen.enable:
            result.update(_listen(cfg, served, log, reg, tracer, zoo=zoo, stop_event=stop_event))
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
    # --listen is sugar for serve.listen.enable=true
    argv = ["serve.listen.enable=true" if a == "--listen" else a for a in argv]
    return run(parse_cli(argv), device=device)


if __name__ == "__main__":
    main()

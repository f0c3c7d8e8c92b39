# Copy of yet_another_mobilenet_series_tpu/cli/fleet.py: the port keeps its own copy so that it never imports the
# JAX package. It spawns the port's cli/serve.py and passes --device to every replica; keep the rest in step by hand.
"""Fleet entry point — ``python -m yet_another_mobilenet_series_tpu.cli.fleet
app:<yaml> serve.bundle=<dir> [key=value ...]``.

Spawns and supervises N ``cli/serve.py --listen`` replica subprocesses on
ephemeral ports and puts the fleet router (serve/router.py) in front of them
as an ordinary frontend — same endpoints, same typed statuses, same
``X-Request-Id`` threading — so to a client the fleet IS one replica, just
one that survives the death of any of its processes. The supervisor process
itself never imports jax: replicas own the device; the parent owns policy.

What runs here:

- **spawn**: each replica is ``cli/serve.py`` with the SAME config plus per
  -slot overrides (``serve.listen.port=0``, ``serve.listen.replica_id=r<i>``,
  its own ``train.log_dir``). The bound port is read from the replica's
  atomically-renamed ``listen_addr.json`` (a poll never sees partial JSON)
  and cross-checked against the child pid, bounded by
  ``serve.fleet.spawn_timeout_s``.
- **supervision**: a guarded thread restarts any replica that exits while
  wanted (``fleet.restarts``), with per-slot exponential backoff
  (``restart_backoff_ms`` doubling to ``restart_backoff_max_s``) so a
  crash-looping artifact cannot spin the host. Every membership change is
  pushed to the router (``on_change`` -> ``Router.set_backends``).
- **scaling**: :meth:`FleetSupervisor.scale_to` adds replicas (new slots)
  or drains the newest ones — the autoscaler's one dependency.
- **rolling restart** (SIGHUP): replicas drain and respawn ONE AT A TIME,
  each waiting for its successor to bind before the next drain starts, so
  capacity never drops by more than one replica.
- **replica chaos** (``serve.fleet.chaos``): a seeded schedule of kill -9
  against random live replicas mid-load (``fleet.chaos_kills``) — the
  process-granular twin of serve/faults.py, exercising restart-on-exit,
  router ejection/readmission, and transport-retry for real.

SIGTERM/SIGINT: stop accepting at the router, then drain every replica
sequentially (each bounded by its own SIGTERM drain), then exit 0.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from ..config import Config, parse_cli
from ..obs import device as obs_device
from ..obs import registry as obs_registry
from ..obs import trace as obs_trace
from ..obs.fleet import FleetFederation, FlightRecorder
from ..obs.watchdog import StallWatchdog
from ..serve.autoscale import Autoscaler
from ..serve.brownout import BrownoutController
from ..serve.frontend import Frontend, write_listen_addr
from ..serve.hedge import ROUTER_LATENCY, Hedger
from ..serve.netchaos import NetChaosTier
from ..serve.router import Router
from ..serve.signals import SignalReader, SLOTracker
from ..utils.logging import Logger, emit
from .serve import parse_device

# repo root (the package's parent): child interpreters must resolve the
# package no matter where the operator launched the supervisor from
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class FleetSpawnError(RuntimeError):
    """A replica failed to come up (died early or never published its
    listen_addr.json inside spawn_timeout_s)."""


# Why not PR_SET_PDEATHSIG: the kernel delivers it when the forking THREAD
# exits, not the process — the supervisor spawns from short-lived threads,
# so pdeathsig SIGTERMed freshly-bound replicas the moment their spawn
# thread finished (measured). The orphan guard lives on the REPLICA side
# instead: cli/serve.py polls getppid() against this env var and
# self-drains when its supervisor process is gone (kill -9 included), so a
# dead supervisor can never leak replicas — the process-level YAMT015
# hazard, closed portably.
ORPHAN_ENV = "YAMT_FLEET_PARENT"


class ReplicaHandle:
    """One replica subprocess: spawn, readiness, drain, kill."""

    def __init__(self, slot: int, argv: list[str], log_dir: str, *,
                 spawn_timeout_s: float = 120.0, env: dict | None = None):
        self.slot = slot
        self.argv = argv
        self.log_dir = log_dir
        self.spawn_timeout_s = spawn_timeout_s
        self._env = env
        self._proc: subprocess.Popen | None = None
        self._log_file = None
        self.addr: dict | None = None

    @property
    def pid(self) -> int | None:
        return self._proc.pid if self._proc is not None else None

    @property
    def returncode(self) -> int | None:
        return self._proc.returncode if self._proc is not None else None

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def spawn(self) -> "ReplicaHandle":
        """Launch the replica and block until it publishes its bound address
        (atomic listen_addr.json) or the spawn budget runs out — in which
        case the half-started child is killed, never leaked."""
        os.makedirs(self.log_dir, exist_ok=True)
        addr_path = os.path.join(self.log_dir, "listen_addr.json")
        if os.path.exists(addr_path):
            os.remove(addr_path)  # a stale address from a previous incarnation
        env = dict(os.environ if self._env is None else self._env)
        env["PYTHONPATH"] = _PKG_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        # the replica self-drains if THIS process disappears (see ORPHAN_ENV)
        env[ORPHAN_ENV] = str(os.getpid())
        self._log_file = open(os.path.join(self.log_dir, "replica.log"), "ab")
        self._proc = subprocess.Popen(
            self.argv, stdout=self._log_file, stderr=subprocess.STDOUT, env=env
        )
        try:
            self.addr = self._wait_ready(addr_path)
        except Exception:
            # the exception edge must not leak a half-started child: bounded
            # terminate -> kill, then re-raise the spawn failure
            self.kill(sig=signal.SIGKILL)
            raise
        return self

    def _wait_ready(self, addr_path: str) -> dict:
        deadline = time.monotonic() + self.spawn_timeout_s
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise FleetSpawnError(
                    f"replica {self.slot} exited rc={self._proc.returncode} before binding "
                    f"(see {self.log_dir}/replica.log)"
                )
            if os.path.exists(addr_path):
                with open(addr_path) as f:
                    addr = json.load(f)  # whole JSON by the rename contract
                if addr.get("pid") == self._proc.pid:
                    return addr
            time.sleep(0.1)
        raise FleetSpawnError(
            f"replica {self.slot} never published {addr_path} within {self.spawn_timeout_s:.0f}s"
        )

    def drain(self, timeout_s: float = 30.0) -> bool:
        """SIGTERM -> bounded wait (the replica's own drain path runs);
        escalate to SIGKILL if the budget runs out. True = clean exit."""
        if self._proc is None:
            return True
        clean = True
        try:
            if self._proc.poll() is None:
                self._proc.send_signal(signal.SIGTERM)
            try:
                self._proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                clean = False
                self._proc.kill()
                self._proc.wait(timeout=10.0)
        except ProcessLookupError:
            pass  # already reaped
        self._close_log()
        return clean

    def send_signal(self, sig: int) -> bool:
        """Deliver ``sig`` WITHOUT waiting (the chaos hook: a kill -9 must
        not politely reap before the supervisor notices the death)."""
        if self._proc is None or self._proc.poll() is not None:
            return False
        try:
            self._proc.send_signal(sig)
        except ProcessLookupError:
            return False
        return True

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Immediate (chaos / cleanup) kill with a bounded reap."""
        if self._proc is None:
            return
        try:
            if self._proc.poll() is None:
                self._proc.send_signal(sig)
            self._proc.wait(timeout=10.0)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            pass
        self._close_log()

    def _close_log(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None


class _Slot:
    """Supervisor bookkeeping for one replica position."""

    __slots__ = ("idx", "handle", "wanted", "busy", "generation",
                 "consecutive_crashes", "next_restart_t", "last_spawn_t")

    def __init__(self, idx: int):
        self.idx = idx
        self.handle: ReplicaHandle | None = None
        self.wanted = True
        self.busy = False  # a spawn/drain is in flight for this slot
        self.generation = 0
        self.consecutive_crashes = 0
        self.next_restart_t = 0.0
        self.last_spawn_t = 0.0


class FleetSupervisor:
    """Spawns, restarts, scales, and drains the replica set."""

    # a replica that survived this long resets its crash-backoff ladder
    CRASH_RESET_S = 30.0

    def __init__(
        self,
        *,
        replica_argv: list[str],
        log_dir: str,
        replicas: int = 2,
        restart_backoff_ms: float = 200.0,
        restart_backoff_max_s: float = 5.0,
        spawn_timeout_s: float = 120.0,
        drain_timeout_s: float = 30.0,
        supervise_poll_s: float = 0.2,
        per_slot_argv: dict[int, list[str]] | None = None,
        on_change=None,
        spawn_fn=None,
        logger=None,
    ):
        self._replica_argv = list(replica_argv)
        self._log_dir = log_dir
        self._n_initial = max(1, int(replicas))
        self._backoff_s = restart_backoff_ms / 1e3
        self._backoff_max_s = restart_backoff_max_s
        self._spawn_timeout_s = spawn_timeout_s
        self._drain_timeout_s = drain_timeout_s
        self._supervise_poll_s = supervise_poll_s
        self._per_slot_argv = dict(per_slot_argv or {})
        self._on_change = on_change  # e.g. Router.set_backends (addresses list)
        self._spawn_fn = spawn_fn or self._spawn_real
        self._log = logger
        self._lock = threading.Lock()
        self._slots: dict[int, _Slot] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._reg = obs_registry.get_registry()

    # -- spawning ------------------------------------------------------------

    def _spawn_real(self, slot: int) -> ReplicaHandle:
        argv = [
            sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.serve",
            *self._replica_argv,
            "serve.listen.enable=true",
            "serve.listen.port=0",
            f"serve.listen.replica_id=r{slot}",
            f"train.log_dir={os.path.join(self._log_dir, f'r{slot}')}",
            *self._per_slot_argv.get(slot, []),
        ]
        return ReplicaHandle(
            slot, argv, os.path.join(self._log_dir, f"r{slot}"),
            spawn_timeout_s=self._spawn_timeout_s,
        ).spawn()

    def _emit(self, msg: str) -> None:
        if self._log is not None:
            self._log.log(msg)
        else:
            emit(msg)

    def _spawn_slot(self, slot: _Slot) -> bool:
        slot.last_spawn_t = time.monotonic()
        try:
            handle = self._spawn_fn(slot.idx)
        except Exception as e:  # noqa: BLE001 — a failed spawn backs off, not crashes
            self._reg.counter("fleet.spawn_failures").inc()
            self._emit(f"[fleet] spawn r{slot.idx} failed: {type(e).__name__}: {e}")
            return False
        with self._lock:
            slot.handle = handle
            slot.generation += 1
        self._reg.counter("fleet.spawns").inc()
        self._emit(f"[fleet] replica r{slot.idx} up: pid={handle.pid} "
                   f"addr={handle.addr['host']}:{handle.addr['port']}")
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            raise RuntimeError("fleet already started")
        with self._lock:
            for i in range(self._n_initial):
                self._slots[i] = _Slot(i)
        # parallel first spawn: N children import/compile concurrently
        threads = [
            threading.Thread(target=self._first_spawn_guarded, args=(s,), daemon=True,
                             name=f"fleet-spawn-r{s.idx}")
            for s in self._slots.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if not self.addresses():
            self.stop()
            raise FleetSpawnError("no replica came up; fleet cannot start")
        self._notify()
        self._stop.clear()
        self._thread = threading.Thread(target=self._supervise, name="fleet-supervise", daemon=True)
        self._thread.start()
        return self

    def _first_spawn_guarded(self, slot: _Slot) -> None:
        try:  # YAMT011: a dead spawn thread would silently halve the fleet
            self._spawn_slot(slot)
        except Exception as e:  # noqa: BLE001 — contain; start() checks coverage
            self._reg.counter("serve.thread_crashes").inc()
            self._emit(f"[fleet] spawn thread r{slot.idx} crashed: {type(e).__name__}: {e}")

    def stop(self) -> None:
        """Stop supervising, then drain every replica sequentially (each
        bounded); the fleet exits with no child left behind."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            slots = list(self._slots.values())
            for s in slots:
                s.wanted = False
        for s in slots:
            if s.handle is not None:
                s.handle.drain(self._drain_timeout_s)
        self._notify()

    # -- supervision (restart-on-exit with backoff) --------------------------

    def _supervise(self) -> None:
        try:  # YAMT011: the supervisor dying silently orphans the fleet
            while not self._stop.wait(self._supervise_poll_s):
                self._supervise_once()
        except Exception as e:  # noqa: BLE001 — contain, count, report
            self._reg.counter("serve.thread_crashes").inc()
            self._emit(f"[fleet] supervise thread crashed: {type(e).__name__}: {e}")

    def _supervise_once(self) -> None:
        now = time.monotonic()
        with self._lock:
            slots = [s for s in self._slots.values() if s.wanted and not s.busy]
        changed = False
        for s in slots:
            if s.handle is not None and s.handle.alive():
                if s.consecutive_crashes and now - s.last_spawn_t > self.CRASH_RESET_S:
                    s.consecutive_crashes = 0  # survived: the loop is over
                continue
            if s.handle is not None:
                # died while wanted: schedule the restart with backoff
                rc = s.handle.returncode
                s.handle._close_log()
                s.handle = None
                changed = True
                backoff = min(self._backoff_s * (2 ** s.consecutive_crashes), self._backoff_max_s)
                s.consecutive_crashes += 1
                s.next_restart_t = now + backoff
                self._emit(f"[fleet] replica r{s.idx} exited rc={rc}; "
                           f"restart in {backoff * 1e3:.0f}ms")
            if s.handle is None and now >= s.next_restart_t:
                self._reg.counter("fleet.restarts").inc()
                if self._spawn_slot(s):
                    changed = True
                else:
                    backoff = min(self._backoff_s * (2 ** s.consecutive_crashes),
                                  self._backoff_max_s)
                    s.consecutive_crashes += 1
                    s.next_restart_t = time.monotonic() + backoff
        if changed:
            self._notify()

    def _notify(self) -> None:
        self._reg.gauge("fleet.replicas").set(self.n_replicas)
        if self._on_change is not None:
            try:
                self._on_change(self.addresses())
            except Exception as e:  # noqa: BLE001 — a router hiccup must not kill supervision
                self._emit(f"[fleet] membership notify failed: {type(e).__name__}: {e}")

    # -- introspection -------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values() if s.wanted)

    def addresses(self) -> list[tuple[str, int]]:
        with self._lock:
            return [
                (s.handle.addr["host"], s.handle.addr["port"])
                for s in self._slots.values()
                if s.wanted and s.handle is not None and s.handle.addr is not None
            ]

    def replicas(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "slot": s.idx,
                    "wanted": s.wanted,
                    "alive": s.handle.alive() if s.handle else False,
                    "pid": s.handle.pid if s.handle else None,
                    "addr": s.handle.addr if s.handle else None,
                    "generation": s.generation,
                    "consecutive_crashes": s.consecutive_crashes,
                }
                for s in self._slots.values()
            ]

    # -- scaling / rolling restart / chaos -----------------------------------

    def scale_to(self, n: int) -> int:
        """Grow or shrink to ``n`` replicas (blocking: spawns wait for bind,
        drains wait for exit). Shrink drains the NEWEST slots first. Returns
        the achieved count."""
        n = max(1, int(n))
        with self._lock:
            wanted = sorted(s.idx for s in self._slots.values() if s.wanted)
            grow = n - len(wanted)
            new_slots: list[_Slot] = []
            victims: list[_Slot] = []
            if grow > 0:
                next_idx = (max(self._slots) + 1) if self._slots else 0
                for i in range(grow):
                    s = _Slot(next_idx + i)
                    s.busy = True
                    self._slots[s.idx] = s
                    new_slots.append(s)
            elif grow < 0:
                for idx in wanted[grow:]:
                    s = self._slots[idx]
                    s.wanted = False
                    s.busy = True
                    victims.append(s)
        for s in new_slots:
            self._spawn_slot(s)
            with self._lock:
                s.busy = False
        for s in victims:
            if s.handle is not None:
                s.handle.drain(self._drain_timeout_s)
            with self._lock:
                s.handle = None
                del self._slots[s.idx]
        if new_slots or victims:
            self._notify()
        return self.n_replicas

    def rolling_restart(self) -> int:
        """Drain + respawn every replica ONE AT A TIME (capacity never drops
        by more than one). Returns the number restarted."""
        with self._lock:
            order = sorted(s.idx for s in self._slots.values() if s.wanted)
        restarted = 0
        for idx in order:
            with self._lock:
                s = self._slots.get(idx)
                if s is None or not s.wanted or s.busy:
                    continue
                s.busy = True
            try:
                if s.handle is not None:
                    s.handle.drain(self._drain_timeout_s)
                    s.handle = None
                    self._notify()  # the router must stop routing here NOW
                if self._spawn_slot(s):
                    restarted += 1
                    s.consecutive_crashes = 0
            finally:
                with self._lock:
                    s.busy = False
            self._notify()
        self._reg.counter("fleet.rolling_restarts").inc()
        return restarted

    def kill_replica(self, slot: int | None = None, *, sig: int = signal.SIGKILL,
                     rng: random.Random | None = None) -> int | None:
        """Chaos: kill one live replica (seeded-random when ``slot`` is
        None). The supervise loop restarts it; the router ejects it the
        moment a poll or dispatch hits the dead socket."""
        with self._lock:
            live = [s for s in self._slots.values()
                    if s.wanted and s.handle is not None and s.handle.alive()]
            if not live:
                return None
            target = (
                next((s for s in live if s.idx == slot), None) if slot is not None
                else (rng or random).choice(live)
            )
            if target is None:
                return None
            handle = target.handle
        self._reg.counter("fleet.chaos_kills").inc()
        self._emit(f"[fleet] CHAOS: sending signal {sig} to replica r{target.idx} "
                   f"(pid {handle.pid})")
        if not handle.send_signal(sig):
            return None
        return target.idx

    def pick_live_slot(self, rng: random.Random | None = None) -> int | None:
        """One seeded-random live slot index (the degrade chaos victim)."""
        with self._lock:
            live = [s for s in self._slots.values()
                    if s.wanted and s.handle is not None and s.handle.alive()]
        return (rng or random).choice(live).idx if live else None

    def signal_replica(self, slot: int, sig: int) -> bool:
        """Deliver ``sig`` to one slot's live replica with NO lifecycle
        bookkeeping — the degrade-chaos pulse path (SIGSTOP/SIGCONT leave
        the process alive; the supervisor must not treat it as an exit)."""
        with self._lock:
            s = self._slots.get(slot)
            handle = s.handle if s is not None and s.wanted else None
        if handle is None:
            return False
        return handle.send_signal(sig)


class FleetChaos:
    """Seeded chaos schedule against the live fleet (serve.fleet.chaos).

    Three modes:

    - ``kill`` — the crash drill: SIGKILL/SIGTERM a seeded live
      replica after ``kill_after_s`` (repeating every ``kill_period_s``);
      exercises restart-on-exit, crash ejection, transport retry.
    - ``degrade`` — the GRAY-failure drill: the seeded victim is pulsed
      SIGSTOP for ``degrade_stop_ms`` out of every ``degrade_period_ms``
      over ``degrade_duration_s``, then released with a final SIGCONT. The
      process never exits — sockets stay open, /healthz still answers
      between pulses — it just gets SLOW (a GC pause / noisy-neighbor
      stand-in), which only the router's latency-based soft ejection can
      act on. Counted ``fleet.chaos_degrades``; pulses are bounded and the
      stop path always delivers the releasing SIGCONT so a cancelled drill
      cannot leave a replica frozen.
    - ``partition`` — the NETWORK drill: the seeded victim's
      netchaos proxy (serve/netchaos.py, requires the
      ``serve.fleet.netchaos`` tier) is switched to the configured fault
      shape — blackhole, reset, half-open, response loss — for
      ``degrade_duration_s``, then healed. The replica process never
      notices; only the LINK misbehaves, which is exactly the failure the
      connect/read timeout split and lease expiry exist to contain.
      Counted ``fleet.chaos_partitions``; the stop path always heals the
      link so a cancelled drill cannot leave a permanent partition.
    """

    def __init__(self, fleet: FleetSupervisor | None, *, seed: int = 0,
                 kill_after_s: float = 2.0,
                 kill_period_s: float = 0.0, sig: int = signal.SIGKILL,
                 mode: str = "kill", degrade_stop_ms: float = 150.0,
                 degrade_period_ms: float = 500.0, degrade_duration_s: float = 10.0,
                 netchaos_tier: NetChaosTier | None = None,
                 partition_fault: str = "blackhole"):
        if mode not in ("kill", "degrade", "partition"):
            raise ValueError(f"chaos mode must be kill|degrade|partition, got {mode!r}")
        if mode == "partition" and netchaos_tier is None:
            raise ValueError("partition chaos needs the serve.fleet.netchaos proxy tier")
        if mode in ("kill", "degrade") and fleet is None:
            raise ValueError(f"{mode} chaos needs a local supervisor (not --attach)")
        self._fleet = fleet
        self._tier = netchaos_tier
        self._partition_fault = partition_fault
        self._rng = random.Random(seed)
        self._kill_after_s = kill_after_s
        self._kill_period_s = kill_period_s
        self._sig = sig
        self._mode = mode
        self._degrade_stop_s = degrade_stop_ms / 1e3
        self._degrade_period_s = degrade_period_ms / 1e3
        self._degrade_duration_s = degrade_duration_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "FleetChaos":
        self._thread = threading.Thread(target=self._loop, name="fleet-chaos", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:  # YAMT011: silent chaos death = a drill that never ran
            if self._stop.wait(self._kill_after_s):
                return
            if self._mode == "degrade":
                self._degrade_once()
                return
            if self._mode == "partition":
                self._partition_once()
                return
            self._fleet.kill_replica(rng=self._rng, sig=self._sig)
            while self._kill_period_s > 0 and not self._stop.wait(self._kill_period_s):
                self._fleet.kill_replica(rng=self._rng, sig=self._sig)
        except Exception as e:  # noqa: BLE001 — contain, count, report
            obs_registry.get_registry().counter("serve.thread_crashes").inc()
            emit(f"[fleet] chaos thread crashed: {type(e).__name__}: {e}")

    def _degrade_once(self) -> None:
        slot = self._fleet.pick_live_slot(rng=self._rng)
        if slot is None:
            return
        obs_registry.get_registry().counter("fleet.chaos_degrades").inc()
        emit(f"[fleet] CHAOS: degrading replica r{slot} "
             f"(SIGSTOP {self._degrade_stop_s * 1e3:.0f}ms / "
             f"{self._degrade_period_s * 1e3:.0f}ms for {self._degrade_duration_s:.0f}s)")
        deadline = time.monotonic() + self._degrade_duration_s
        try:
            while time.monotonic() < deadline and not self._stop.is_set():
                if not self._fleet.signal_replica(slot, signal.SIGSTOP):
                    return  # the victim died (supervisor will respawn): drill over
                # a bounded freeze, then resume — stop() mid-pulse still
                # falls through to the finally's releasing SIGCONT
                self._stop.wait(self._degrade_stop_s)
                self._fleet.signal_replica(slot, signal.SIGCONT)
                self._stop.wait(self._degrade_period_s - self._degrade_stop_s)
        finally:
            self._fleet.signal_replica(slot, signal.SIGCONT)

    def _partition_once(self) -> None:
        proxy = self._tier.pick(rng=self._rng)
        if proxy is None:
            return
        obs_registry.get_registry().counter("fleet.chaos_partitions").inc()
        emit(f"[fleet] CHAOS: partitioning link to {proxy.upstream_host}:"
             f"{proxy.upstream_port} ({self._partition_fault} for "
             f"{self._degrade_duration_s:.0f}s)")
        proxy.set_fault(self._partition_fault)
        try:
            self._stop.wait(self._degrade_duration_s)
        finally:
            # the stop path always heals: a cancelled drill must not leave
            # a permanent partition behind
            proxy.set_fault(None)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def run(cfg: Config, replica_argv: list[str]) -> dict:
    """The fleet serving loop: supervisor + router + frontend + (optional)
    autoscaler + chaos, until SIGTERM/SIGINT. SIGHUP = rolling restart."""
    log = Logger(cfg.train.log_dir, enabled=True, tensorboard=False)
    reg = obs_registry.get_registry()
    if cfg.obs.histogram_buckets:
        reg.set_default_buckets(cfg.obs.histogram_buckets)
    reg.set_build_info(obs_device.build_info())  # no jax import: versions + git sha
    log.set_registry(reg)
    tracer = obs_trace.configure(enabled=bool(cfg.obs.trace), ring_size=cfg.obs.trace_ring_size,
                                 process_name="router")
    fc = cfg.serve.fleet
    fobs = fc.obs
    stop_event = threading.Event()
    rolling_event = threading.Event()

    def _on_signal(signum, frame):
        log.log(f"signal {signum}: stopping router, draining fleet")
        stop_event.set()

    def _on_hup(signum, frame):
        rolling_event.set()

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        signal.signal(signal.SIGHUP, _on_hup)
    except ValueError:
        pass  # embedded (test) runs drive stop_event directly

    hedger = Hedger(
        quantile=fc.hedge.quantile, min_samples=fc.hedge.min_samples,
        min_timer_ms=fc.hedge.min_timer_ms, max_timer_ms=fc.hedge.max_timer_ms,
    ) if fc.hedge.enable else None
    router = Router(
        default_class=cfg.serve.admission.default_class,
        poll_interval_s=fc.poll_interval_s,
        eject_failures=fc.eject_failures,
        route_attempts=fc.route_attempts,
        client_timeout_s=fc.client_timeout_s,
        connect_timeout_s=fc.connect_timeout_s or None,
        eject_cooldown_s=fc.eject_cooldown_s,
        lease_ttl_s=fc.lease_ttl_s,
        hedger=hedger,
        poll_jitter=fc.poll_jitter,
        slow_eject=fc.slow_eject.enable,
        slow_factor=fc.slow_eject.slow_factor,
        slow_eject_after=fc.slow_eject.eject_after,
        slow_cooldown_s=fc.slow_eject.cooldown_s,
        slow_min_ms=fc.slow_eject.min_ms,
        lat_alpha=fc.slow_eject.lat_alpha,
    ).start()
    # fleet observability (obs/fleet.py): the incident flight recorder is
    # the router's event sink, and the federation scrape-merges every live
    # replica's /varz into fleet-level families on the supervisor loop
    recorder = None
    if fobs.flight_recorder and cfg.train.log_dir:
        recorder = FlightRecorder(
            cfg.train.log_dir,
            ring=fobs.recorder_ring,
            min_interval_s=fobs.recorder_min_interval_s,
            incident_level=fobs.incident_brownout_level,
        )
        router.set_event_sink(recorder.record)
    federation = None
    if fobs.federate:
        federation = FleetFederation(
            router.backends,
            slo=SLOTracker(
                target_p99_ms=fobs.slo_target_p99_ms,
                error_budget=fobs.slo_error_budget,
                short_window_s=fobs.slo_short_window_s,
                long_window_s=fobs.slo_long_window_s,
                fast_burn=fobs.slo_fast_burn,
            ),
            recorder=recorder,
            signal_classes=(cfg.serve.brownout.signal_class,),
            scrape_timeout_s=fobs.scrape_timeout_s,
        )
    # netchaos proxy tier (serve/netchaos.py): the router only ever speaks
    # to supervised replicas THROUGH their per-link fault proxies, so the
    # partition chaos mode (and the serve_bench partition rounds) can
    # blackhole/reset/flap one link without touching any process
    tier = None
    if fc.netchaos.enable:
        nc = fc.netchaos
        tier = NetChaosTier(
            seed=nc.seed, fault_rate=nc.fault_rate, latency_ms=nc.latency_ms,
            jitter_ms=nc.jitter_ms, bandwidth_kbps=nc.bandwidth_kbps,
            flap_period_s=nc.flap_period_s, flap_down_s=nc.flap_down_s,
        )
    # model-sharded placement (serve.zoo.placement): each fleet slot spawns
    # with its OWN serve.zoo.models subset (serve/zoo.py slot_overrides),
    # and the router learns which models each address serves so its pick
    # only routes a model to replicas that load it
    per_slot_argv: dict[int, list[str]] = {}
    slot_names: dict[int, tuple[str, ...]] = {}
    if cfg.serve.zoo.models:
        from ..serve import zoo as zoo_mod
        paths = zoo_mod.parse_models(cfg.serve.zoo.models)
        groups = zoo_mod.parse_placement(cfg.serve.zoo.placement, list(paths))
        for i in range(fc.replicas):
            per_slot_argv[i] = zoo_mod.slot_overrides(cfg.serve.zoo, i)
            slot_names[i] = zoo_mod.slot_models(groups, i)
        log.log("zoo placement: " + "; ".join(
            f"r{i}:{'|'.join(slot_names[i])}" for i in sorted(slot_names)))

    def _apply_placement() -> None:
        if not slot_names or fleet is None:
            return
        assignments = {}
        for r in fleet.replicas():
            if r["addr"] is not None and r["slot"] in slot_names:
                key = f"{r['addr']['host']}:{r['addr']['port']}"
                # digest '' = placement-only knowledge; a replica that ALSO
                # lease-registers overwrites with its stamped digests
                assignments[key] = {n: "" for n in slot_names[r["slot"]]}
        router.set_backend_models(assignments)

    def route_backends(addrs) -> None:
        router.set_backends(tier.route(addrs) if tier is not None else addrs)
        _apply_placement()
    # --attach (serve.fleet.attach): the router tier over EXTERNALLY-managed
    # replicas — no local spawn, no supervisor. This IS the multi-host
    # deployment shape, rehearsed on loopback: replicas live wherever they
    # live (other hosts, other supervisors), the attach list seeds the
    # static backend set, and late arrivals join via the /register lease.
    attach = [a.strip() for a in fc.attach.split(",") if a.strip()]
    fleet = None
    if attach:
        route_backends([tuple(a.rsplit(":", 1)) for a in attach])
    else:
        fleet = FleetSupervisor(
            replica_argv=replica_argv,
            log_dir=cfg.train.log_dir,
            replicas=fc.replicas,
            restart_backoff_ms=fc.restart_backoff_ms,
            restart_backoff_max_s=fc.restart_backoff_max_s,
            spawn_timeout_s=fc.spawn_timeout_s,
            drain_timeout_s=cfg.serve.drain_timeout_s + 10.0,
            per_slot_argv=per_slot_argv,
            on_change=route_backends,
            logger=log,
        )
    # confidence cascade (serve/cascade.py): the frontend consumes the
    # cascade TIER instead of the bare router — small model answers, low
    # top-1-margin answers re-submit to the big tier; membership/
    # registration/introspection delegate through to the router
    serving_tier = router
    if cfg.serve.zoo.cascade.enable:
        from ..serve.cascade import CascadeTier
        cc = cfg.serve.zoo.cascade
        serving_tier = CascadeTier(
            router, small=cc.small, big=cc.big, threshold=cc.threshold,
            respect_explicit_model=cc.respect_explicit_model,
        )
        log.log(f"cascade armed: {cc.small} -> {cc.big} "
                f"(escalate below margin {cc.threshold:.2f})")
    result: dict = {}
    frontend = autoscaler = chaos = brownout = watchdog = None
    try:
        if fleet is not None:
            fleet.start()
        frontend = Frontend(
            serving_tier,
            host=cfg.serve.listen.host,
            port=cfg.serve.listen.port,
            request_timeout_s=cfg.serve.listen.request_timeout_s,
            replica_id=cfg.serve.listen.replica_id or "router",
            federation=federation,
        ).start()
        n_replicas = fleet.n_replicas if fleet is not None else len(attach)
        addr = {"host": cfg.serve.listen.host, "port": frontend.port, "pid": os.getpid(),
                "replica_id": frontend.replica_id, "role": "router",
                "replicas": n_replicas, "attach": attach}
        if cfg.train.log_dir:
            write_listen_addr(cfg.train.log_dir, addr)
        log.log(f"fleet of {n_replicas} {'attached' if attach else 'spawned'} "
                f"replicas behind {frontend.url} (hedge={'on' if hedger else 'off'}, "
                f"lease ttl {fc.lease_ttl_s:.0f}s)")
        if fc.autoscale.enable and fleet is None:
            log.log("autoscaler disabled: --attach mode has no supervisor to scale")
        if fc.autoscale.enable and fleet is not None:
            a = fc.autoscale
            autoscaler = Autoscaler(
                fleet, router,
                min_replicas=a.min_replicas, max_replicas=a.max_replicas,
                interval_s=a.interval_s, cooldown_s=a.cooldown_s,
                up_p99_ms=a.up_p99_ms, down_p99_ms=a.down_p99_ms,
                up_queue_depth=a.up_queue_depth, down_queue_depth=a.down_queue_depth,
                signal_class=a.signal_class,
            ).start()
        if cfg.serve.brownout.enable:
            # brownout at the ROUTER tier: signals from the fleet-side
            # latency family + routable backlog; actuates hedging (L1) and
            # fleet-door class shedding (L3+). Replica-tier batcher/
            # admission degradation rides each replica's own controller
            # (cli/serve.py) off the same config block.
            brownout = BrownoutController.from_config(
                cfg.serve.brownout,
                SignalReader(
                    latency_family=ROUTER_LATENCY,
                    signal_class=cfg.serve.brownout.signal_class,
                    queue_depth_fn=router.mean_queue_depth,
                ),
                # the flight recorder is a brownout TARGET too: level
                # transitions land in the event ring, and climbing to
                # incident_brownout_level arms an incident dump
                targets=(router,) + ((recorder,) if recorder is not None else ()),
            ).start()
            log.log(f"brownout ladder armed at the router tier "
                    f"(L0..L{cfg.serve.brownout.max_level})")
        if fc.chaos.enable:
            chaos = FleetChaos(
                fleet, seed=fc.chaos.seed, kill_after_s=fc.chaos.kill_after_s,
                kill_period_s=fc.chaos.kill_period_s,
                sig=signal.SIGKILL if fc.chaos.signal == "kill" else signal.SIGTERM,
                mode=fc.chaos.mode,
                degrade_stop_ms=fc.chaos.degrade_stop_ms,
                degrade_period_ms=fc.chaos.degrade_period_ms,
                degrade_duration_s=fc.chaos.degrade_duration_s,
                netchaos_tier=tier,
                partition_fault=fc.netchaos.fault,
            ).start()
            log.log(f"CHAOS: replica {fc.chaos.mode} on (seed={fc.chaos.seed}, "
                    f"after={fc.chaos.kill_after_s}s, period={fc.chaos.kill_period_s}s)")
        # fleet-tier stall watchdog: the supervisor loop heartbeats every
        # tick, so a wedged ROUTER process dumps a hang report that names
        # the fleet's state — replica table (weights/ejection), lease ages,
        # brownout level, and the oldest in-flight router request
        if cfg.obs.watchdog_deadline_s > 0 and cfg.train.log_dir:
            watchdog = StallWatchdog(
                cfg.train.log_dir,
                cfg.obs.watchdog_deadline_s,
                tracer=tracer,
                registry=reg,
                poll_s=cfg.obs.watchdog_poll_s,
                logger=log,
            )
            watchdog.register_info("fleet", lambda: {
                "replicas": router.replicas_state(),
                "lease_ages_s": router.lease_ages(),
                "brownout_level": int(reg.gauge("serve.brownout_level").value),
                "oldest_request": router.oldest_inflight(),
            })
            if federation is not None:
                watchdog.register_info("federation", federation.snapshot)
            watchdog.start()
        # federation cadence: its own interval, or ride the router's poll
        scrape_every = fobs.scrape_interval_s or fc.poll_interval_s
        next_scrape = time.monotonic()
        while not stop_event.wait(0.2):
            if watchdog is not None:
                watchdog.arm(phase="serve")
            now = time.monotonic()
            if federation is not None and now >= next_scrape:
                next_scrape = now + scrape_every
                federation.scrape_once()
            if recorder is not None:
                incident = recorder.maybe_dump(federation)
                if incident:
                    log.log(f"INCIDENT dumped: {incident}")
            if rolling_event.is_set():
                rolling_event.clear()
                if fleet is None:
                    log.log("SIGHUP ignored: --attach replicas are externally managed")
                    continue
                log.log("SIGHUP: rolling restart")
                n = fleet.rolling_restart()
                log.log(f"rolling restart complete: {n} replicas recycled")
        result.update({"listened": True, **addr})
    finally:
        t0 = time.perf_counter()
        if recorder is not None:
            # an armed trigger must not be lost to shutdown: one last dump
            # attempt with the latest federated view, then tear down
            recorder.maybe_dump(federation)
        if watchdog is not None:
            watchdog.stop()
        if chaos is not None:
            chaos.stop()
        if brownout is not None:
            brownout.stop()
            result["brownout_trace"] = brownout.trace
        if autoscaler is not None:
            autoscaler.stop()
            result["autoscale_trace"] = autoscaler.trace
        if frontend is not None:
            frontend.stop()
        router.stop()
        if tier is not None:
            tier.stop()
        if fleet is not None:
            fleet.stop()
        result["drain_s"] = round(time.perf_counter() - t0, 3)
        log.log(f"fleet drained in {result['drain_s']:.2f}s")
        if cfg.train.log_dir:
            if tracer.enabled:
                tracer.write(os.path.join(cfg.train.log_dir, "obs_trace.json"))
            os.makedirs(cfg.train.log_dir, exist_ok=True)
            with open(os.path.join(cfg.train.log_dir, "obs_registry.json"), "w") as f:
                json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
        log.close()
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # replicas re-parse the SAME operator argv (app: + overrides) plus their
    # per-slot overrides, so fleet config and replica config cannot drift;
    # --listen sugar is meaningless here (the fleet always listens).
    # `--attach host:port,...` is sugar for serve.fleet.attach=... — the
    # router tier over externally-started replicas, no local spawn.
    argv = [a for a in argv if a != "--listen"]
    cleaned: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--attach":
            if i + 1 >= len(argv):
                raise ValueError("--attach needs a host:port[,host:port...] value")
            cleaned.append(f"serve.fleet.attach={argv[i + 1]}")
            i += 2
            continue
        if a.startswith("--attach="):
            cleaned.append(f"serve.fleet.attach={a.split('=', 1)[1]}")
            i += 1
            continue
        cleaned.append(a)
        i += 1
    # --device (cuda unless the operator asks for the CPU) goes to every replica
    cleaned, device = parse_device(cleaned)
    cfg = parse_cli(cleaned)
    if not cfg.serve.fleet.attach and not (
            cfg.serve.bundle or cfg.serve.export_from or cfg.serve.zoo.models):
        # attach mode spawns nothing: the remote replicas own their bundles
        raise ValueError("fleet: needs serve.bundle or serve.zoo.models (replicas "
                         "load them at spawn) or --attach host:port,...")
    return run(cfg, cleaned + ["--device", device])


if __name__ == "__main__":
    main()

# Copy of yet_another_mobilenet_series_tpu/serve/netchaos.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Socket-level network chaos: a TCP fault-injection proxy between router
and replica.

Every fault the fleet has survived so far lives INSIDE a process boundary:
serve/faults.py injects at the engine edge, cli/fleet.py kills or SIGSTOPs
whole replicas. Crossing hosts (ROADMAP item 1's remaining rung) adds the
failure class neither can produce — the NETWORK itself misbehaving — and
the tail-at-scale literature says partitions, not crashes, dominate
multi-host fleets. A blackholed replica is worse than a dead one: a dead
socket refuses instantly (connect error, retried in microseconds), a
blackholed one accepts and then says nothing, pinning every leg for the
full read timeout.

:class:`NetChaosProxy` is a stdlib-socket TCP proxy interposed between the
router and one replica frontend, so every partition shape is reproducible
on one box without root or iptables:

- ``blackhole`` — accept the TCP connection, never forward a byte in either
  direction (SYN-eats-everything): connects "succeed", then everything
  hangs. Live keep-alive pipes stall too — a partition does not spare
  established connections.
- ``reset`` — connections are torn down with an RST (SO_LINGER 0): the
  abrupt peer-death signal, distinct from a clean FIN.
- ``half_open`` — the classic half-open socket: connect succeeds, request
  bytes are consumed, reads hang forever (the peer died without FIN and
  something still ACKs — NAT boxes and dead VMs do this).
- ``drop_response`` — asymmetric loss: the request IS forwarded (the
  replica does the work), the response is dropped. The client cannot tell
  this from half_open; the replica-side books can — which is exactly why
  retries must be idempotence-aware.
- **latency / jitter** — each response chunk is delayed ``latency_ms`` plus
  a seeded uniform draw in ``[0, jitter_ms]`` (WAN RTT, not loopback).
- **throttle** — response bandwidth capped at ``bandwidth_kbps`` (kilobits
  per second), the congested-link stand-in.
- **flap** — a timed link schedule: down (blackhole) for ``flap_down_s``
  out of every ``flap_period_s``, measured from proxy start on the
  monotonic clock. The drill for ejection/readmission ping-pong.

Determinism: the per-connection fault plan is a pure function of
``(seed, connection index, settings)`` — :meth:`NetChaosProxy.plan_for` is
reproducible without running any traffic, and two proxies built with the
same seed and settings produce identical plans (pinned in
tests/test_netchaos.py). ``fault_rate`` < 1 applies the configured shape to
a seeded subset of connections (flaky-path chaos); the default 1.0 models a
link-level fault that spares nothing.

:meth:`set_fault` reconfigures the LIVE proxy (the bench's mid-round
partition onset): held blackhole/half-open connections are released —
closed, the way a healed route drops the stale conntrack state — and new
connections see the new shape immediately.

:class:`NetChaosTier` manages one proxy per replica address and is what
cli/fleet.py wires between the supervisor's membership notifications and
``Router.set_backends`` (``serve.fleet.netchaos``); ``FleetChaos``
``mode="partition"`` drives a seeded victim proxy through a timed fault
episode the same way ``mode="degrade"`` drives SIGSTOP pulses.

Everything here is stdlib sockets + threads: no jax import (supervisors
stay device-free), every socket carries an explicit timeout (the YAMT018
discipline this PR adds — the proxy that TESTS hangs must never hang
itself), every thread target is guarded (YAMT011), and all durations ride
the monotonic clock (YAMT017).
"""

from __future__ import annotations

import random
import select
import socket
import struct
import threading
import time

from ..obs.registry import get_registry

FAULT_SHAPES = ("blackhole", "reset", "half_open", "drop_response")

# pump granularity: how long a select() wait lasts before re-checking link
# state / stop, and how long a stalled (blackholed) pump sleeps per tick
_TICK_S = 0.05
# per-socket timeout: bounds a pathological recv/sendall (a wedged peer)
# without polluting the select-paced poll loop — readiness comes from
# select, so a post-select recv returns promptly
_SOCK_TIMEOUT_S = 30.0
_CHUNK = 16384


class FaultPlan:
    """One connection's materialized fault plan: the shape it experiences
    (None = clean pass-through), plus the shaping parameters and the
    per-connection jitter stream seed. A pure function of (proxy seed,
    connection index, settings) — see :meth:`NetChaosProxy.plan_for`."""

    __slots__ = ("idx", "shape", "applies", "latency_s", "jitter_s",
                 "bytes_per_s", "jitter_seed")

    def __init__(self, idx, shape, applies, latency_s, jitter_s, bytes_per_s, jitter_seed):
        self.idx = idx
        self.shape = shape if applies else None
        self.applies = applies
        self.latency_s = latency_s if applies else 0.0
        self.jitter_s = jitter_s if applies else 0.0
        self.bytes_per_s = bytes_per_s if applies else 0.0
        self.jitter_seed = jitter_seed

    def as_dict(self) -> dict:
        return {"idx": self.idx, "shape": self.shape, "applies": self.applies,
                "latency_s": self.latency_s, "jitter_s": self.jitter_s,
                "bytes_per_s": self.bytes_per_s, "jitter_seed": self.jitter_seed}


class NetChaosProxy:
    """Seeded TCP fault-injection proxy in front of one upstream address."""

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        seed: int = 0,
        fault: str | None = None,
        fault_rate: float = 1.0,
        latency_ms: float = 0.0,
        jitter_ms: float = 0.0,
        bandwidth_kbps: float = 0.0,
        flap_period_s: float = 0.0,
        flap_down_s: float = 0.0,
        connect_timeout_s: float = 2.0,
    ):
        if fault is not None and fault not in FAULT_SHAPES:
            raise ValueError(f"fault must be one of {FAULT_SHAPES} or None, got {fault!r}")
        if not 0.0 <= fault_rate <= 1.0:
            raise ValueError(f"fault_rate must be in [0, 1], got {fault_rate}")
        if flap_period_s > 0 and not 0.0 < flap_down_s < flap_period_s:
            raise ValueError("flap needs 0 < flap_down_s < flap_period_s")
        self.upstream_host = upstream_host
        self.upstream_port = int(upstream_port)
        self._host = host
        self._port = int(port)
        self._seed = int(seed)
        self._connect_timeout_s = connect_timeout_s
        self._lock = threading.Lock()
        # live-switchable settings; _gen bumps on every set_fault so held
        # (blackholed / half-open) connections release on reconfigure
        self._fault = fault
        self._fault_rate = fault_rate
        self._latency_s = latency_ms / 1e3
        self._jitter_s = jitter_ms / 1e3
        self._bytes_per_s = bandwidth_kbps * 125.0  # kilobits/s -> bytes/s
        self._flap_period_s = flap_period_s
        self._flap_down_s = flap_down_s
        self._gen = 0
        self._flap_was_down = False
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._t0 = 0.0  # monotonic flap-schedule origin, set at start()
        self._conn_idx = 0
        self._open_socks: set[socket.socket] = set()
        self._reg = get_registry()

    # -- lifecycle -----------------------------------------------------------

    @property
    def port(self) -> int:
        if self._listener is None:
            raise RuntimeError("proxy not started")
        return self._listener.getsockname()[1]

    @property
    def addr(self) -> tuple[str, int]:
        return (self._host, self.port)

    def start(self) -> "NetChaosProxy":
        if self._listener is not None:
            raise RuntimeError("proxy already started")
        self._stop.clear()
        with self._lock:  # set_fault/_link_down access _t0 under the same lock
            self._t0 = time.monotonic()
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(_TICK_S * 4)  # bounded accept waits: stop() never hangs
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        self._listener = s
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"netchaos-{self.upstream_port}", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None  # yamt-lint: disable=YAMT019 — teardown handshake: the accept loop maps the resulting OSError to "stop() is running" and exits
        with self._lock:
            socks, self._open_socks = set(self._open_socks), set()
        for c in socks:
            try:
                c.close()
            except OSError:
                pass

    # -- live reconfiguration (the mid-round partition onset) ----------------

    def set_fault(self, fault: str | None, **kw) -> None:
        """Switch the injected fault live. ``kw`` may override ``fault_rate``,
        ``latency_ms``, ``jitter_ms``, ``bandwidth_kbps``, ``flap_period_s``,
        ``flap_down_s``. Held blackhole/half-open connections are released
        (closed) — a healed route drops stale state; a new fault must not
        wait for old sockets to notice."""
        if fault is not None and fault not in FAULT_SHAPES:
            raise ValueError(f"fault must be one of {FAULT_SHAPES} or None, got {fault!r}")
        with self._lock:
            self._fault = fault
            if "fault_rate" in kw:
                self._fault_rate = float(kw["fault_rate"])
            if "latency_ms" in kw:
                self._latency_s = float(kw["latency_ms"]) / 1e3
            if "jitter_ms" in kw:
                self._jitter_s = float(kw["jitter_ms"]) / 1e3
            if "bandwidth_kbps" in kw:
                self._bytes_per_s = float(kw["bandwidth_kbps"]) * 125.0
            if "flap_period_s" in kw:
                self._flap_period_s = float(kw["flap_period_s"])
            if "flap_down_s" in kw:
                self._flap_down_s = float(kw["flap_down_s"])
            self._gen += 1
            self._t0 = time.monotonic()  # flap schedule restarts at the switch

    def clear(self) -> None:
        """Heal the link completely: fault shape, shaping, AND the flap
        schedule (a "healed" link that keeps flapping is not healed)."""
        self.set_fault(None, latency_ms=0.0, jitter_ms=0.0, bandwidth_kbps=0.0,
                       flap_period_s=0.0, flap_down_s=0.0)

    # -- the deterministic plan ----------------------------------------------

    def plan_for(self, idx: int) -> FaultPlan:
        """The fault plan connection ``idx`` experiences: a pure function of
        (seed, idx, current settings) — same seed + settings => same plan,
        with no shared RNG state, so concurrent accepts stay deterministic
        per index and tests can predict a schedule without traffic."""
        with self._lock:
            fault, rate = self._fault, self._fault_rate
            latency_s, jitter_s, bps = self._latency_s, self._jitter_s, self._bytes_per_s
        rng = random.Random((self._seed * 1_000_003) ^ (idx * 7919))
        applies = rng.random() < rate
        return FaultPlan(idx, fault, applies, latency_s, jitter_s, bps,
                         jitter_seed=rng.randrange(1 << 30))

    def _link_down(self) -> bool:
        """Flap schedule: down for flap_down_s out of every flap_period_s,
        phase measured from the monotonic start/reconfigure origin."""
        with self._lock:
            period, down = self._flap_period_s, self._flap_down_s
            if period <= 0:
                return False
            is_down = (time.monotonic() - self._t0) % period < down
            if is_down != self._flap_was_down:
                self._flap_was_down = is_down
                self._reg.counter("serve.netchaos.flap_transitions").inc()
            return is_down

    def _shape_now(self, plan: FaultPlan) -> str | None:
        """The effective fault for one connection RIGHT NOW: its plan shape
        while the settings generation holds, with the flap schedule
        overriding to blackhole during down windows."""
        if self._link_down():
            return "blackhole"
        return plan.shape

    # -- accept + pump threads ------------------------------------------------

    def _accept_loop(self) -> None:
        try:  # YAMT011: a dead accept loop is a silent total partition
            while not self._stop.is_set():
                try:
                    client, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # listener closed under us: stop() is running
                with self._lock:
                    idx = self._conn_idx
                    self._conn_idx += 1
                    gen = self._gen
                    self._open_socks.add(client)
                self._reg.counter("serve.netchaos.connections").inc()
                threading.Thread(
                    target=self._serve_conn_guarded, args=(idx, gen, client),
                    name=f"netchaos-conn-{idx}", daemon=True,
                ).start()
        except Exception:  # noqa: BLE001 — contain, count (YAMT011)
            self._reg.counter("serve.thread_crashes").inc()

    def _serve_conn_guarded(self, idx: int, gen: int, client: socket.socket) -> None:
        try:  # YAMT011
            self._serve_conn(idx, gen, client)
        except Exception:  # noqa: BLE001 — a torn pump fails one conn, not the proxy
            self._reg.counter("serve.thread_crashes").inc()
        finally:
            self._forget(client)
            try:
                client.close()
            except OSError:
                pass

    def _forget(self, sock: socket.socket) -> None:
        with self._lock:
            self._open_socks.discard(sock)

    def _gen_moved(self, gen: int) -> bool:
        with self._lock:
            return self._gen != gen

    @staticmethod
    def _rst_close(sock: socket.socket) -> None:
        """Close with an RST instead of a FIN: SO_LINGER (on, 0) makes the
        kernel abort the connection — the peer sees ECONNRESET."""
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _hold(self, idx: int, gen: int, client: socket.socket, shape: str) -> None:
        """Blackhole / half-open hold: the connection goes nowhere. Blackhole
        never reads (send buffers fill like a routed-to-nowhere link);
        half-open consumes request bytes and answers nothing. Released when
        the settings generation moves (fault cleared) or the proxy stops."""
        if shape == "blackhole":
            self._reg.counter("serve.netchaos.blackholed").inc()
        else:
            self._reg.counter("serve.netchaos.half_open").inc()
        client.settimeout(_SOCK_TIMEOUT_S)
        while not self._stop.is_set() and not self._gen_moved(gen):
            if shape == "half_open":
                try:
                    readable, _, _ = select.select([client], [], [], _TICK_S)
                    if not readable:
                        continue
                    data = client.recv(_CHUNK)
                    if not data:
                        return  # the client gave up: clean half-close
                except OSError:
                    return
            else:
                self._stop.wait(_TICK_S)
        # released: a healed link drops the stale state — the client's next
        # use of this socket fails fast and retries on a fresh connection

    def _serve_conn(self, idx: int, gen: int, client: socket.socket) -> None:
        plan = self.plan_for(idx)
        shape = self._shape_now(plan)
        if shape == "reset":
            self._reg.counter("serve.netchaos.resets").inc()
            self._rst_close(client)
            return
        if shape in ("blackhole", "half_open"):
            self._hold(idx, gen, client, shape)
            return
        try:
            upstream = socket.create_connection(
                (self.upstream_host, self.upstream_port), self._connect_timeout_s
            )
        except OSError:
            # upstream itself is down: surface as a closed connection (the
            # client's ordinary connect-error path), not a proxy crash
            try:
                client.close()
            except OSError:
                pass
            return
        with self._lock:
            self._open_socks.add(upstream)
        jitter_rng = random.Random(plan.jitter_seed)
        t_up = threading.Thread(
            target=self._pump_guarded, args=(plan, client, upstream, "c2u", None),
            name=f"netchaos-c2u-{idx}", daemon=True,
        )
        t_up.start()
        try:
            # response direction pumped on THIS thread (shaping applies here)
            self._pump(plan, upstream, client, "u2c", jitter_rng)
        finally:
            self._forget(upstream)
            try:
                upstream.close()
            except OSError:
                pass
            t_up.join(timeout=2.0)

    def _pump_guarded(self, plan, src, dst, direction, jitter_rng) -> None:
        try:  # YAMT011
            self._pump(plan, src, dst, direction, jitter_rng)
        except Exception:  # noqa: BLE001
            self._reg.counter("serve.thread_crashes").inc()

    def _pump(self, plan: FaultPlan, src: socket.socket,
              dst: socket.socket, direction: str, jitter_rng) -> None:
        """One direction of one connection, RE-DERIVING the plan from the
        live settings per chunk (plan_for is pure, so this is cheap and
        deterministic) — a mid-flight fault switch hits established
        keep-alive pipes too: a real partition does not spare open
        sockets."""
        src.settimeout(_SOCK_TIMEOUT_S)
        while not self._stop.is_set():
            plan = self.plan_for(plan.idx)
            shape = self._shape_now(plan)
            if shape == "reset":
                self._reg.counter("serve.netchaos.resets").inc()
                self._rst_close(dst)
                self._rst_close(src)
                return
            if shape == "blackhole" or (shape == "half_open" and direction == "u2c"):
                # the link eats everything: stop reading, stop forwarding
                self._stop.wait(_TICK_S)
                continue
            try:
                readable, _, _ = select.select([src], [], [], _TICK_S)
                if not readable:
                    continue
                data = src.recv(_CHUNK)
            except OSError:
                break
            if not data:
                if shape == "drop_response" and direction == "u2c":
                    # the upstream's FIN is response-direction traffic too:
                    # an asymmetric-loss link eats it, so the client keeps
                    # hanging instead of seeing a clean EOF
                    self._stop.wait(_TICK_S)
                    continue
                break
            # the fault may have switched while this thread was parked in
            # select: re-derive before any DELIVERY decision, and hold the
            # in-flight chunk through blackhole windows — a partition spares
            # no socket, and heal releases the stalled chunk, not drops it
            while not self._stop.is_set():
                plan = self.plan_for(plan.idx)
                shape = self._shape_now(plan)
                if shape == "blackhole" or (shape == "half_open" and direction == "u2c"):
                    self._stop.wait(_TICK_S)
                    continue
                break
            if self._stop.is_set():
                break
            if shape == "reset":
                self._reg.counter("serve.netchaos.resets").inc()
                self._rst_close(dst)
                self._rst_close(src)
                return
            if shape == "half_open" and direction == "c2u":
                continue  # consumed, never delivered
            if shape == "drop_response" and direction == "u2c":
                self._reg.counter("serve.netchaos.dropped_chunks").inc()
                continue  # the replica answered; the link lost it
            if direction == "u2c" and (plan.latency_s > 0 or plan.jitter_s > 0):
                self._reg.counter("serve.netchaos.delayed_chunks").inc()
                delay = plan.latency_s + (jitter_rng.uniform(0, plan.jitter_s)
                                          if plan.jitter_s > 0 else 0.0)
                self._stop.wait(delay)
            if direction == "u2c" and plan.bytes_per_s > 0:
                self._reg.counter("serve.netchaos.throttled_chunks").inc()
                self._stop.wait(len(data) / plan.bytes_per_s)
            try:
                dst.sendall(data)
            except OSError:
                break
        # half-close propagates: the peer's reader sees EOF, not a hang
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    @classmethod
    def from_config(cls, upstream_host: str, upstream_port: int, nc, **overrides):
        """Build from a config.NetChaosConfig block (serve.fleet.netchaos).
        The configured fault is NOT armed at construction — FleetChaos (or
        the bench) switches it on at its scheduled onset via set_fault."""
        kw = dict(
            seed=nc.seed,
            fault_rate=nc.fault_rate,
            latency_ms=nc.latency_ms,
            jitter_ms=nc.jitter_ms,
            bandwidth_kbps=nc.bandwidth_kbps,
            flap_period_s=nc.flap_period_s,
            flap_down_s=nc.flap_down_s,
        )
        kw.update(overrides)
        return cls(upstream_host, upstream_port, **kw)


class NetChaosTier:
    """One proxy per replica address, reconciled against the supervisor's
    membership notifications: cli/fleet.py wires ``on_change`` as
    ``router.set_backends(tier.route(addrs))`` so the router only ever
    speaks to replicas THROUGH their proxies — the bench's partition rounds
    and FleetChaos ``mode="partition"`` then pick a victim proxy and flip
    its fault live."""

    def __init__(self, *, seed: int = 0, proxy_factory=None, **proxy_kw):
        self._seed = seed
        self._proxy_kw = proxy_kw
        self._factory = proxy_factory or (
            lambda host, port, seed: NetChaosProxy(host, port, seed=seed, **proxy_kw).start()
        )
        self._lock = threading.Lock()
        self._proxies: dict[tuple[str, int], NetChaosProxy] = {}

    def route(self, addrs) -> list[tuple[str, int]]:
        """Map upstream addresses to proxy addresses (same order), creating
        proxies for new upstreams and stopping proxies whose upstream left
        the membership — the set_backends reconcile, one tier up."""
        want = [(h, int(p)) for h, p in addrs]
        out: list[tuple[str, int]] = []
        with self._lock:
            for key in [k for k in self._proxies if k not in want]:
                self._proxies.pop(key).stop()
            for i, key in enumerate(want):
                if key not in self._proxies:
                    # per-upstream seed offset: each link draws its own
                    # deterministic plan stream
                    self._proxies[key] = self._factory(key[0], key[1], self._seed + i)
                out.append(self._proxies[key].addr)
        return out

    def proxies(self) -> list[NetChaosProxy]:
        with self._lock:
            return list(self._proxies.values())

    def pick(self, rng: random.Random | None = None) -> NetChaosProxy | None:
        """One seeded-random proxy (the partition-chaos victim)."""
        ps = self.proxies()
        return (rng or random).choice(ps) if ps else None

    def stop(self) -> None:
        with self._lock:
            proxies, self._proxies = list(self._proxies.values()), {}
        for p in proxies:
            p.stop()

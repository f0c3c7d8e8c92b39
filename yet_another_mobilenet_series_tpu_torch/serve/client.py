# Copy of yet_another_mobilenet_series_tpu/serve/client.py: the port keeps its own copy so that it never imports the
# JAX package (this module is free of JAX). Keep the two in step by hand.
"""Connection-reused HTTP client for one serving replica — the client half
of the front door, extracted so every caller that speaks to a frontend
(the fleet router, the hedger's duplicate leg, benches, tests) shares ONE
implementation of the wire protocol instead of three divergent
urllib-request copies.

Design points, matching the frontend's contract (serve/frontend.py):

- **connection reuse**: the frontend speaks HTTP/1.1 with Content-Length on
  every response, so keep-alive works; the client holds one persistent
  ``http.client.HTTPConnection`` PER THREAD (the router's worker pool and
  the poll thread each get their own socket — ``http.client`` connections
  are not thread-safe). A stale keep-alive socket (server closed it between
  requests) is retried ONCE on a fresh connection; a failure on the fresh
  socket is a real :class:`ClientConnectError`. The connection table prunes
  a thread's replaced socket and entries left by exited threads (hedge
  Timer threads are transient), so a long-lived router against a flapping
  replica holds a bounded socket set.
- **split timeouts**: ``connect_timeout_s`` bounds the TCP handshake
  SEPARATELY from ``timeout_s`` (the read bound). Across real hosts the
  failure modes differ: a crashed replica refuses instantly, but a
  PARTITIONED one drops SYNs on the floor — with one shared timeout every
  routing probe into a blackhole burns the full read budget. A connect
  that cannot complete inside ``connect_timeout_s`` raises
  :class:`ClientConnectError` (the request never left this host — retry
  another replica immediately; counted ``serve.client.connect_timeouts``),
  while a read-timeout is :class:`ClientTimeout` (the request may be
  running server-side — half-open sockets and response-eating links
  surface HERE, bounded, instead of wedging a worker).
- **typed errors**: every non-2xx response raises :class:`ClientHTTPError`
  carrying the HTTP status and the frontend's wire error tag
  (``queue_full``, ``breaker_open``, ...), so the router can pass a
  replica's typed rejection through to ITS client unchanged — a fleet is
  externally indistinguishable from one replica. Transport-level failures
  are :class:`ClientConnectError` (dead/refused/reset/unreachable socket —
  the retry-on-another-replica signal) or :class:`ClientTimeout` (the read
  timeout expired with the request possibly still running server-side).
- **identity threading**: ``predict(..., request_id=...)`` sends
  ``X-Request-Id``, so a router-minted id correlates the replica-side spans
  with the router's own ``fleet/route`` span.
- **membership**: :meth:`register` / :meth:`deregister` speak the router's
  TTL-lease admin endpoints (``POST /register``), the transport half of
  the multi-host membership story — a replica heartbeats its own address
  into the fleet and expires out when it stops.

Images ride as raw bytes + ``X-Shape`` and ``X-Dtype`` headers: ``f4``
(little-endian float32, the historical contract and the default) or ``u8``
(raw uint8 pixels — the quantized wire, 4x fewer bytes per request, which
this header lets ride router->replica across the fleet).
"""

from __future__ import annotations

import http.client
import json
import socket
import threading

import numpy as np

from ..obs.registry import get_registry

DEFAULT_TIMEOUT_S = 60.0

# wire dtype codes (X-Dtype header) <-> numpy dtypes; "f4" is the default
# when the header is absent (pre-header clients keep working)
WIRE_DTYPES = {"f4": np.dtype("<f4"), "u8": np.dtype("u1")}


def wire_dtype_code(dtype) -> str:
    """The X-Dtype code for an array dtype: uint8 rides as ``u8``, anything
    else is coerced to the ``f4`` contract by the sender."""
    return "u8" if np.dtype(dtype) == np.dtype("u1") else "f4"


class ClientError(RuntimeError):
    """Base class for every typed client failure."""


class ClientConnectError(ClientError):
    """The replica's socket is dead: connection refused, reset, or closed
    mid-request. The caller may safely retry ANOTHER replica — inference is
    pure and the request either never arrived or its answer is orphaned."""


class ClientTimeout(ClientError):
    """The socket timeout expired. Unlike a connect error the request may
    still be running server-side; retries must be idempotence-aware (they
    are: inference is pure)."""


class ClientHTTPError(ClientError):
    """A non-2xx response with the frontend's typed error body. ``status``
    and ``tag`` mirror the wire (``429``/``queue_full``, ``503``/
    ``breaker_open``, ...), so routers re-raise replica verdicts verbatim.
    ``retry_after`` carries the response's ``Retry-After`` seconds when the
    server sent one — the backpressure signal the router uses to tell an
    overloaded-but-healthy replica (do NOT eject) from a dead one."""

    def __init__(self, status: int, tag: str, message: str,
                 retry_after: float | None = None):
        super().__init__(f"{status} {tag}: {message}")
        self.status = status
        self.tag = tag
        self.retry_after = retry_after


class _ConnectTimeout(OSError):
    """Internal marker: the TCP handshake itself timed out (a blackholed
    address). Distinct from a read timeout — the request never left this
    host, so the caller may retry another replica with zero idempotence
    concern. Mapped to :class:`ClientConnectError` by ``_request``."""


class _SplitTimeoutConnection(http.client.HTTPConnection):
    """HTTPConnection whose CONNECT phase is bounded separately from reads:
    ``socket.create_connection`` runs under ``connect_timeout``, then the
    established socket switches to the (longer) read timeout. With the
    stdlib's single ``timeout`` a probe into a SYN-blackhole burns the full
    read budget before failing."""

    def __init__(self, host, port, *, timeout, connect_timeout):
        super().__init__(host, port, timeout=timeout)
        self.connect_timeout = connect_timeout

    def connect(self):
        try:
            self.sock = socket.create_connection(
                (self.host, self.port), self.connect_timeout
            )
        except TimeoutError as e:  # socket.timeout: the handshake hung
            raise _ConnectTimeout(
                f"connect to {self.host}:{self.port} exceeded {self.connect_timeout:.1f}s"
            ) from e
        self.sock.settimeout(self.timeout)  # reads run on the full budget
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        if self._tunnel_host:
            self._tunnel()


def _parse_retry_after(headers: dict) -> float | None:
    """Seconds from a ``Retry-After`` header; None when absent or not the
    delta-seconds form (the HTTP-date form is never emitted by our
    frontend, so it is not worth a date parser here)."""
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class ReplicaClient:
    """Typed, keep-alive HTTP client for one frontend address."""

    def __init__(self, host: str, port: int, *, timeout_s: float = DEFAULT_TIMEOUT_S,
                 connect_timeout_s: float | None = None):
        self.host = host
        self.port = int(port)
        self.timeout_s = timeout_s
        # None = the pre-split behavior (connect shares the read budget);
        # routers pass a tight bound so blackholes fail in ~a poll interval
        self.connect_timeout_s = timeout_s if connect_timeout_s is None else connect_timeout_s
        self._local = threading.local()
        # one live connection per thread ident, for close(); threads come
        # and go (Timer threads in the hedger), so the local alone cannot
        # enumerate — and a plain ever-grown list would leak one socket per
        # reconnect against a flapping replica
        self._conns: dict[int, http.client.HTTPConnection] = {}
        self._conns_lock = threading.Lock()

    @classmethod
    def from_addr(cls, addr: dict, **kw) -> "ReplicaClient":
        """Build from a ``listen_addr.json`` dict (``{"host", "port"}``)."""
        return cls(addr["host"], addr["port"], **kw)

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- transport ----------------------------------------------------------

    def _fresh_conn(self, timeout_s: float) -> http.client.HTTPConnection:
        conn = _SplitTimeoutConnection(
            self.host, self.port, timeout=timeout_s,
            connect_timeout=min(self.connect_timeout_s, timeout_s),
        )
        ident = threading.get_ident()
        with self._conns_lock:
            # prune on replacement (this thread's old socket) and entries
            # left behind by exited threads: the table stays bounded by the
            # LIVE thread count however often the replica flaps
            old = self._conns.pop(ident, None)
            live = {t.ident for t in threading.enumerate()}
            dead = [k for k in self._conns if k not in live]
            stale = [self._conns.pop(k) for k in dead]
            self._conns[ident] = conn
        if old is not None:
            old.close()
        for c in stale:
            c.close()
        return conn

    def _request(self, method: str, path: str, body: bytes | None = None,
                 headers: dict | None = None, timeout_s: float | None = None):
        """(status, response headers, body bytes); one stale-socket retry."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        last_exc: Exception | None = None
        for attempt in (0, 1):
            conn = getattr(self._local, "conn", None)
            if conn is None or attempt == 1:
                if conn is not None:
                    conn.close()
                conn = self._fresh_conn(timeout_s)
                self._local.conn = conn
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
                return resp.status, dict(resp.headers), data
            except _ConnectTimeout as e:
                # the handshake itself hung: a blackholed/partitioned
                # address. Conclusive — the handshake ran on a fresh socket,
                # so the stale-keep-alive retry proves nothing; fail fast so
                # the router re-routes within the CONNECT budget, not the
                # read budget
                get_registry().counter("serve.client.connect_timeouts").inc()
                conn.close()
                self._local.conn = None
                raise ClientConnectError(
                    f"{method} {self.base_url}{path}: {e}"
                ) from e
            except socket.timeout as e:
                conn.close()
                self._local.conn = None
                raise ClientTimeout(
                    f"{method} {self.base_url}{path} exceeded {timeout_s:.1f}s"
                ) from e
            except (ConnectionError, BrokenPipeError, http.client.HTTPException, OSError) as e:
                # a reused socket the server already closed fails here; only
                # the retry on a FRESH socket proves the replica is dead
                conn.close()
                self._local.conn = None
                last_exc = e
        raise ClientConnectError(
            f"{method} {self.base_url}{path}: {type(last_exc).__name__}: {last_exc}"
        ) from last_exc

    def _request_json(self, method: str, path: str, **kw):
        status, headers, data = self._request(method, path, **kw)
        try:
            doc = json.loads(data) if data else {}
        except json.JSONDecodeError:
            doc = {"error": "bad_body", "message": data[:200].decode("utf-8", "replace")}
        return status, headers, doc

    # -- the serving protocol ------------------------------------------------

    def predict(self, image: np.ndarray, *, priority: str | None = None,
                deadline_ms: float | None = None, request_id: str | None = None,
                trace_parent: str | None = None,
                timeout_s: float | None = None,
                model: str | None = None) -> np.ndarray:
        """POST one (H, W, C) image; returns the logits row. Raises the
        typed hierarchy above on every failure mode. A uint8 array rides
        the wire RAW (``X-Dtype: u8`` — the quantized wire's 4x byte drop
        crosses the fleet instead of being silently upcast); anything else
        is coerced to the little-endian float32 contract. ``model`` names
        the zoo tenant (``X-Model`` header); None = the replica's default
        model. An unserved name comes back as a typed 400
        (``unknown_model`` — :class:`ClientHTTPError` with that tag, the
        served-model list riding in the error body)."""
        image = np.asarray(image)
        code = wire_dtype_code(image.dtype)
        image = np.ascontiguousarray(image, dtype=WIRE_DTYPES[code])
        headers = {
            "Content-Type": "application/octet-stream",
            "X-Shape": ",".join(str(d) for d in image.shape),
            "X-Dtype": code,
        }
        if priority:
            headers["X-Priority"] = priority
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(deadline_ms)
        if request_id:
            headers["X-Request-Id"] = str(request_id)
        if trace_parent:
            # fleet trace propagation (serve/context.py parse_trace_parent):
            # "<trace_id>-<seq>-<leg>", stamped per leg by the router so the
            # replica's trace events carry the fleet-level request id
            headers["X-Trace-Parent"] = str(trace_parent)
        if model:
            headers["X-Model"] = str(model)
        status, resp_headers, doc = self._request_json(
            "POST", "/predict", body=image.tobytes(), headers=headers, timeout_s=timeout_s
        )
        if status != 200:
            raise ClientHTTPError(status, doc.get("error", "unknown"), doc.get("message", ""),
                                  retry_after=_parse_retry_after(resp_headers))
        return np.asarray(doc["logits"], np.float32)

    def register(self, host: str, port: int, *, ttl_s: float,
                 replica_id: str = "", timeout_s: float | None = None,
                 models: dict | None = None) -> dict:
        """POST /register: announce (or heartbeat-renew) a replica address
        with a TTL lease on a router frontend. ``models`` is the served-
        model advertisement (``{name: digest}``) driving the router's
        model-aware placement. Returns the router's lease verdict
        (``{"ok", "ttl_s", ...}``); raises :class:`ClientHTTPError` when
        the target is not a router (404), rejects the body (400), or
        refuses a conflicting model digest (409, ``digest_conflict``)."""
        payload = {"host": host, "port": int(port), "ttl_s": ttl_s,
                   "replica_id": replica_id}
        if models is not None:
            payload["models"] = dict(models)
        body = json.dumps(payload).encode()
        status, _, doc = self._request_json(
            "POST", "/register", body=body,
            headers={"Content-Type": "application/json"}, timeout_s=timeout_s,
        )
        if status != 200:
            raise ClientHTTPError(status, doc.get("error", "unknown"), doc.get("message", ""))
        return doc

    def deregister(self, host: str, port: int, *, timeout_s: float | None = None) -> dict:
        """POST /deregister: drop a leased membership before its TTL runs
        out (the clean-drain half of the lease lifecycle)."""
        body = json.dumps({"host": host, "port": int(port)}).encode()
        status, _, doc = self._request_json(
            "POST", "/deregister", body=body,
            headers={"Content-Type": "application/json"}, timeout_s=timeout_s,
        )
        if status != 200:
            raise ClientHTTPError(status, doc.get("error", "unknown"), doc.get("message", ""))
        return doc

    def healthz(self, timeout_s: float | None = None) -> tuple[int, dict]:
        """(status, body) — 503 is a VALUE here (breaker open / draining),
        not an exception; only transport failures raise."""
        status, _, doc = self._request_json("GET", "/healthz", timeout_s=timeout_s)
        return status, doc

    def varz(self, timeout_s: float | None = None) -> tuple[int, dict]:
        status, _, doc = self._request_json("GET", "/varz", timeout_s=timeout_s)
        return status, doc

    def metrics_text(self, timeout_s: float | None = None) -> str:
        status, _, data = self._request("GET", "/metrics", timeout_s=timeout_s)
        if status != 200:
            raise ClientHTTPError(status, "metrics", data[:200].decode("utf-8", "replace"))
        return data.decode()

    def close(self) -> None:
        with self._conns_lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()

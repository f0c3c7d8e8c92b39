# Copy of yet_another_mobilenet_series_tpu/serve/frontend.py: the port keeps its own copy so that it never imports the
# JAX package. Repaired here: ROADMAP F4 (an unknown X-Model's tag) and F5 (a keep-alive request after stop()).
"""Loopback HTTP front door: the network edge in front of the batcher.

Pure stdlib (``http.server``), one import away from nothing — the container
bakes no RPC framework, and the point of this layer is failure BEHAVIOR,
not protocol sophistication: every request resolves to a result, a typed
rejection, or a timeout, with the resilience semantics (admission control,
retry, breaker — serve/admission.py) mapped onto HTTP status codes a load
balancer already understands.

Endpoints:

``POST /predict``
    One image per request. Body is either JSON ``{"image": [[[...]]]}``
    (H, W, 3 nested lists) or raw bytes
    (``Content-Type: application/octet-stream``) with an ``X-Shape: H,W,C``
    header and an optional ``X-Dtype`` header — ``f4`` (little-endian
    float32, the default: pre-header clients keep working) or ``u8`` (raw
    uint8 pixels, the quantized wire: 4x fewer bytes per request, riding
    router->replica across the fleet when ``serve.quant.wire="uint8"``). Per-request QoS rides in headers — ``X-Priority:
    interactive|batch|best_effort`` and ``X-Deadline-Ms: <float>`` — and is
    propagated into the admission controller and batcher verbatim.
    Responses: ``200`` ``{"logits": [...], "priority": cls}``;
    ``400`` malformed body/headers; ``429`` rejected at arrival (class
    quota, queue full, or deadline-unmeetable — body carries which);
    ``503`` breaker open (with ``Retry-After``) or shutdown drain;
    ``504`` deadline exceeded / server-side timeout; ``500`` engine error
    after retries. Every error body is ``{"error": <type>, "message": ...}``.

``GET /healthz``
    The admission controller's state snapshot — breaker state (+ the
    ``serve.breaker_state`` gauge value), per-class queue occupancy vs
    quota, EWMA/predicted wait, in-flight window occupancy. Status ``200``
    while the breaker is closed or half-open, ``503`` while open — a load
    balancer can drain a sick replica from rotation without parsing JSON.

``POST /register`` / ``POST /deregister``
    TTL-leased membership, served only when the admission object speaks it
    (the fleet Router does; a plain replica answers 404). A replica POSTs
    ``{"host", "port", "ttl_s", "replica_id"}`` to join the fleet and
    heartbeats the same body to renew; a lease that expires unrenewed
    removes the backend (serve/router.py). This is the multi-host
    registration path: remote replicas join a router that never spawned
    them.

``POST /profile/start`` / ``POST /profile/stop``
    HTTP-triggered ``jax.profiler`` capture of LIVE serving traffic
    (obs/device.py :class:`~..obs.device.ProfilerCapture`): start opens an
    xplane trace window under the configured trace dir, stop closes it and
    returns the dir + captured seconds for scripts/trace_ops.py aggregation.
    Single-flight: a second start (or a stop with no capture open) is
    ``409``; a window still open at SIGTERM is closed by the drain path
    (cli/serve.py), never leaked. ``404`` when no profiler is configured.

The server is a ``ThreadingHTTPServer`` bound to loopback by default
(``cli/serve.py --listen``); its accept loop runs on a guarded daemon
thread (YAMT011). ``stop()`` shuts the accept loop down and returns — the
batcher drain (bounded by ``serve.drain_timeout_s``) is the caller's next
line, so SIGTERM = stop accepting, then drain in-flight work.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..utils.logging import emit
from .admission import (
    BreakerOpen,
    BrownoutShed,
    DeadlineUnmeetable,
    BREAKER_OPEN,
    UnknownModel,
)
from .batcher import DeadlineExceeded, DrainTimeout, QueueFull
from .client import WIRE_DTYPES, ClientHTTPError, ClientTimeout
from .context import RequestContext
from .router import ModelDigestConflict, NoHealthyReplicas, NoReplicaForModel

# this process's birth time: the replica-identity field a router compares to
# detect a RESTARTED replica behind an unchanged address (same host:port,
# new process) — pid alone can recycle. Wall clock BY DESIGN (an identity
# timestamp routers compare across hosts, never differenced into a duration
# — the YAMT017 hazard is subtraction, not the reading).
_PROC_START_UNIX = time.time()

# exception type -> (HTTP status, wire error tag, overload-shaped?); anything
# else is a 500. Subtype rows precede their base (isinstance scan):
# UnknownModel is a client-side naming error (400, never overload-shaped),
# NoReplicaForModel a placement gap distinct from a dead fleet. The final
# column marks "alive but saturated — come back": those verdicts carry a
# Retry-After header (RFC 9110), which is ALSO the router's backpressure
# discriminator (a Retry-After-bearing 503 never scores toward ejection).
# "draining" and "no_healthy_replicas" mean "stop sending here" — no hint.
_ERROR_MAP = [
    (BreakerOpen, 503, "breaker_open", True),
    (BrownoutShed, 503, "brownout", True),
    (DeadlineUnmeetable, 429, "deadline_unmeetable", True),
    (UnknownModel, 400, "unknown_model", False),
    (QueueFull, 429, "queue_full", True),  # covers ClassQueueFull / ModelQueueFull too
    (DeadlineExceeded, 504, "deadline_exceeded", False),
    (DrainTimeout, 503, "draining", False),
    (NoReplicaForModel, 503, "no_replica_for_model", False),
    (NoHealthyReplicas, 503, "no_healthy_replicas", False),
    (ClientTimeout, 504, "timeout", False),
]

# derived, not hand-kept: the one source of truth for overload-shaped tags
# is the _ERROR_MAP row itself
_RETRY_AFTER_TAGS = frozenset(
    tag for _typ, _status, tag, retry_after in _ERROR_MAP if retry_after
)


def _classify(exc: Exception) -> tuple[int, str]:
    # a replica's typed verdict crossing the router passes through verbatim
    # (fleet-behind-the-frontend is indistinguishable from one replica)
    if isinstance(exc, ClientHTTPError):
        return exc.status, exc.tag
    for typ, status, tag, _retry_after in _ERROR_MAP:
        if isinstance(exc, typ):
            return status, tag
    return 500, "engine_error"


def _retry_after_s(exc: Exception, status: int, tag: str, default_s: float) -> float | None:
    """The Retry-After seconds for one error response, or None for no
    header: an exception-carried hint wins (BrownoutShed's own bound, a
    replica's header passing through the router verbatim), then the
    frontend default for every overload-shaped 429/503 tag."""
    carried = getattr(exc, "retry_after_s", None)  # BrownoutShed
    if carried is None:
        carried = getattr(exc, "retry_after", None)  # ClientHTTPError pass-through
    if carried is not None:
        return float(carried)
    if status in (429, 503) and tag in _RETRY_AFTER_TAGS:
        return default_s
    return None


def write_listen_addr(log_dir: str, addr: dict) -> str:
    """Publish the bound address ATOMICALLY as ``<log_dir>/listen_addr.json``:
    write a temp file, then rename. A polling supervisor (cli/fleet.py) reads
    either nothing or whole JSON — never a partial document."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "listen_addr.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(addr, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX: readers see old-or-new, whole
    return path


class _Handler(BaseHTTPRequestHandler):
    """Request handler; the owning :class:`Frontend` is injected as a class
    attribute by :meth:`Frontend.start` (stdlib handler classes are
    instantiated per request by the server, so state rides on the class)."""

    frontend: "Frontend" = None  # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    # -- plumbing -----------------------------------------------------------

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        # per-request stderr lines would fork the logging path (YAMT007
        # discipline); request accounting lives in the obs registry instead
        get_registry().counter("serve.http_requests").inc()

    def _send_json(self, status: int, payload: dict, headers: dict | None = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, tag: str, message: str, headers: dict | None = None) -> None:
        get_registry().counter("serve.http_errors").inc()
        self._send_json(status, {"error": tag, "message": message}, headers)

    def _send_typed_error(self, exc: Exception, rid_hdr: dict) -> None:
        """Map one typed failure to its wire verdict, attaching Retry-After
        to every overload-shaped 429/503 (exception-carried hints — a
        brownout shed's own bound, a replica's header crossing the router —
        pass through verbatim)."""
        status, tag = _classify(exc)
        headers = dict(rid_hdr)
        retry_after = _retry_after_s(exc, status, tag, self.frontend.retry_after_s)
        if retry_after is not None:
            headers["Retry-After"] = f"{max(retry_after, 0.0):.0f}"
        body = {"error": tag, "message": str(exc)}
        # model-routing verdicts carry the served-model list structurally, so
        # a client can correct its X-Model without parsing prose
        served = getattr(exc, "served", None)
        if served is not None:
            body["served"] = sorted(served)
        get_registry().counter("serve.http_errors").inc()
        self._send_json(status, body, headers)

    # -- GET /healthz, /metrics, /varz --------------------------------------

    def do_GET(self):  # noqa: N802 — stdlib method name
        if self.path == "/healthz":
            self._get_healthz()
        elif self.path == "/metrics":
            self._get_metrics()
        elif self.path == "/varz":
            self._get_varz()
        else:
            self._send_error_json(404, "not_found", f"no route {self.path}")

    def _get_healthz(self) -> None:
        fe = self.frontend
        state = fe.admission.state()
        state["inflight"] = int(get_registry().gauge("serve.inflight").value)
        state["draining"] = fe._draining
        # the degradation ladder's position (0 = healthy): rides health so a
        # poller/load balancer sees HOW degraded, not just up-or-down
        state["brownout_level"] = int(get_registry().gauge("serve.brownout_level").value)
        # replica identity: lets a router/obs.report attribute this health
        # to a specific process and detect a restart behind the same address
        state["replica"] = fe.identity()
        status = 503 if state["breaker_state"] == BREAKER_OPEN else 200
        state["ok"] = status == 200 and not fe._draining
        self._send_json(status, state)

    def _get_metrics(self) -> None:
        """Prometheus text exposition of the whole obs registry — the scrape
        surface a multi-replica deployment's collector reads. Histograms emit
        cumulative bucket + quantile lines (obs/registry.py), so
        ``serve_latency_seconds{class="interactive",quantile="0.99"}`` is
        p99 straight off the replica."""
        text = get_registry().render_prometheus()
        if self.frontend.federation is not None:
            # the router frontend is ALSO the fleet's scrape surface:
            # federated families (replica-labeled histograms, fleet gauges,
            # every replica's build_info) ride the same exposition
            text += self.frontend.federation.render_prometheus()
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _get_varz(self) -> None:
        """JSON twin of /metrics for humans and tests: the full registry
        snapshot (histograms expanded with min/max/p50/p95/p99) plus the
        admission state, the oldest in-flight request, build identity, and
        the per-executable compile/cost table (obs/device.py)."""
        from ..obs.device import compile_report

        fe = self.frontend
        doc = {
            "metrics": get_registry().snapshot(),
            "admission": fe.admission.state(),
            "draining": fe._draining,
            "replica": fe.identity(),
            "build_info": get_registry().build_info,
            "executables": compile_report(),
            # raw bucket counts per histogram: the federation scrape's input
            # — fixed log-spaced bounds make cross-replica count summation a
            # LOSSLESS merge (obs/fleet.py)
            "histograms": get_registry().histograms_state(),
        }
        if fe.federation is not None:
            doc["fleet"] = fe.federation.snapshot()
        self._send_json(200, doc)

    # -- POST /predict ------------------------------------------------------

    def _parse_image(self) -> np.ndarray:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            raise ValueError("empty body")
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "application/json").split(";")[0].strip()
        if ctype == "application/octet-stream":
            shape_hdr = self.headers.get("X-Shape", "")
            try:
                shape = tuple(int(s) for s in shape_hdr.split(","))
            except ValueError:
                raise ValueError(f"X-Shape must be 'H,W,C' integers, got {shape_hdr!r}") from None
            # X-Dtype picks the wire encoding; absent = the historical
            # little-endian float32 contract. "u8" carries RAW pixels — the
            # quantized wire's 4x byte drop crossing the fleet intact
            dtype_code = (self.headers.get("X-Dtype") or "f4").strip().lower()
            if dtype_code not in WIRE_DTYPES:
                raise ValueError(
                    f"X-Dtype must be one of {sorted(WIRE_DTYPES)}, got {dtype_code!r}")
            image = np.frombuffer(body, dtype=WIRE_DTYPES[dtype_code])
            if len(shape) != 3 or int(np.prod(shape)) != image.size:
                raise ValueError(
                    f"X-Shape {shape} does not match {image.size} {dtype_code} values")
            image = image.reshape(shape)
        else:
            try:
                doc = json.loads(body)
                image = np.asarray(doc["image"], np.float32)
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                raise ValueError(f"body must be JSON with an 'image' key: {e}") from None
        if image.ndim != 3:
            raise ValueError(f"image must be (H, W, C), got shape {tuple(image.shape)}")
        return image

    def _post_profile(self) -> None:
        """Start/stop the serving profiler capture (obs/device.py). State
        errors (already running / nothing to stop) are 409 so an operator's
        double-tap is loud but harmless; jax.profiler failures are 500."""
        fe = self.frontend
        if fe.profiler is None:
            self._send_error_json(404, "not_found", "no profiler configured (set a log dir)")
            return
        try:
            out = fe.profiler.start() if self.path == "/profile/start" else fe.profiler.stop()
        except RuntimeError as e:
            self._send_error_json(409, "profiler_state", str(e))
            return
        except Exception as e:  # noqa: BLE001 — a torn capture surfaces typed
            self._send_error_json(500, "profiler_error", f"{type(e).__name__}: {e}")
            return
        self._send_json(200, {"ok": True, **out})

    def _post_membership(self) -> None:
        """POST /register|/deregister: the TTL-lease membership endpoints,
        live only when the admission object speaks them (the fleet Router).
        A replica heartbeats /register to stay in the fleet; /deregister is
        the clean-drain fast path."""
        fe = self.frontend
        target = getattr(fe.admission, "register", None)
        if target is None:
            self._send_error_json(404, "not_found",
                                  "membership endpoints need a fleet router")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length)) if length > 0 else {}
            host, port = doc["host"], int(doc["port"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            self._send_error_json(400, "bad_request",
                                  f"body must be JSON with host/port: {e}")
            return
        try:
            if self.path == "/register":
                kw = dict(ttl_s=doc.get("ttl_s"),
                          replica_id=str(doc.get("replica_id", "")))
                if doc.get("models") is not None:
                    # only zoo replicas advertise; keeps pre-zoo register()
                    # implementations (and test doubles) working unchanged
                    kw["models"] = doc["models"]
                out = fe.admission.register(host, port, **kw)
            else:
                out = fe.admission.deregister(host, port)
        except ModelDigestConflict as e:
            # split-brain artifact identity: same model name, different
            # content digest across live replicas — the late joiner is
            # refused with a conflict verdict, not folded into the lottery
            self._send_error_json(409, "digest_conflict", str(e))
            return
        except ValueError as e:
            self._send_error_json(400, "bad_request", str(e))
            return
        self._send_json(200, out)

    def do_POST(self):  # noqa: N802 — stdlib method name
        if self.path in ("/profile/start", "/profile/stop"):
            self._post_profile()
            return
        if self.path in ("/register", "/deregister"):
            self._post_membership()
            return
        if self.path != "/predict":
            self._send_error_json(404, "not_found", f"no route {self.path}")
            return
        fe = self.frontend
        if fe._draining:
            # a request on a connection kept alive past stop(): the batcher
            # is draining or stopped, so the verdict is "draining", and the
            # connection closes
            self.close_connection = True
            self._send_error_json(503, "draining", "the server is draining; send elsewhere",
                                  {"Connection": "close"})
            return
        try:
            image = self._parse_image()
            deadline_hdr = self.headers.get("X-Deadline-Ms")
            deadline_ms = float(deadline_hdr) if deadline_hdr else None
            priority = self.headers.get("X-Priority") or None
            # X-Model names the zoo tenant; absent = the default model (a
            # pre-zoo client keeps working). It rides the RequestContext
            # into admission (validation + per-model quota), the batcher's
            # (model, shape) grouping, and the router's model-aware pick
            model = (self.headers.get("X-Model") or "").strip() or None
        except ValueError as e:
            self._send_error_json(400, "bad_request", str(e))
            return
        # request identity: a process-monotonic id minted HERE, echoed on
        # every response as X-Request-Id (a client-supplied value is echoed
        # back verbatim as the wire id; the internal id stays monotonic —
        # trace correlation needs process-unique ids) and threaded through
        # admission -> batcher -> engine as the trace correlation key
        ctx = RequestContext.mint(
            priority or fe.admission._default_class, deadline_ms,
            client_tag=self.headers.get("X-Request-Id") or None,
            # the router's per-leg fleet trace identity (context.py): replica
            # trace events carry the ROUTER-issued request id, and
            # link_parent below lands the router->replica flow arrow
            trace_parent=self.headers.get("X-Trace-Parent") or None,
            model=model,
        )
        rid_hdr = {"X-Request-Id": ctx.wire_id}
        try:
            with obs_trace.get_tracer().span("serve/submit", "serve", rid=ctx.rid,
                                             **ctx._targs()):
                ctx.link_parent()
                fut = fe.admission.submit(
                    image, priority=priority, deadline_ms=deadline_ms, ctx=ctx
                )
        except UnknownModel as e:
            # its own _ERROR_MAP row, before the ValueError branch below
            self._send_typed_error(e, rid_hdr)
            return
        except ValueError as e:  # unknown priority class
            self._send_error_json(400, "bad_request", str(e), rid_hdr)
            return
        except Exception as e:  # noqa: BLE001 — typed arrival rejections
            self._send_typed_error(e, rid_hdr)
            return
        # the handler thread is this request's only waiter: a deadline
        # extends the server bound (the admission/batcher layers resolve the
        # future well before this backstop unless something is truly wedged)
        timeout_s = fe.request_timeout_s + (deadline_ms or 0.0) / 1e3
        try:
            logits = fut.result(timeout=timeout_s)
        except (TimeoutError, FutureTimeout):
            self._send_error_json(504, "timeout", f"no result within {timeout_s:.1f}s", rid_hdr)
            return
        except Exception as e:  # noqa: BLE001 — typed shed/failure outcomes
            self._send_typed_error(e, rid_hdr)
            return
        self._send_json(
            200,
            {"logits": np.asarray(logits, np.float64).tolist(),
             "priority": priority or fe.admission._default_class,
             "request_id": ctx.wire_id},
            rid_hdr,
        )


class Frontend:
    """Owns the HTTP server + accept-loop thread around an
    :class:`~.admission.AdmissionController`."""

    def __init__(
        self,
        admission,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 60.0,
        retry_after_s: float = 1.0,
        profiler=None,
        replica_id: str = "",
        federation=None,
    ):
        self.admission = admission
        # obs/device.py ProfilerCapture (or None): POST /profile/start|stop
        self.profiler = profiler
        # obs/fleet.py FleetFederation (or None): set on the ROUTER's
        # frontend, it extends /metrics with replica-labeled federated
        # families and /varz with the fleet snapshot
        self.federation = federation
        self._host = host
        self._port = port
        self.request_timeout_s = request_timeout_s
        self.retry_after_s = retry_after_s
        # stable name a supervisor assigns (serve.listen.replica_id); ports
        # are ephemeral and pids recycle, so health/restart attribution
        # needs an identity that survives both
        self.replica_id = replica_id or f"pid-{os.getpid()}"
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._draining = False

    def identity(self) -> dict:
        """The replica identity block on /healthz and /varz: who is serving
        behind this address, and since when."""
        return {
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "start_unix": _PROC_START_UNIX,
            "git_sha": get_registry().build_info.get("git_sha", ""),
        }

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("frontend not started")
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "Frontend":
        if self._server is not None:
            raise RuntimeError("frontend already started")
        handler = type("_BoundHandler", (_Handler,), {"frontend": self})
        self._server = ThreadingHTTPServer((self._host, self._port), handler)
        self._server.daemon_threads = True  # handler threads never block exit
        self._thread = threading.Thread(target=self._serve, name="serve-http", daemon=True)
        self._thread.start()
        return self

    def _serve(self) -> None:
        try:
            obs_trace.get_tracer().register_thread()  # "serve-http" Perfetto row
            self._server.serve_forever(poll_interval=0.1)
        except Exception as e:  # noqa: BLE001 — YAMT011: never die silently
            get_registry().counter("serve.thread_crashes").inc()
            emit(f"[serve] http accept loop crashed: {type(e).__name__}: {e}")

    def stop(self) -> None:
        """Stop accepting; in-flight handler threads finish their responses.
        The caller drains the batcher next (bounded by drain_timeout_s)."""
        if self._server is None:
            return
        self._draining = True
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self._server = None  # yamt-lint: disable=YAMT019 — teardown: shutdown() has returned serve_forever and the accept thread was joined above
        self._thread = None

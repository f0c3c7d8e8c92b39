"""The port's front door (cli/serve.py ``_listen``, serve/frontend.py over the
port's engine, obs/device.py ``compile_report`` and ``ProfilerCapture``) on
the CPU, over loopback HTTP.

The port's mirrors of the cases of tests/test_frontend.py that touch the
engine, the CLI or obs/device.py: ``/predict`` logits bitwise equal to the
engine's at bucket 1, ``X-Model`` routing and the typed unknown-model
error, ``/varz`` with the compile report's ``_m<name>`` keys, the profiler
window's single flight and its close at the drain, a fault-injected round,
and ``cli.serve --listen --device cpu`` as a subprocess drained by SIGTERM.
Without ``--device cpu`` the CLI asks for the card and fails before it
binds. F3 (the fault injector sends a zoo's requests to its default
tenant) is pinned in the JAX package and refused by the port's CLI; F4 (an
unknown ``X-Model`` answered ``bad_request``) and F5 (a request on a
connection kept alive past the frontend's stop meets the stopped batcher)
are pinned in the JAX package and repaired in the port.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax
import torch

from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu.serve import export as jax_export
from yet_another_mobilenet_series_tpu.serve.admission import AdmissionController as JaxAdmissionController
from yet_another_mobilenet_series_tpu.serve.engine import InferenceEngine as JaxEngine
from yet_another_mobilenet_series_tpu.serve.faults import FaultyEngine as JaxFaultyEngine
from yet_another_mobilenet_series_tpu.serve.frontend import Frontend as JaxFrontend
from yet_another_mobilenet_series_tpu.serve.pipeline import PipelinedBatcher as JaxPipelinedBatcher
from yet_another_mobilenet_series_tpu_torch.bench import trace_ops
from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs import device as obs_device
from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.admission import AdmissionController
from yet_another_mobilenet_series_tpu_torch.serve.client import ClientHTTPError, ReplicaClient
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.serve.faults import FaultyEngine
from yet_another_mobilenet_series_tpu_torch.serve.frontend import Frontend
from yet_another_mobilenet_series_tpu_torch.serve.pipeline import PipelinedBatcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")
SIZE = 24
SPECS = {"small": [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5]}],
         "big": [{"t": 3, "c": 16, "n": 2, "s": 2}, {"t": 4, "c": 24, "n": 1, "s": 2, "se": 0.25}]}
CLASSES = {"small": 10, "big": 7}


def _export(tmp_path, name, seed):
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=CLASSES[name], block_specs=SPECS[name],
                                dropout=0.0), image_size=SIZE)
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    return export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / name), model_name=name,
                                device="cpu")


@pytest.fixture
def zoo_dirs(tmp_path):
    return {"small": _export(tmp_path, "small", 0), "big": _export(tmp_path, "big", 1)}


def _images(seed, n):
    return np.random.RandomState(seed).normal(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def _wait_addr(log_dir, alive, timeout=120):
    path = os.path.join(log_dir, "listen_addr.json")
    deadline = time.time() + timeout
    while not os.path.exists(path):
        assert alive(), "the server died before it bound"
        assert time.time() < deadline, "the server never bound"
        time.sleep(0.1)
    with open(path) as f:
        return json.load(f)


def _listen_cfg(zoo_dirs, log_dir, *extra):
    return parse_cli([f"app:{APP}", "serve.listen.enable=true", f"data.image_size={SIZE}", "serve.buckets=[1]",
                      "serve.max_batch=1", "serve.drain_timeout_s=10", f"train.log_dir={log_dir}",
                      "serve.zoo.models=" + ",".join(f"{m}={d}" for m, d in zoo_dirs.items()), *extra])


def test_cli_listen_serves_the_zoo_bitwise_with_typed_errors_varz_and_a_profiler_window(tmp_path, zoo_dirs):
    get_registry().reset()
    log_dir = str(tmp_path / "srv")
    cfg = _listen_cfg(zoo_dirs, log_dir)
    stop = threading.Event()
    out: dict = {}
    th = threading.Thread(target=lambda: out.update(serve_cli.run(cfg, device="cpu", stop_event=stop)))
    th.start()
    try:
        addr = _wait_addr(log_dir, th.is_alive)
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
        refs = {m: InferenceEngine(export.load_bundle(d), device="cpu", buckets=(1,)) for m, d in zoo_dirs.items()}
        x = _images(4, 3)
        for i in range(3):
            for model in ("small", "big"):
                got = client.predict(x[i], model=model)
                np.testing.assert_array_equal(got, refs[model].predict(x[i: i + 1])[0])
            # no X-Model: the zoo's default (its first) tenant
            np.testing.assert_array_equal(client.predict(x[i]), refs["small"].predict(x[i: i + 1])[0])
        with pytest.raises(ClientHTTPError) as e:
            client.predict(x[0], model="huge")
        # F4, repaired in the port: its own "unknown_model" row answers (the
        # JAX package's answer, "bad_request", is pinned below); the served
        # list rides the message
        assert e.value.status == 400 and e.value.tag == "unknown_model"
        assert "unknown model 'huge'; served: small, big" in str(e.value)
        status, health = client.healthz()
        assert status == 200 and health["breaker"] == "closed"
        metrics = client.metrics_text()
        line = next(ln for ln in metrics.splitlines() if ln.startswith("build_info{"))
        assert "torch_version=" in line and 'gpu_name="none"' in line and "quant_mode=" in line
        status, varz = client.varz()
        assert status == 200 and varz["metrics"]["serve.model_requests.big"] == 3
        assert {f"serve_b1_s{SIZE}_k1_msmall", f"serve_b1_s{SIZE}_k1_mbig"} <= set(varz["executables"])
        # the profiler window: single flight, a Chrome trace trace_ops reads
        status, _, doc = client._request_json("POST", "/profile/start")
        assert status == 200 and doc["trace_dir"].endswith("trace")
        status, _, doc = client._request_json("POST", "/profile/start")
        assert status == 409 and doc["error"] == "profiler_state"
        client.predict(x[0], model="big")
        status, _, doc = client._request_json("POST", "/profile/stop")
        assert status == 200 and doc["captured_s"] >= 0 and os.path.exists(doc["trace"])
        trace, _ = trace_ops.load_trace(doc["trace"])
        assert trace_ops.aggregate(trace)["events"] > 0
        assert client._request_json("POST", "/profile/stop")[0] == 409
        # a window left open is closed by the drain
        assert client._request_json("POST", "/profile/start")[0] == 200
        client.close()
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and out["listened"] and out["drain_timeouts"] == 0
    assert len(os.listdir(os.path.join(log_dir, "trace"))) == 2
    with open(os.path.join(log_dir, "obs_registry.json")) as f:
        snap = json.load(f)
    assert snap["serve.model_requests.small"] == 6 and snap["serve.http_requests"] >= 10


def test_profiler_capture_is_single_flight_and_stops_if_active(tmp_path):
    cap = obs_device.ProfilerCapture(str(tmp_path / "t"))
    cap.stop_if_active()  # nothing open: no error
    with pytest.raises(RuntimeError, match="no profiler capture"):
        cap.stop()
    cap.start()
    assert cap.active
    with pytest.raises(RuntimeError, match="already active"):
        cap.start()
    torch.ones(4).sum()
    cap.stop_if_active()
    assert not cap.active and os.listdir(str(tmp_path / "t")) == ["serve_trace_1.json"]
    assert get_registry().snapshot()["obs.profiler_captures"] >= 1


def test_faulty_engine_round_behind_the_frontend(tmp_path, zoo_dirs):
    get_registry().reset()
    engine = InferenceEngine(export.load_bundle(zoo_dirs["big"]), device="cpu", buckets=(1,))
    cfg = parse_cli([f"app:{APP}", "serve.max_batch=1", "serve.admission.max_retries=2"])
    batcher = serve_cli._make_batcher(cfg, FaultyEngine(engine, fail_first_n=2, seed=0)).start()
    admission = AdmissionController.from_config(batcher, cfg.serve.admission)
    fe = Frontend(admission, port=0).start()
    client = ReplicaClient("127.0.0.1", fe.port, timeout_s=60.0)
    try:
        x = _images(7, 2)
        for i in range(2):  # the first request rides two injected failures and its retries
            np.testing.assert_array_equal(client.predict(x[i]), engine.predict(x[i: i + 1])[0])
    finally:
        client.close()
        fe.stop()
        batcher.stop(drain=True)
    snap = get_registry().snapshot()
    assert snap["serve.faults.failures"] == 2 and snap["serve.retries"] == 2 and snap["serve.engine_failures"] == 2


def test_f3_the_fault_injector_sends_a_zoo_request_to_the_default_tenant_and_the_port_refuses_it(tmp_path,
                                                                                                  zoo_dirs):
    dirs = {}
    for name, seed in (("small", 0), ("big", 1)):
        jnet = jax_get_model(JaxModelConfig(arch="mobilenet_v2", num_classes=CLASSES[name], block_specs=SPECS[name],
                                            dropout=0.0), image_size=SIZE)
        params, state = jnet.init(jax.random.PRNGKey(seed))
        dirs[name] = jax_export.export_bundle(jnet, params, state, str(tmp_path / f"jax_{name}"), model_name=name)
    bundles = {m: jax_export.load_bundle(d) for m, d in dirs.items()}
    engine = JaxEngine(models=bundles, buckets=(1,), fuse_ladder=())
    x = _images(2, 1)
    batcher = JaxPipelinedBatcher(JaxFaultyEngine(engine, seed=0), max_batch=1, max_wait_ms=1.0).start()
    try:
        got = batcher.submit(x[0], model="big").result(timeout=60)
    finally:
        batcher.stop(drain=True)
    assert got.shape == (CLASSES["small"],)  # the default tenant answered a request for "big"
    np.testing.assert_array_equal(got, np.asarray(engine.predict(x, model="small"))[0])
    cfg = _listen_cfg(zoo_dirs, str(tmp_path / "f3"), "serve.faults.enable=true")
    with pytest.raises(ValueError, match="F3"):
        serve_cli.run(cfg, device="cpu")


class _Echo:
    def predict_async(self, images):
        class _Handle:
            def result(_self):
                return images[:, 0, 0, :1]

        return _Handle()

    def predict(self, images):
        return self.predict_async(images).result()


def test_f5_a_connection_kept_alive_past_stop_meets_the_stopped_batcher_in_jax_and_draining_in_the_port():
    verdicts = {}
    for name, batcher_cls, admission_cls, frontend_cls in (
            ("jax", JaxPipelinedBatcher, JaxAdmissionController, JaxFrontend),
            ("port", PipelinedBatcher, AdmissionController, Frontend)):
        batcher = batcher_cls(_Echo(), max_batch=4, max_wait_ms=1.0, drain_timeout_s=2.0).start()
        fe = frontend_cls(admission_cls(batcher), port=0).start()
        client = ReplicaClient("127.0.0.1", fe.port, timeout_s=30.0)
        x = np.full((4, 4, 3), 7.0, np.float32)
        assert client.predict(x)[0] == 7.0  # the connection is now kept alive
        fe.stop()
        batcher.stop(drain=True)
        with pytest.raises(ClientHTTPError) as e:
            client.predict(x)
        verdicts[name] = (e.value.status, e.value.tag)
        client.close()
    assert verdicts == {"jax": (500, "engine_error"), "port": (503, "draining")}


def test_f4_an_unknown_model_is_bad_request_in_jax_and_unknown_model_in_the_port():
    verdicts = {}
    for name, batcher_cls, admission_cls, frontend_cls in (
            ("jax", JaxPipelinedBatcher, JaxAdmissionController, JaxFrontend),
            ("port", PipelinedBatcher, AdmissionController, Frontend)):
        batcher = batcher_cls(_Echo(), max_batch=4, max_wait_ms=1.0).start()
        fe = frontend_cls(admission_cls(batcher, models=("a", "b"), default_model="a"), port=0).start()
        client = ReplicaClient("127.0.0.1", fe.port, timeout_s=30.0)
        try:
            with pytest.raises(ClientHTTPError) as e:
                client.predict(np.zeros((4, 4, 3), np.float32), model="zzz")
            verdicts[name] = (e.value.status, e.value.tag, "served: a, b" in str(e.value))
        finally:
            client.close()
            fe.stop()
            batcher.stop(drain=True)
    assert verdicts == {"jax": (400, "bad_request", True), "port": (400, "unknown_model", True)}


_SERVE = [sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.serve", f"app:{APP}", "--listen"]


def test_cli_listen_subprocess_on_cpu_drains_on_sigterm_and_without_a_card_fails_before_binding(tmp_path,
                                                                                                 zoo_dirs):
    env = dict(os.environ, PYTHONPATH=REPO)
    args = [f"serve.bundle={zoo_dirs['big']}", f"data.image_size={SIZE}", "serve.buckets=[1,4]",
            "serve.drain_timeout_s=10", "obs.trace=true"]
    no_card = str(tmp_path / "no_card")
    proc = subprocess.run(_SERVE + args + [f"train.log_dir={no_card}"], env=env, capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    assert not os.path.exists(os.path.join(no_card, "listen_addr.json"))

    log_dir = str(tmp_path / "srv")
    proc = subprocess.Popen(_SERVE + args + [f"train.log_dir={log_dir}", "--device", "cpu"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        addr = _wait_addr(log_dir, lambda: proc.poll() is None)
        assert addr["pid"] == proc.pid
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
        x = _images(5, 1)
        ref = InferenceEngine(export.load_bundle(zoo_dirs["big"]), device="cpu", buckets=(1,)).predict(x)[0]
        np.testing.assert_array_equal(client.predict(x[0], priority="interactive", deadline_ms=30000), ref)
        client.close()
        proc.send_signal(signal.SIGTERM)
        t0 = time.time()
        assert proc.wait(timeout=30) == 0
        assert time.time() - t0 < 15
        text = proc.stdout.read()
        assert "drained in" in text and "clean" in text
        with open(os.path.join(log_dir, "obs_registry.json")) as f:
            snap = json.load(f)
        assert snap["serve.requests.interactive"] == 1 and snap["serve.breaker_state"] == 0
        with open(os.path.join(log_dir, "obs_trace.json")) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        assert {"serve/request", "serve/dispatch"} <= names
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

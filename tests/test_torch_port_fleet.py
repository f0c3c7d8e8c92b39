"""The port's fleet (cli/fleet.py spawning the port's cli/serve.py replicas,
the router and the confidence cascade) on the CPU, over loopback HTTP.

One fleet of two replicas under ``--device cpu``, placement ``small;big``
(slot 0 serves the small model, slot 1 the big one) and the cascade at the
median margin of a seeded image set: answers through the router equal each
model's in-process engine bit for bit; unqualified requests escalate on a
low margin and each answer is bitwise one of the two references; a kill -9
of the big replica under cascade load leaves every request completed or
typed-rejected, and the supervisor restarts it; SIGTERM drains the fleet.
A second fleet without ``--device cpu`` asks for the card, which this
machine lacks: no replica comes up and the supervisor exits non-zero.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.cascade import softmax_margin
from yet_another_mobilenet_series_tpu_torch.serve.client import ClientHTTPError, ReplicaClient
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_fleet.yml")
SIZE = 24
SPECS = {"small": [{"t": 2, "c": 8, "n": 1, "s": 2}],
         "big": [{"t": 3, "c": 16, "n": 2, "s": 2}, {"t": 4, "c": 24, "n": 1, "s": 2, "se": 0.25}]}
IMAGES = 16
# typed verdicts a client may get while a replica is down (serve/frontend.py)
TYPED = {"no_replica_for_model", "no_healthy_replicas", "breaker_open", "queue_full", "draining"}


def _export(tmp_path, name, seed):
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, block_specs=SPECS[name], dropout=0.0),
                    image_size=SIZE)
    gen = torch.Generator().manual_seed(seed)
    params, _ = net.init(gen)
    return export.export_bundle(net, params, random_bn_state(net, gen), str(tmp_path / name), model_name=name,
                                device="cpu")


def _read(path):
    with open(path) as f:
        return json.load(f)


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.2)


def _fleet(log_dir, *args):
    return subprocess.Popen([sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.fleet",
                             f"app:{FLEET_APP}", f"train.log_dir={log_dir}", *args],
                            env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_fleet_of_port_replicas_routes_cascades_and_survives_a_kill(tmp_path):
    dirs = {"small": _export(tmp_path, "small", 0), "big": _export(tmp_path, "big", 1)}
    refs = {m: InferenceEngine(export.load_bundle(d), device="cpu", buckets=(1,)) for m, d in dirs.items()}
    images = np.random.RandomState(3).normal(0, 1, (IMAGES, SIZE, SIZE, 3)).astype(np.float32)
    want = {m: [e.predict(images[i: i + 1])[0] for i in range(IMAGES)] for m, e in refs.items()}
    threshold = float(np.median([softmax_margin(r) for r in want["small"]]))
    log_dir = str(tmp_path / "fleet")
    proc = _fleet(log_dir, f"serve.zoo.models=small={dirs['small']},big={dirs['big']}",
                  "serve.zoo.placement=small;big", "serve.zoo.cascade.enable=true", "serve.zoo.cascade.small=small",
                  "serve.zoo.cascade.big=big", f"serve.zoo.cascade.threshold={threshold}",
                  # replicas serving different models differ in latency by design
                  "serve.fleet.slow_eject.enable=false",
                  f"data.image_size={SIZE}", "serve.buckets=[1]", "serve.max_batch=1", "serve.drain_timeout_s=10",
                  "--device", "cpu")
    try:
        router_addr = os.path.join(log_dir, "listen_addr.json")
        _wait(lambda: os.path.exists(router_addr) or proc.poll() is not None, 180, "the fleet never bound")
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        addr = _read(router_addr)
        assert addr["role"] == "router" and addr["replicas"] == 2
        replicas = [_read(os.path.join(log_dir, f"r{i}", "listen_addr.json")) for i in range(2)]
        assert {r["replica_id"] for r in replicas} == {"r0", "r1"}
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
        for i in range(4):
            for model in ("small", "big"):
                np.testing.assert_array_equal(client.predict(images[i], model=model), want[model][i])
        # the cascade: each unqualified answer is one of the two references
        answers = [client.predict(images[i]) for i in range(IMAGES)]
        big = [i for i, a in enumerate(answers) if np.array_equal(a, want["big"][i])]
        small = [i for i, a in enumerate(answers) if np.array_equal(a, want["small"][i])]
        assert len(big) + len(small) == IMAGES and big and small
        assert all(softmax_margin(want["small"][i]) < threshold for i in big)
        _, varz = client.varz()
        met = varz["metrics"]
        assert met["serve.cascade.escalations"] == len(big) and met["serve.cascade.answered_small"] == len(small)

        # kill -9 the big replica under cascade load
        victim = replicas[1]["pid"]
        outcomes = {"completed": 0, "typed": 0, "failed": 0}
        lock = threading.Lock()

        def load(seed):
            c = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
            try:
                for j in range(12):
                    i = (seed * 12 + j) % IMAGES
                    try:
                        a = c.predict(images[i])
                        ok = np.array_equal(a, want["small"][i]) or np.array_equal(a, want["big"][i])
                        key = "completed" if ok else "failed"
                    except ClientHTTPError as e:
                        key = "typed" if e.tag in TYPED else "failed"
                    with lock:
                        outcomes[key] += 1
            finally:
                c.close()

        threads = [threading.Thread(target=load, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        os.kill(victim, signal.SIGKILL)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert outcomes["failed"] == 0 and outcomes["completed"] + outcomes["typed"] == 36, outcomes
        path = os.path.join(log_dir, "r1", "listen_addr.json")
        _wait(lambda: os.path.exists(path) and _read(path)["pid"] != victim, 120, "r1 was not restarted")
        _wait(lambda: client.varz()[1]["metrics"].get("fleet.restarts", 0) >= 1, 30, "no restart counted")
        _wait(lambda: _ok(client, images[0], want["big"][0]), 60, "the restarted replica never answered")
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "fleet drained in" in proc.stdout.read()
        new = _read(path)["pid"]
        _wait(lambda: not _alive(new) and not _alive(replicas[0]["pid"]), 30, "a replica outlived the fleet")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _ok(client, image, want):
    try:
        return np.array_equal(client.predict(image, model="big"), want)
    except ClientHTTPError:
        return False


def test_a_fleet_asked_for_the_card_on_a_machine_without_one_fails_to_spawn(tmp_path):
    bundle = _export(tmp_path, "small", 0)
    log_dir = str(tmp_path / "fleet")
    proc = _fleet(log_dir, f"serve.bundle={bundle}", f"data.image_size={SIZE}", "serve.fleet.spawn_timeout_s=120")
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode != 0 and "no replica came up" in out
    assert not os.path.exists(os.path.join(log_dir, "listen_addr.json"))
    with open(os.path.join(log_dir, "r0", "replica.log")) as f:
        assert "torch.cuda.is_available() is False" in f.read()

"""The port's spans (obs/trace.py, obs/device.py) on the CPU: when they record, their wall clock,
parents and self time, the train step's phases and the engine's pieces, the benchmark's readers of
them on synthetic records, and a ``/profile`` window's exported trace holding them.

Device time needs a card: here every span is the host's, and the readers' device arithmetic is
held on records made by hand. The card's readings are the benchmark's (PERF.md)."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, config_from_dict
from yet_another_mobilenet_series_tpu_torch.models import get_model
from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
from yet_another_mobilenet_series_tpu_torch.obs import device as obs_device
from yet_another_mobilenet_series_tpu_torch.obs import trace as obs_trace
from yet_another_mobilenet_series_tpu_torch.obs.trace import SpanRecord, SpanTracer
from yet_another_mobilenet_series_tpu_torch.serve import export
from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def tracer(monkeypatch):
    """A fresh process tracer, as an unconfigured process has it."""
    tr = SpanTracer(ring_size=obs_trace.SESSION_RING, enabled=False)
    monkeypatch.setattr(obs_trace, "_TRACER", tr)
    return tr


def _session():
    return torch.profiler.profile(activities=CPU_ONLY)


def test_spans_record_inside_a_profiler_session_and_nowhere_else(tracer):
    with tracer.span("before"):
        pass
    with _session():
        with tracer.span("inside", "misc", k=1):
            pass
    with tracer.span("after"):
        pass
    assert [(r.name, r.args) for r in tracer.records()] == [("inside", {"k": 1})]


def test_a_configured_tracer_still_records_without_a_session(monkeypatch):
    monkeypatch.setattr(obs_trace, "_TRACER", obs_trace.get_tracer())
    tr = obs_trace.configure(enabled=True, ring_size=16)
    with tr.span("configured"):
        pass
    assert [r.name for r in tr.records()] == ["configured"]
    # configured off, a tracer keeps a ring that holds a whole profiler window
    assert obs_trace.configure(enabled=False, ring_size=16).ring_size == obs_trace.SESSION_RING


def test_wall_start_and_end_lie_between_the_reads_around_the_span(tracer):
    with _session():
        before = time.time_ns()
        with tracer.span("timed"):
            time.sleep(0.002)
        after = time.time_ns()
    (r,) = tracer.records()
    assert isinstance(r.start_ns, int) and isinstance(r.end_ns, int)
    assert before <= r.start_ns < r.end_ns <= after and r.end_ns - r.start_ns >= 2_000_000
    assert r.device is None and r.device_start_ns is None and r.note is None


def test_parent_ids_and_self_time(tracer):
    with _session():
        with tracer.span("outer"):
            with tracer.span("first"):
                time.sleep(0.002)
            with tracer.span("second"):
                time.sleep(0.002)
        with tracer.span("alone"):
            pass
    recs = {r.name: r for r in tracer.records()}
    outer = recs["outer"]
    assert recs["first"].parent == recs["second"].parent == outer.sid
    assert outer.parent is None and recs["alone"].parent is None
    children = sum(r.end_ns - r.start_ns for r in recs.values() if r.parent == outer.sid)
    own = outer.end_ns - outer.start_ns - children
    assert 0 <= own < children and children >= 4_000_000


def _tiny_step():
    d = {"model": {"arch": "mobilenet_v2", "num_classes": 4, "dropout": 0.0,
                   "block_specs": [{"t": 2, "c": 8, "n": 1, "s": 2}]},
         "optim": {"optimizer": "rmsprop"},
         "schedule": {"schedule": "constant", "base_lr": 0.01, "scale_by_batch": False, "warmup_epochs": 0.0},
         "ema": {"enable": True, "decay": 0.9, "warmup": False},
         "train": {"compute_dtype": "float32"}}
    cfg = config_from_dict(d)
    net = get_model(cfg.model, image_size=16)
    lr = schedules.make_lr_schedule(cfg.schedule, 4, 1, 100)
    params, _ = net.init(torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(cfg.optim, lr, params)
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    return steps.make_train_step(net, cfg, opt, lr), ts


def test_the_train_step_phases_tile_the_step_in_order(tracer):
    step, ts = _tiny_step()
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.randn(4, 16, 16, 3, generator=gen), "label": torch.tensor([0, 1, 2, 3])}
    with _session():
        for _ in range(2):
            ts, _ = step(ts, batch, gen)
    recs = tracer.records()
    names = ["train/forward", "train/backward", "train/update", "train/step"]  # closed in this order
    assert [r.name for r in recs] == names * 2
    for i in range(2):
        fwd, bwd, upd, whole = recs[4 * i: 4 * i + 4]
        assert fwd.parent == bwd.parent == upd.parent == whole.sid
        assert whole.start_ns <= fwd.start_ns <= fwd.end_ns <= bwd.start_ns <= bwd.end_ns <= upd.start_ns
        assert upd.end_ns <= whole.end_ns
        phases = sum(r.end_ns - r.start_ns for r in (fwd, bwd, upd))
        assert phases >= 0.95 * (whole.end_ns - whole.start_ns)
        assert all(r.device is None for r in (fwd, bwd, upd, whole))  # the CPU: the host's spans alone


@pytest.fixture(scope="module")
def engine():
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, dropout=0.0,
                                block_specs=[{"t": 2, "c": 8, "n": 1, "s": 2}]), image_size=16)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    bundle = export.InferenceBundle(net=net, params=export.fold_network(net, params, random_bn_state(net, gen)),
                                    meta={})
    eng = InferenceEngine(bundle, device="cpu", buckets=(2, 4), image_size=16, fuse_ladder=(2,),
                          overlap_staging=True)
    eng.warmup()
    return eng


def test_an_engine_call_gives_each_piece_its_spans_under_one_request_id(tracer, engine):
    x = np.random.RandomState(0).normal(0, 1, (11, 16, 16, 3)).astype(np.float32)
    engine.predict(x)  # outside a session: nothing recorded
    with _session():
        engine.predict(x)  # 11 rows: a fused piece of 2 x 4 rows, then a 3-row piece in bucket 4
        engine.predict(x[:1])
    recs = tracer.records()
    by_req: dict[int, list[SpanRecord]] = {}
    for r in recs:
        by_req.setdefault(r.args["req"], []).append(r)
    first, second = sorted(by_req)
    assert [r.name for r in by_req[first]] == ["serve/h2d", "serve/stage", "serve/dispatch_fused",
                                               "serve/h2d", "serve/stage", "serve/dispatch", "serve/complete"]
    assert [r.name for r in by_req[second]] == ["serve/h2d", "serve/stage", "serve/dispatch", "serve/complete"]
    for r in recs:
        if r.name == "serve/h2d":
            (parent,) = [p for p in recs if p.sid == r.parent]
            assert parent.name == "serve/stage"


# -- the benchmark's readers, on records made by hand ------------------------------------------

MS = 1_000_000  # ns


class _Records:
    def __init__(self, recs):
        self._recs = recs

    def records(self):
        return list(self._recs)


def _rec(name, sid, start_ms, end_ms, dev=None, parent=None):
    """A record from ms offsets: host [start, end], and the device's [a, b] where ``dev`` gives it
    (``"none"``: a device span whose events never completed)."""
    placed = isinstance(dev, tuple)
    return SpanRecord(name, "x", 1, sid, parent, start_ms * MS, end_ms * MS,
                      None if dev is None else "cuda:0 stream 1",
                      dev[0] * MS if placed else None, dev[1] * MS if placed else None,
                      None if dev is None or placed else "event not completed", None)


def _train_records(steps_n, missing=False):
    recs, sid = [], 0
    for i in range(steps_n):
        t = 200 * i
        sid += 4
        recs += [_rec("train/forward", sid + 1, t + 1, t + 20, (t + 30, t + 90), parent=sid),
                 _rec("train/backward", sid + 2, t + 20, t + 40, (t + 90, t + 210), parent=sid),
                 _rec("train/update", sid + 3, t + 40, t + 45, "none" if missing else (t + 210, t + 215), parent=sid),
                 _rec("train/step", sid, t, t + 50, (t + 29, t + 215))]
    return recs


def _serve_records(missing=False):
    # two dispatches: one waits 1.5 ms for its slot, each copies for 2 ms on the card and replays
    # for 3 (the fused one 5)
    return [_rec("serve/slot_wait", 11, 0.5, 2.0, parent=10),
            _rec("serve/h2d", 12, 2.0, 2.5, (3, 5), parent=10),
            _rec("serve/stage", 10, 0, 3),
            _rec("serve/dispatch_fused", 13, 3, 3.5, (5, 10)),
            _rec("serve/h2d", 21, 4.0, 4.25, "none" if missing else (10, 12), parent=20),
            _rec("serve/stage", 20, 3.5, 5),
            _rec("serve/dispatch", 22, 5, 5.5, (12, 15)),
            _rec("serve/complete", 23, 6, 15)]


# (metric, records, window, the value by hand, records on which it reads None)
READERS = [
    ("forward_ms_per_step.train", _train_records(2), {"steps": 2}, 60.0, _train_records(3)),
    ("backward_ms_per_step.train", _train_records(2), {"steps": 2}, 120.0, _train_records(3)),
    ("update_ms_per_step.train", _train_records(2), {"steps": 2}, 5.0, _train_records(2, missing=True)),
    ("host_ms_per_step.train", _train_records(2), {"steps": 2}, 50.0, _train_records(1)),
    # self time: (3 - 1.5 - 0.5) and (1.5 - 0.25), over two dispatches
    ("stage_ms_per_dispatch.serve", _serve_records(), {}, (1.0 + 1.25) / 2, []),
    ("slot_wait_ms_per_dispatch.serve", _serve_records(), {}, 1.5 / 2, []),
    ("h2d_ms_per_dispatch.serve", _serve_records(), {}, (2 + 2) / 2, _serve_records(missing=True)),
    ("replay_ms_per_dispatch.serve", _serve_records(), {}, (5 + 3) / 2, []),
]


@pytest.mark.parametrize("metric,recs,window,want,unread", READERS, ids=[r[0] for r in READERS])
def test_each_reader_reads_its_spans(metric, recs, window, want, unread, monkeypatch):
    read = run.load_reader(run.ROOT, metric)
    reading = run.Reading(SimpleNamespace(busy_us=1.0), window, {}, "cpu")
    monkeypatch.setattr(obs_trace, "_TRACER", _Records(recs))
    assert read(reading) == pytest.approx(want, rel=1e-9)
    monkeypatch.setattr(obs_trace, "_TRACER", _Records(unread))
    assert read(reading) is None
    # a window with no device record (the CPU), and a program without the spans, read nothing
    monkeypatch.setattr(obs_trace, "_TRACER", _Records(recs))
    assert read(run.Reading(SimpleNamespace(busy_us=0.0), window, {}, "cpu")) is None
    monkeypatch.setattr(obs_trace, "_TRACER", SimpleNamespace())
    assert read(reading) is None


def test_a_profile_window_exports_the_spans_opened_inside_it(tracer, tmp_path):
    cap = obs_device.ProfilerCapture(str(tmp_path))
    cap.start()
    lo = time.time_ns()
    with tracer.span("serve/inside", "serve", k=3):
        torch.ones(8).add_(1)
    hi = time.time_ns()
    out = cap.stop()
    doc = json.loads(open(out["trace"]).read())
    base = int(doc.get("baseTimeNanoseconds", 0))
    (ev,) = [e for e in doc["traceEvents"] if e.get("name") == "serve/inside"]
    assert ev["ph"] == "X" and ev["args"] == {"k": 3}
    assert lo - 1e3 <= base + ev["ts"] * 1e3 <= base + (ev["ts"] + ev["dur"]) * 1e3 <= hi + 1e3
    # the profiler's own records of the window sit on the same base
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == "aten::add_"]
    assert ops and all(lo - 1e3 <= base + e["ts"] * 1e3 <= hi + 1e3 for e in ops)

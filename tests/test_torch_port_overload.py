"""The port's serve bench overload arm (ROADMAP S7), rehearsed on the CPU
and held to the JAX contract's invariants (tests/test_bench_contract.py
``_assert_overload``): at the tiny preset, the brownout A/B under one seeded
3x storm through the port's batcher, admission control and brownout ladder
over its engine, paced by its fault injector, then the gray-failure round
over replica processes of the port's ``cli/serve.py`` behind its router.
The invariants read the arm's own numbers; the line nulls its times on the
CPU and keeps the availability. The partition arm is
tests/test_torch_port_partition.py.
"""

import json

from test_bench_contract import _assert_overload
from yet_another_mobilenet_series_tpu_torch.bench import serve_bench


def _line(argv, capsys):
    rc = serve_bench.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_overload_arm_cpu_rehearsal_keeps_the_jax_contract(capsys, monkeypatch):
    raw = {}
    measure = serve_bench.measure_overload

    def keep(args, dev, log_root):
        raw.update(measure(args, dev, log_root))
        return raw

    monkeypatch.setattr(serve_bench, "measure_overload", keep)
    rc, out = _line(["--overload", "--device", "cpu", "--arch", "tiny", "--image-sizes", "24", "--buckets", "1,4",
                     "--overload-storm-s", "3", "--overload-gray-requests", "48"], capsys)
    assert rc == 0 and "error" not in out, out.get("error")
    _assert_overload(raw)
    assert out["metric"] == "tiny_overload_interactive_availability" and out["unit"] == "completed/submitted"
    assert out["value"] == raw["storm"]["interactive_availability_on"] and out["cpu_rehearsal"] is True
    ov = out["overload"]
    assert ov["gray"]["time_to_eject_s"] is None and ov["capacity"]["closed_loop_qps"] is None
    assert ov["gray"]["slow_ejections"] == raw["gray"]["slow_ejections"] >= 1
    assert raw["k1_launches"]["total"] == 0  # the CPU runs the kernel's plain version

"""The training chaos round of the port (``bench/train_chaos.py``) on the
CPU, beside the JAX package's ``scripts/train_chaos.py`` at the same tiny
config: corrupt records skipped and counted, one NaN step rolled back, a
real SIGTERM checkpointed with its marker, and a resume from the marker's
step to the end. Both print one line of the same shape with the same books;
the step the SIGTERM stops at differs by the loops' prefetch depth."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from yet_another_mobilenet_series_tpu_torch.bench import train_chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_STEP = 32  # 2 epochs of 256 / 16 steps


def _port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_chaos.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert rc == 0 and len(lines) == 1, lines
    return json.loads(lines[0])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "provenance":
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def jax_line(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_chaos") / "line.json"
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "train_chaos.py"), "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_chaos_round_on_the_cpu_matches_the_jax_script(tmp_path, jax_line):
    line = _port(["--device", "cpu", "--log-dir", str(tmp_path / "run"), "--out", str(tmp_path / "line.json")])
    assert "error" not in line and "error" not in jax_line, (line, jax_line)
    assert json.loads((tmp_path / "line.json").read_text()) == line
    # the source's shape, plus the port's cpu_rehearsal flag
    assert _keys(line) - {"cpu_rehearsal"} == _keys(jax_line)
    c, r = line["chaos"], line["resume"]
    for key in ("exit_code", "reason", "corrupt_records", "injected_corrupt", "injected_nan_steps", "skipped_steps",
                "nonfinite_events", "preemptions", "health_abort"):
        assert c[key] == jax_line["chaos"][key], key
    assert c["injected_nan_steps"] == c["skipped_steps"] == c["preemptions"] == 1 and c["reason"] == "SIGTERM"
    assert c["corrupt_records"] == c["injected_corrupt"] > 0
    # kill_at_step is counted in pulls, which lead the loop by its prefetch
    assert abs(c["killed_step"] - train_chaos.KILL_AT_STEP) <= 2, c
    assert r["resumed_step"] == c["killed_step"] and r["marker_consumed"] and r["restore_fallbacks"] == 0
    assert r["final_step"] == jax_line["resume"]["final_step"] == FINAL_STEP
    assert line["value"] == FINAL_STEP - c["killed_step"] > 0
    assert line["platform"] == "cpu" and line["provenance"]["cpu_rehearsal"] is True


def test_a_failed_round_is_a_null_value_and_exit_0(tmp_path):
    """The card on a machine without one: the chaos round's child raises,
    and the line says so."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the chaos round would run on it")
    line = _port(["--device", "cuda", "--log-dir", str(tmp_path / "run"), "--timeout-s", "120"])
    assert line["value"] is None and line["error"].startswith("RuntimeError: chaos round exited")
    assert "chaos" not in line

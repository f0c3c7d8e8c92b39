"""The port's serve bench partition arm (ROADMAP S7) held to the JAX
contract's invariants (tests/test_bench_contract.py ``_assert_partition``):
echo replicas behind the port's netchaos proxies and its router, the
blackhole, reset, half-open and flap rounds and the TTL-lease round. It
touches no device, so it runs here as it runs on the card's host, and its
line keeps its host times.
"""

from test_bench_contract import _assert_partition
from test_torch_port_overload import _line


def test_partition_arm_keeps_the_jax_contract(capsys):
    rc, out = _line(["--partition", "--partition-replicas", "2", "--partition-requests", "40",
                     "--partition-qps", "20"], capsys)
    assert rc == 0 and "error" not in out, out.get("error")
    pt = out["partition"]
    _assert_partition(pt)
    assert out["value"] == pt["rounds"]["blackhole"]["detection_s"] > 0
    assert out["platform"] == "host" and out["touches_device"] is False and pt["touches_device"] is False

"""F7: the router's gray-failure sweep in a fleet that serves two models.

``Router._slow_sweep`` holds each routable replica's per-leg latency EWMA
to a lower median and ejects a replica that stays ``slow_factor`` times
above it. In a ``small;big`` placement the big model's replica is slower
by design. The JAX package's router holds it to the median over both
replicas, strikes it and ejects it; the port's copy holds a replica only to
the replicas that advertise the same models, so a lone replica of a model
has no peer and stays. Between two replicas of one model the port still
ejects the slow one.
"""

import pytest

from yet_another_mobilenet_series_tpu.serve import router as jax_router
from yet_another_mobilenet_series_tpu_torch.serve import router as port_router

EJECT_AFTER = 3


class _Client:
    def close(self):
        pass


def _router(module, placement: dict):
    """A router over one static replica per ``placement`` entry (``key`` ->
    (advertised models, EWMA seconds)), its poll thread never started."""
    r = module.Router([key for key in placement], slow_eject=True, slow_factor=3.0, slow_eject_after=EJECT_AFTER,
                      slow_min_ms=1.0, client_factory=lambda host, port: _Client())
    r.set_backend_models({key: dict.fromkeys(models, "") for key, (models, _) in placement.items()})
    for key, (_, ewma) in placement.items():
        r._replicas[key].lat_ewma_s = ewma
    return r


def _sweeps(r, placement: dict, n: int) -> list[dict]:
    """``n`` sweeps, the EWMAs put back before each (a routable replica
    keeps serving at its latency); what each replica looked like after each."""
    seen = []
    for i in range(n):
        for key, (_, ewma) in placement.items():
            rep = r._replicas[key]
            if rep.routable and rep.lat_ewma_s is None:
                rep.lat_ewma_s = ewma
        r._slow_sweep(float(i))
        seen.append({key: (rep.routable, rep.slow_strikes) for key, rep in r._replicas.items()})
    return seen


SMALL_BIG = {"127.0.0.1:9001": (["small"], 0.001), "127.0.0.1:9002": (["big"], 0.010)}


def test_jax_router_ejects_the_big_models_replica():
    """The fault, pinned in the reference: the big replica is struck at
    every sweep and ejected at the EJECT_AFTER-th."""
    r = _router(jax_router, SMALL_BIG)
    try:
        seen = _sweeps(r, SMALL_BIG, EJECT_AFTER)
    finally:
        r.stop()
    big, small = "127.0.0.1:9002", "127.0.0.1:9001"
    assert [s[big] for s in seen[:-1]] == [(True, k) for k in range(1, EJECT_AFTER)]
    assert seen[-1][big] == (False, 0)
    assert all(s[small] == (True, 0) for s in seen)


def test_port_router_keeps_each_models_only_replica():
    r = _router(port_router, SMALL_BIG)
    try:
        seen = _sweeps(r, SMALL_BIG, 2 * EJECT_AFTER)
    finally:
        r.stop()
    assert all(state == (True, 0) for s in seen for state in s.values())


@pytest.mark.parametrize("module", [jax_router, port_router], ids=["jax", "port"])
def test_both_routers_eject_the_slow_one_of_two_peers(module):
    """Two replicas of one model, one 10x slower: both routers eject it."""
    placement = {"127.0.0.1:9001": (["big"], 0.001), "127.0.0.1:9002": (["big"], 0.010)}
    r = _router(module, placement)
    try:
        seen = _sweeps(r, placement, EJECT_AFTER)
    finally:
        r.stop()
    assert seen[-1] == {"127.0.0.1:9001": (True, 0), "127.0.0.1:9002": (False, 0)}


def test_port_router_groups_by_advertised_models():
    """Two big replicas (one slow) beside one small: the slow big one is held
    to its peer and ejected; the small one, alone in its group, is not
    compared at all. Replicas that advertise nothing are one group."""
    placement = {"127.0.0.1:9001": (["small"], 0.0005), "127.0.0.1:9002": (["big"], 0.004),
                 "127.0.0.1:9003": (["big"], 0.040)}
    r = _router(port_router, placement)
    try:
        seen = _sweeps(r, placement, EJECT_AFTER)
    finally:
        r.stop()
    assert seen[-1] == {"127.0.0.1:9001": (True, 0), "127.0.0.1:9002": (True, 0), "127.0.0.1:9003": (False, 0)}
    unadvertised = {"127.0.0.1:9001": (None, 0.001), "127.0.0.1:9002": (None, 0.010)}
    r = port_router.Router(list(unadvertised), slow_eject=True, slow_eject_after=EJECT_AFTER,
                           client_factory=lambda host, port: _Client())
    try:
        for key, (_, ewma) in unadvertised.items():
            r._replicas[key].lat_ewma_s = ewma
        seen = _sweeps(r, unadvertised, EJECT_AFTER)
    finally:
        r.stop()
    assert seen[-1]["127.0.0.1:9002"] == (False, 0)

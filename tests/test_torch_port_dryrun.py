"""The port's data-parallel dry run (``graft_entry.dryrun_multichip``), the
twin of ``__graft_entry__.dryrun_multichip``, on the CPU: two full AtomNAS
training steps of the JAX dry run's config (SyncBN, the gradient
all-reduce, the ZeRO update, EMA, the penalty, the mask refresh; the second
step under fused_vjp, conv1x1_dot and save_conv remat) over two gloo ranks,
and the refusals: more ranks than cards, and no rank at all.
"""

import pytest

import torch

from yet_another_mobilenet_series_tpu_torch import graft_entry


def test_dryrun_two_gloo_ranks():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert out["world"] == 2 and out["backend"] == "gloo" and [r["rank"] for r in out["ranks"]] == [0, 1]
    for r in out["ranks"]:
        assert r["steps"] == [1, 2] and r["finite"] == [1.0, 1.0] and r["replica_check"] == 0.0, r
        assert r["k1_launches"] == 0 and r["device"] == "cpu"
    # one all-reduced loss: every rank reads the same metrics
    assert out["ranks"][0]["loss"] == out["ranks"][1]["loss"]


def test_dryrun_config_is_the_jax_dry_runs():
    cfg = graft_entry._dryrun_config(3)
    assert cfg.model.arch == "atomnas_supernet_se" and cfg.model.num_classes == 16 and cfg.model.dropout == 0.1
    assert [b["c"] for b in cfg.model.block_specs] == [16, 24]
    assert cfg.optim.optimizer == "rmsprop" and cfg.optim.weight_decay == 1e-5
    assert (cfg.schedule.schedule, cfg.schedule.base_lr, cfg.schedule.warmup_epochs) == ("exp_decay", 0.064, 1.0)
    assert cfg.ema.enable and cfg.train.compute_dtype == "bfloat16" and cfg.train.batch_size == 6
    assert cfg.prune.enable and cfg.prune.rho == 1e-4 and cfg.dist.sync_bn and cfg.dist.shard_optimizer


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    with pytest.raises(ValueError, match="n_devices >= 1"):
        graft_entry.dryrun_multichip(0, device="cpu")
    if torch.cuda.is_available():
        n = torch.cuda.device_count() + 1
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):  # no CPU fallback
            graft_entry.dryrun_multichip(1)
        # a machine of one card, as the H100 machine is
        monkeypatch.setattr(graft_entry, "resolve_device", lambda device: torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        n = 2
    with pytest.raises(RuntimeError, match=f"needs {n} cards but only {n - 1} are visible"):
        graft_entry.dryrun_multichip(n)

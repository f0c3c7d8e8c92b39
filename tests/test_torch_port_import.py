"""The port's torchvision importer (ckpt/torch_import.py) against the JAX
package's and against the torch modules themselves, and the warm start and
eval-only run it feeds in cli/train.py, on the CPU.

The torchvision-layout modules are tests/test_torch_import.py's, built from
seeded tensors with torchvision's key names and shapes (torchvision is not
needed). The port keeps torchvision's OIHW convs; after ``convert.to_jax``
its import equals the JAX package's exactly, and its forward equals the
torch module's at the JAX test's bar (rtol 1e-4, atol 1e-5).
"""

import warnings

import numpy as np
import pytest

import jax
import torch

from test_torch_import import TorchTinyMBV3, _randomized_torch_model
from yet_another_mobilenet_series_tpu.ckpt import torch_import as jax_import
from yet_another_mobilenet_series_tpu.config import ModelConfig as JaxModelConfig
from yet_another_mobilenet_series_tpu.models import get_model as jax_get_model
from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
from yet_another_mobilenet_series_tpu_torch.ckpt import torch_import
from yet_another_mobilenet_series_tpu_torch.config import ModelConfig, parse_cli
from yet_another_mobilenet_series_tpu_torch.data import pipeline
from yet_another_mobilenet_series_tpu_torch.models import convert, get_model

V2_SPECS = ({"t": 1, "c": 16, "n": 1, "s": 1, "k": 3}, {"t": 6, "c": 24, "n": 2, "s": 2, "k": 5})
V3_SPECS = ({"t": 1, "c": 16, "n": 1, "s": 1, "k": 3, "act": "relu"},
            {"t": 4, "c": 24, "n": 1, "s": 2, "k": 5, "se": 0.25, "act": "hswish"},
            {"t": 4, "c": 24, "n": 1, "s": 1, "k": 3, "act": "hswish"})
APP = "yet_another_mobilenet_series_tpu_torch/apps/eval_mobilenet_v2.yml"


def _nets(arch, specs, num_classes, bn_eps=1e-5):
    kw = dict(arch=arch, num_classes=num_classes, dropout=0.0, block_specs=specs, bn_eps=bn_eps)
    return get_model(ModelConfig(**kw), image_size=32), jax_get_model(JaxModelConfig(**kw), image_size=32)


def _seeded_bn(tm, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) * 2 + 0.5)
            m.weight.data.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
            m.bias.data.copy_(torch.randn(m.bias.shape, generator=gen) * 0.2)
    return tm.eval()


def _v3_module(net, num_classes, seed):
    torch.manual_seed(seed)
    return _seeded_bn(TorchTinyMBV3(net, num_classes), seed)


def _x(seed, n=4):
    return np.random.RandomState(seed).normal(0, 1, (n, 32, 32, 3)).astype(np.float32)


def _module_logits(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()


@pytest.mark.parametrize("arch", ["v2", "v3"])
def test_import_matches_the_torch_forward(arch):
    if arch == "v2":
        net, _ = _nets("mobilenet_v2", V2_SPECS, 7)
        tm = _randomized_torch_model(net, 7)
        params, state = torch_import.from_torchvision_mobilenet_v2(tm.state_dict(), net)
    else:
        # the modules' BNs keep torch's eps 1e-5, so the net does too (and is warned)
        net, _ = _nets("mobilenet_v3_large", V3_SPECS, 5)
        tm = _v3_module(net, 5, 0)
        with pytest.warns(UserWarning, match="bn_eps"):
            params, state = torch_import.from_torchvision_mobilenet_v3(tm.state_dict(), net)
    x = _x(2)
    with torch.no_grad():
        ours = net.apply(params, state, torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(ours, _module_logits(tm, x), rtol=1e-4, atol=1e-5)
    # the port's layout: convs OIHW as torchvision keeps them, every leaf float32 on the CPU
    assert params["stem"]["conv"]["w"].shape == tm.features[0][0].weight.shape
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in convert.flatten_tree({"p": params, "s": state}).values())


@pytest.mark.parametrize("arch", ["v2", "v3"])
def test_import_equals_the_jax_import_after_to_jax_exactly(arch):
    if arch == "v2":
        net, jnet = _nets("mobilenet_v2", V2_SPECS, 7)
        sd = _randomized_torch_model(net, 7, seed=3).state_dict()
        mine = torch_import.from_torchvision_mobilenet_v2(sd, net)
        theirs = jax_import.from_torchvision_mobilenet_v2(sd, jnet)
    else:
        net, jnet = _nets("mobilenet_v3_large", V3_SPECS, 5, bn_eps=1e-3)
        sd = _v3_module(net, 5, 3).state_dict()
        mine = torch_import.from_torchvision_mobilenet_v3(sd, net)
        theirs = jax_import.from_torchvision_mobilenet_v3(sd, jnet)
    for ours, ref in zip(mine, theirs):
        got = convert.to_jax(ours)
        want = {"/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_import_rejects_shape_mismatch_missing_and_leftover_keys():
    net, _ = _nets("mobilenet_v2", V2_SPECS, 7)
    good = dict(_randomized_torch_model(net, 7).state_dict())
    bad = dict(good, **{"features.0.0.weight": torch.zeros(99, 3, 3, 3)})
    with pytest.raises(torch_import.CheckpointImportError, match="stem.conv"):
        torch_import.from_torchvision_mobilenet_v2(bad, net)
    bad = {k: v for k, v in good.items() if k != "classifier.1.bias"}
    with pytest.raises(torch_import.CheckpointImportError, match="missing"):
        torch_import.from_torchvision_mobilenet_v2(bad, net)
    bad = dict(good, **{"features.99.whatever": torch.zeros(1)})
    with pytest.raises(torch_import.CheckpointImportError, match="unconsumed"):
        torch_import.from_torchvision_mobilenet_v2(bad, net)
    supernet = get_model(ModelConfig(arch="mobilenet_v2", num_classes=7, dropout=0.0,
                                     block_specs=({"t": 2, "c": 8, "n": 1, "s": 1, "k": [3, 5]},)), image_size=32)
    with pytest.raises(torch_import.CheckpointImportError, match="multi-kernel"):
        torch_import.from_torchvision_mobilenet_v2(good, supernet)


def test_v3_import_warns_on_bn_eps_mismatch():
    net_default, _ = _nets("mobilenet_v3_large", V3_SPECS, 5)
    sd = _v3_module(net_default, 5, 4).state_dict()
    with pytest.warns(UserWarning, match="bn_eps"):
        torch_import.from_torchvision_mobilenet_v3(sd, net_default)
    net_match, _ = _nets("mobilenet_v3_large", V3_SPECS, 5, bn_eps=1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        torch_import.from_torchvision_mobilenet_v3(sd, net_match)


@pytest.mark.parametrize("wrap", ["raw", "state_dict", "model", "ddp"])
def test_load_torch_checkpoint_detects_the_layout_and_unwraps(tmp_path, wrap):
    v2, _ = _nets("mobilenet_v2", V2_SPECS, 7)
    v3, _ = _nets("mobilenet_v3_large", V3_SPECS, 5)
    for net, tm in ((v2, _randomized_torch_model(v2, 7, seed=2)), (v3, _v3_module(v3, 5, 2))):
        sd = tm.state_dict()
        obj = {"raw": sd, "state_dict": {"state_dict": sd}, "model": {"model": sd, "epoch": 3},
               "ddp": {"state_dict": {f"module.{k}": v for k, v in sd.items()}}}[wrap]
        path = str(tmp_path / f"{len(net.blocks)}.pth")
        torch.save(obj, path)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the V3 bn_eps warning: the modules' BNs keep eps 1e-5
            params, state = torch_import.load_torch_checkpoint(path, net)
        x = _x(1, 2)
        with torch.no_grad():
            ours = net.apply(params, state, torch.from_numpy(x), train=False).numpy()
        np.testing.assert_allclose(ours, _module_logits(tm, x), rtol=1e-4, atol=1e-5)


def _eval_cfg(tmp_path, pth, *extra):
    return parse_cli([f"app:{APP}", "data.dataset=fake", "data.image_size=32", "model.num_classes=7",
                      "data.fake_num_classes=7",
                      "model.block_specs=[{t: 1, c: 16, n: 1, s: 1, k: 3}, {t: 6, c: 24, n: 2, s: 2, k: 5}]",
                      "model.dropout=0.0", "data.fake_eval_size=12", "train.eval_batch_size=5",
                      f"train.torch_pretrained={pth}", f"train.log_dir={tmp_path / 'log'}", *extra])


def test_eval_only_run_of_a_torchvision_checkpoint_is_the_imported_forward(tmp_path):
    """apps/eval_mobilenet_v2.yml (test_only) with train.torch_pretrained: the
    run's eval loss and top-1 are those of the torch module's own logits on
    the same fake eval images, and the run writes no checkpoint."""
    net, _ = _nets("mobilenet_v2", V2_SPECS, 7)
    tm = _randomized_torch_model(net, 7, seed=5)
    pth = str(tmp_path / "tv.pth")
    torch.save(tm.state_dict(), pth)
    cfg = _eval_cfg(tmp_path, pth)
    summary, ts, rnet = train_cli.train(cfg, device="cpu")
    assert summary["test_only"] is True and summary["step"] == 0 and rnet == net
    fake = pipeline.FakeImages(cfg.data, device="cpu")
    logits, labels = [], []
    for b in fake.eval_batches(cfg.train.eval_batch_size):
        keep = b["label"] >= 0
        logits.append(_module_logits(tm, b["image"][keep].numpy()))
        labels.append(b["label"][keep].long())
    logits, labels = torch.from_numpy(np.concatenate(logits)), torch.cat(labels)
    loss = float(torch.nn.functional.cross_entropy(logits, labels))
    top1 = int((logits.argmax(-1) == labels).sum()) / len(labels)
    assert summary["eval_n"] == 12
    assert summary["eval_loss"] == pytest.approx(loss, rel=1e-5)
    assert summary["eval_top1"] == top1
    assert not (tmp_path / "log" / "ckpt").exists()


def test_warm_start_from_a_torchvision_checkpoint_trains_from_its_weights(tmp_path):
    """train.torch_pretrained on a training run: step 0's weights are the
    import, the EMA shadow a copy of them, the optimizer fresh."""
    net, _ = _nets("mobilenet_v2", V2_SPECS, 7)
    tm = _randomized_torch_model(net, 7, seed=6)
    pth = str(tmp_path / "tv.pth")
    torch.save({"model": tm.state_dict()}, pth)
    cfg = _eval_cfg(tmp_path, pth, "train.test_only=false", "train.batch_size=4", "data.fake_train_size=8",
                    "train.epochs=0.5", "train.compute_dtype=float32", "schedule.warmup_epochs=0")
    params, _ = torch_import.load_torch_checkpoint(pth, net)
    trainer, ts0 = train_cli._init_or_warm_start(cfg, net, torch.device("cpu"), train_cli.Logger(enabled=False))
    flat, ema = convert.flatten_tree(ts0.params), convert.flatten_tree(ts0.ema_params)
    for k, v in convert.flatten_tree(params).items():
        assert torch.equal(flat[k], v) and torch.equal(ema[k], v) and ema[k] is not flat[k]
    assert int(ts0.step) == 0 and int(ts0.opt_state["count"]) == 0
    out = train_cli.run(cfg, device="cpu")
    assert out["steps"] == 1 and out["finite_steps"] == 1 and out["resumed_from"] is None

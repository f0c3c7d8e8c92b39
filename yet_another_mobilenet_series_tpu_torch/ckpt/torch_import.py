"""torchvision-layout MobileNet ``state_dict`` -> the port's ``(params,
state)`` trees: the torch twin of
``yet_another_mobilenet_series_tpu/ckpt/torch_import.py`` (SURVEY.md §3.3,
acceptance config #1: eval a pretrained MobileNetV2).

The same keys are read and the same checks made (strict consumption: every
model leaf filled, every checkpoint tensor used but ``num_batches_tracked``;
each shape held against the network's; :class:`CheckpointImportError`
otherwise), but the result is in the port's layout, so a conv weight stays
OIHW as torchvision stores it; only a Linear's (out, in) weight turns into
the port's (in, out) Dense, and an SE 1x1 conv's (out, in, 1, 1) weight
into one too. Every tensor comes back float32, on the CPU. Layout:

    features.0.0 / 0.1                   stem conv / BN
    features.i.conv.0.0 / 0.1            expand conv / BN       (V2, t > 1)
    features.i.conv.{1,0}.0 / .1         depthwise conv / BN    (V2)
    features.i.conv.{2,3} (or {1,2})     project conv / BN      (V2)
    features.i.block.j.*                 expand / depthwise / SE fc1, fc2 / project (V3)
    features.{n+1}.0 / .1                head conv / BN
    classifier.1                         classifier Linear (V2)
    classifier.0 / classifier.3          feature / classifier Linears (V3)
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping

import torch

from ..models.specs import Network


class CheckpointImportError(ValueError):
    pass


def _f32(t) -> torch.Tensor:
    """A float32 CPU copy that owns its memory."""
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _dense(t) -> torch.Tensor:
    """A Linear's (out, in) weight, or a 1x1 conv's (out, in, 1, 1), as the
    port's (in, out) Dense weight."""
    t = _f32(t)
    return (t[:, :, 0, 0] if t.dim() == 4 else t).t().contiguous()


class _SD:
    """state_dict view that tracks consumption so leftovers are an error."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def take(self, key: str):
        if key not in self.sd:
            raise CheckpointImportError(f"missing key {key!r} in state_dict")
        self.used.add(key)
        return self.sd[key]

    def bn(self, prefix: str) -> tuple[dict, dict]:
        p = {"gamma": _f32(self.take(f"{prefix}.weight")), "beta": _f32(self.take(f"{prefix}.bias"))}
        s = {"mean": _f32(self.take(f"{prefix}.running_mean")), "var": _f32(self.take(f"{prefix}.running_var"))}
        self.used.add(f"{prefix}.num_batches_tracked")  # present in torch, meaningless here
        return p, s

    def leftovers(self) -> list[str]:
        return [k for k in self.sd if k not in self.used]


def _check(name: str, got: torch.Tensor, want_shape: tuple[int, ...]) -> torch.Tensor:
    if tuple(got.shape) != tuple(want_shape):
        raise CheckpointImportError(f"{name}: checkpoint shape {tuple(got.shape)} != model shape {tuple(want_shape)}")
    return got


def _stem(sd: _SD, net: Network, params: dict, state: dict) -> None:
    k = net.stem.kernel_size
    w = _f32(sd.take("features.0.0.weight"))
    params["stem"] = {"conv": {"w": _check("stem.conv", w, (net.stem.out_channels, 3, k, k))}}
    params["stem"]["bn"], bn_s = sd.bn("features.0.1")
    state["stem"] = {"bn": bn_s}


def _head(sd: _SD, net: Network, params: dict, state: dict) -> None:
    hi = len(net.blocks) + 1
    w = _f32(sd.take(f"features.{hi}.0.weight"))
    params["head"] = {"conv": {"w": _check("head.conv", w, (net.head.out_channels, net.head.in_channels, 1, 1))}}
    params["head"]["bn"], bn_s = sd.bn(f"features.{hi}.1")
    state["head"] = {"bn": bn_s}


def _finish(sd: _SD) -> None:
    left = sd.leftovers()
    if left:
        raise CheckpointImportError(f"unconsumed checkpoint tensors: {left[:8]}{'...' if len(left) > 8 else ''}")


def _single_kernel(i: int, blk) -> int:
    if len(blk.kernel_sizes) != 1:
        raise CheckpointImportError(f"block {i}: multi-kernel supernet blocks are not a torchvision layout")
    return blk.kernel_sizes[0]


def from_torchvision_mobilenet_v2(state_dict: Mapping[str, Any], net: Network) -> tuple[dict, dict]:
    """Returns (params, state) for ``net`` from a torchvision-MobileNetV2-
    layout state_dict. Strict: every model leaf must be filled and every
    checkpoint tensor consumed (except ``num_batches_tracked``)."""
    sd = _SD(state_dict)
    params: dict = {}
    state: dict = {}
    _stem(sd, net, params, state)
    bp: dict = {}
    bs: dict = {}
    for i, blk in enumerate(net.blocks):  # our blocks[i] == torchvision features[i+1]
        f = f"features.{i + 1}.conv"
        kd = _single_kernel(i, blk)
        e = blk.expanded_channels
        p: dict = {}
        s: dict = {}
        if blk.has_expand:
            p["expand"] = {"w": _check(f"block{i}.expand", _f32(sd.take(f"{f}.0.0.weight")),
                                       (e, blk.in_channels, 1, 1))}
            p["expand_bn"], s["expand_bn"] = sd.bn(f"{f}.0.1")
            dw, proj = f"{f}.1", 2
        else:
            dw, proj = f"{f}.0", 1
        p[f"dw0_k{kd}"] = {"w": _check(f"block{i}.dw", _f32(sd.take(f"{dw}.0.weight")), (e, 1, kd, kd))}
        p["dw_bn"], s["dw_bn"] = sd.bn(f"{dw}.1")
        p["project"] = {"w": _check(f"block{i}.project", _f32(sd.take(f"{f}.{proj}.weight")),
                                    (blk.out_channels, e, 1, 1))}
        p["project_bn"], s["project_bn"] = sd.bn(f"{f}.{proj + 1}")
        bp[str(i)], bs[str(i)] = p, s
    params["blocks"], state["blocks"] = bp, bs
    if net.head is None:
        raise CheckpointImportError("MobileNetV2 layout requires a head conv")
    _head(sd, net, params, state)
    # classifier = Sequential(Dropout, Linear)
    params["classifier"] = {
        "w": _check("classifier.w", _dense(sd.take("classifier.1.weight")),
                    (net.classifier.in_features, net.classifier.out_features)),
        "b": _check("classifier.b", _f32(sd.take("classifier.1.bias")), (net.classifier.out_features,)),
    }
    _finish(sd)
    return params, state


def from_torchvision_mobilenet_v3(state_dict: Mapping[str, Any], net: Network) -> tuple[dict, dict]:
    """torchvision MobileNetV3 layout: blocks under ``features.{i+1}.block.{j}``
    (expand / depthwise / SqueezeExcitation / project, SE as 1x1 convs
    fc1/fc2 WITH bias), the head conv at ``features.{n+1}``, and the
    classifier as ``classifier.0`` (the 1280-wide feature Linear) +
    ``classifier.3``.

    torchvision V3 BatchNorms use eps=1e-3: build the target net with
    ``model.bn_eps=1e-3`` or evals drift (warned, since the CLI user never
    sees this docstring)."""
    if abs(net.stem.bn_eps - 1e-3) > 1e-12:
        warnings.warn(
            f"importing a torchvision-V3-layout checkpoint into a net with bn_eps={net.stem.bn_eps} "
            "— torchvision MobileNetV3 uses bn_eps=1e-3; set model.bn_eps=1e-3 or top-1 will drift",
            stacklevel=2,
        )
    sd = _SD(state_dict)
    params: dict = {}
    state: dict = {}
    _stem(sd, net, params, state)
    bp: dict = {}
    bs: dict = {}
    for i, blk in enumerate(net.blocks):
        f = f"features.{i + 1}.block"
        kd = _single_kernel(i, blk)
        e = blk.expanded_channels
        p: dict = {}
        s: dict = {}
        j = 0
        if blk.has_expand:
            p["expand"] = {"w": _check(f"block{i}.expand", _f32(sd.take(f"{f}.{j}.0.weight")),
                                       (e, blk.in_channels, 1, 1))}
            p["expand_bn"], s["expand_bn"] = sd.bn(f"{f}.{j}.1")
            j += 1
        p[f"dw0_k{kd}"] = {"w": _check(f"block{i}.dw", _f32(sd.take(f"{f}.{j}.0.weight")), (e, 1, kd, kd))}
        p["dw_bn"], s["dw_bn"] = sd.bn(f"{f}.{j}.1")
        j += 1
        if blk.se_channels:
            se = blk.se_channels
            p["se"] = {
                "reduce": {"w": _check(f"block{i}.se.fc1", _dense(sd.take(f"{f}.{j}.fc1.weight")), (e, se)),
                           "b": _f32(sd.take(f"{f}.{j}.fc1.bias"))},
                "expand": {"w": _check(f"block{i}.se.fc2", _dense(sd.take(f"{f}.{j}.fc2.weight")), (se, e)),
                           "b": _f32(sd.take(f"{f}.{j}.fc2.bias"))},
            }
            j += 1
        p["project"] = {"w": _check(f"block{i}.project", _f32(sd.take(f"{f}.{j}.0.weight")),
                                    (blk.out_channels, e, 1, 1))}
        p["project_bn"], s["project_bn"] = sd.bn(f"{f}.{j}.1")
        bp[str(i)], bs[str(i)] = p, s
    params["blocks"], state["blocks"] = bp, bs
    if net.head is None or net.feature is None:
        raise CheckpointImportError("MobileNetV3 layout requires head conv + feature Linear")
    _head(sd, net, params, state)
    params["feature"] = {
        "w": _check("feature.w", _dense(sd.take("classifier.0.weight")),
                    (net.feature.in_features, net.feature.out_features)),
        "b": _check("feature.b", _f32(sd.take("classifier.0.bias")), (net.feature.out_features,)),
    }
    params["classifier"] = {
        "w": _check("classifier.w", _dense(sd.take("classifier.3.weight")),
                    (net.classifier.in_features, net.classifier.out_features)),
        "b": _check("classifier.b", _f32(sd.take("classifier.3.bias")), (net.classifier.out_features,)),
    }
    _finish(sd)
    return params, state


def load_torch_checkpoint(path: str, net: Network) -> tuple[dict, dict]:
    """Loads a .pth/.pt file (a raw state_dict or a dict holding one under
    'state_dict'/'model'/'model_state') and imports it into ``net``'s tree
    layout. The torchvision layout (V2 ``.conv.`` vs V3 ``.block.``) is
    auto-detected; DistributedDataParallel's ``module.`` prefix is dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(hasattr(v, "shape") for v in obj.values()):
        for key in ("state_dict", "model", "model_state"):
            if key in obj:
                obj = obj[key]
                break
    obj = {k.removeprefix("module."): v for k, v in obj.items()}
    if any(".block." in k for k in obj):
        return from_torchvision_mobilenet_v3(obj, net)
    return from_torchvision_mobilenet_v2(obj, net)

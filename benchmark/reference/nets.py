"""Plain PyTorch MobileNetV3-Large and EfficientNet-B0, written from their papers' tables.

- MobileNetV3-Large 1.0: Howard et al., "Searching for MobileNetV3", arXiv:1905.02244, Table 1.
- EfficientNet-B0 1.0: Tan and Le, arXiv:1905.11946, Table 1, with the MBConv block of MnasNet
  (arXiv:1807.11626): expand 1x1, depthwise kxk, squeeze-and-excitation, project 1x1.

This module imports torch alone. It holds the eval forward (BN from the running statistics) and
the train forward (BN from the batch statistics, running statistics updated with the unbiased
variance, torch's momentum convention), in float32 NCHW, with no fused kernel, no folding, no
cache and no batching. Parameters are a flat dict of '/'-joined names (``blocks/3/dw0_k5/w``);
the benchmark draws one such dict from the seed and hands it to both sides.

Departures from the papers, each what the configuration runs:

- every convolution pads symmetrically by k//2 (TF's 'SAME' pads only bottom and right at
  stride 2);
- MobileNetV3's squeeze width is a quarter of the expanded width rounded to a multiple of 8
  (``make_divisible``, as the authors' released code rounds it); the paper says a quarter;
- EfficientNet-B0's squeeze width is a quarter of the block's input width, with swish between
  the two FCs and a sigmoid gate (the released code; the paper's table names only "SE");
- BN momentum and eps are the configuration's, in torch's convention;
- drop-connect (EfficientNet's stochastic depth) keeps whole residual branches per sample with
  probability 1 - 0.2 i / 16 for block i, as the released code does; dropout acts on the pooled
  features before the classifier;
- the weights are drawn, not trained.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


def make_divisible(v: float, divisor: int = 8) -> int:
    """The MobileNet family's channel rounding: to the nearest multiple of ``divisor``, never
    below ``divisor`` and never more than 10% under ``v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def swish(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {"relu": F.relu, "hswish": hswish, "hsigmoid": hsigmoid, "swish": swish, "sigmoid": torch.sigmoid}


@dataclass(frozen=True)
class Block:
    """One inverted-residual block: ``cin`` -> ``exp`` (1x1) -> depthwise ``k`` at ``stride``
    -> SE of ``se`` squeeze channels (0: none) -> ``cout`` (1x1, linear)."""

    cin: int
    exp: int
    cout: int
    k: int
    stride: int
    act: str
    se: int
    drop: float = 0.0

    @property
    def expand(self) -> bool:
        return self.exp != self.cin

    @property
    def residual(self) -> bool:
        return self.stride == 1 and self.cin == self.cout


@dataclass(frozen=True)
class Arch:
    name: str
    stem: int
    stem_act: str
    blocks: tuple[Block, ...]
    head: int
    head_act: str
    feature: int  # 0: the classifier reads the pooled head directly
    feature_act: str
    se_inner: str
    se_gate: str
    num_classes: int
    dropout: float
    bn_eps: float
    bn_momentum: float

    @property
    def pooled(self) -> int:
        """Width of what dropout and the classifier read."""
        return self.feature or self.head


# MobileNetV3-Large, Table 1: (kernel, exp size, #out, SE, NL, stride) of each bneck row
_MBV3_LARGE = (
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
)

# EfficientNet-B0, Table 1 stages 2-8: (expansion, kernel, channels, layers, stride)
_EFFICIENTNET_B0 = (
    (1, 3, 16, 1, 1),
    (6, 3, 24, 2, 2),
    (6, 5, 40, 2, 2),
    (6, 3, 80, 3, 2),
    (6, 5, 112, 3, 1),
    (6, 5, 192, 4, 2),
    (6, 3, 320, 1, 1),
)


def mobilenet_v3_large(*, num_classes: int = 1000, dropout: float = 0.2, bn_eps: float = 1e-5,
                       bn_momentum: float = 0.1) -> Arch:
    blocks, cin = [], 16
    for k, exp, out, se, act, s in _MBV3_LARGE:
        blocks.append(Block(cin, exp, out, k, s, act, make_divisible(exp / 4) if se else 0))
        cin = out
    return Arch("mobilenet_v3_large", 16, "hswish", tuple(blocks), 960, "hswish", 1280, "hswish", "relu",
                "hsigmoid", num_classes, dropout, bn_eps, bn_momentum)


def efficientnet_b0(*, num_classes: int = 1000, dropout: float = 0.2, bn_eps: float = 1e-3,
                    bn_momentum: float = 0.01, drop_connect: float = 0.2) -> Arch:
    total = sum(n for _, _, _, n, _ in _EFFICIENTNET_B0)
    blocks, cin = [], 32
    for t, k, c, n, s in _EFFICIENTNET_B0:
        for j in range(n):
            i = len(blocks)
            blocks.append(Block(cin, cin * t, c, k, s if j == 0 else 1, "swish", max(1, int(cin * 0.25)),
                                drop_connect * i / total))
            cin = c
    return Arch("efficientnet_b0", 32, "swish", tuple(blocks), 1280, "swish", 0, "swish", "swish", "sigmoid",
                num_classes, dropout, bn_eps, bn_momentum)


ARCHS = {"mobilenet_v3_large": mobilenet_v3_large, "efficientnet_b0": efficientnet_b0}


def from_config(model: dict) -> Arch:
    """The reference's Arch for a configuration file's ``model`` section (width 1.0 only)."""
    if model.get("width_mult", 1.0) != 1.0:
        raise ValueError("the reference holds the papers' 1.0 widths only")
    kw = {k: model[k] for k in ("num_classes", "dropout", "bn_eps", "bn_momentum", "drop_connect") if k in model}
    return ARCHS[model["arch"]](**kw)


def param_shapes(arch: Arch) -> dict[str, tuple[int, ...]]:
    """Every trainable parameter's name and shape: conv weights (out, in/groups, k, k), dense
    weights (in, out), BN ``gamma``/``beta``, biases ``b``."""
    shapes: dict[str, tuple[int, ...]] = {}

    def conv(name, cin, cout, k, groups=1):
        shapes[f"{name}/w"] = (cout, cin // groups, k, k)

    def bn(name, c):
        shapes[f"{name}/gamma"] = (c,)
        shapes[f"{name}/beta"] = (c,)

    def dense(name, cin, cout):
        shapes[f"{name}/w"] = (cin, cout)
        shapes[f"{name}/b"] = (cout,)

    conv("stem/conv", 3, arch.stem, 3)
    bn("stem/bn", arch.stem)
    for i, b in enumerate(arch.blocks):
        p = f"blocks/{i}"
        if b.expand:
            conv(f"{p}/expand", b.cin, b.exp, 1)
            bn(f"{p}/expand_bn", b.exp)
        conv(f"{p}/dw0_k{b.k}", b.exp, b.exp, b.k, b.exp)
        bn(f"{p}/dw_bn", b.exp)
        if b.se:
            dense(f"{p}/se/reduce", b.exp, b.se)
            dense(f"{p}/se/expand", b.se, b.exp)
        conv(f"{p}/project", b.exp, b.cout, 1)
        bn(f"{p}/project_bn", b.cout)
    conv("head/conv", arch.blocks[-1].cout, arch.head, 1)
    bn("head/bn", arch.head)
    if arch.feature:
        dense("feature", arch.head, arch.feature)
    dense("classifier", arch.pooled, arch.num_classes)
    return shapes


def bn_names(arch: Arch) -> list[str]:
    """Every BN's name, in forward order; its running statistics are ``<name>/mean``, ``/var``."""
    names = ["stem/bn"]
    for i, b in enumerate(arch.blocks):
        names += ([f"blocks/{i}/expand_bn"] if b.expand else []) + [f"blocks/{i}/dw_bn", f"blocks/{i}/project_bn"]
    return names + ["head/bn"]


class Ops:
    """What the convolutions and dense layers compute with: plain float32. The control of the
    benchmark's comparison swaps in a lower precision (``lowp.py``)."""

    def conv(self, x, w, stride: int, groups: int):
        return F.conv2d(x, w, None, stride, w.shape[-1] // 2, 1, groups)

    def linear(self, x, w, b):
        return x @ w + b


PLAIN = Ops()


def _bn_eval(x, p, s, name, eps):
    mean, var = s[f"{name}/mean"], s[f"{name}/var"]
    inv = torch.rsqrt(var + eps) * p[f"{name}/gamma"]
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + p[f"{name}/beta"][None, :, None, None]


def _bn_train(x, p, s, name, eps, momentum, new_state):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    y = (x - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None]
    y = y * p[f"{name}/gamma"][None, :, None, None] + p[f"{name}/beta"][None, :, None, None]
    new_state[f"{name}/mean"] = (1 - momentum) * s[f"{name}/mean"] + momentum * mean.detach()
    new_state[f"{name}/var"] = (1 - momentum) * s[f"{name}/var"] + momentum * var.detach() * (n / (n - 1))
    return y


def _block(arch: Arch, i: int, b: Block, p, s, h, train: bool, keep, ops: Ops, new_state):
    act = ACTIVATIONS[b.act]
    pre = f"blocks/{i}"

    def bn(name, x):
        if train:
            return _bn_train(x, p, s, f"{pre}/{name}", arch.bn_eps, arch.bn_momentum, new_state)
        return _bn_eval(x, p, s, f"{pre}/{name}", arch.bn_eps)

    x = h
    if b.expand:
        h = act(bn("expand_bn", ops.conv(h, p[f"{pre}/expand/w"], 1, 1)))
    h = act(bn("dw_bn", ops.conv(h, p[f"{pre}/dw0_k{b.k}/w"], b.stride, b.exp)))
    if b.se:
        z = h.mean(dim=(2, 3))
        z = ACTIVATIONS[arch.se_inner](ops.linear(z, p[f"{pre}/se/reduce/w"], p[f"{pre}/se/reduce/b"]))
        z = ACTIVATIONS[arch.se_gate](ops.linear(z, p[f"{pre}/se/expand/w"], p[f"{pre}/se/expand/b"]))
        h = h * z[:, :, None, None]
    h = bn("project_bn", ops.conv(h, p[f"{pre}/project/w"], 1, 1))
    if b.residual:
        if train and b.drop > 0 and keep is not None:
            h = h * (keep.float() / (1.0 - b.drop))[:, None, None, None]
        h = h + x
    return h


def forward(arch: Arch, p: dict, s: dict, x_nhwc: torch.Tensor, *, train: bool = False, noise: dict | None = None,
            ops: Ops = PLAIN, checkpoint: bool = False):
    """(N, H, W, 3) images -> (N, classes) logits (eval), or ``(logits, new running
    statistics)`` (train). ``noise`` holds the train forward's draws: ``{"drop_path": {block:
    (N,) bool keep}, "dropout": (N, pooled) bool keep}``. ``checkpoint`` recomputes each block
    in the backward, so a full batch fits beside nothing else."""
    noise = noise or {"drop_path": {}}
    new_state: dict = {}

    def bn(name, x, act):
        y = (_bn_train(x, p, s, name, arch.bn_eps, arch.bn_momentum, new_state) if train
             else _bn_eval(x, p, s, name, arch.bn_eps))
        return ACTIVATIONS[act](y)

    h = x_nhwc.float().permute(0, 3, 1, 2).contiguous()
    h = bn("stem/bn", ops.conv(h, p["stem/conv/w"], 2, 1), arch.stem_act)
    for i, b in enumerate(arch.blocks):
        keep = noise["drop_path"].get(i)
        if train and checkpoint:
            def body(h, i=i, b=b, keep=keep, keys=tuple(_state_names(arch, i))):
                out: dict = {}
                y = _block(arch, i, b, p, s, h, True, keep, ops, out)
                return (y, *[out[k] for k in keys])

            outs = torch.utils.checkpoint.checkpoint(body, h, use_reentrant=False)
            h = outs[0]
            new_state.update(zip(_state_names(arch, i), outs[1:]))
        else:
            h = _block(arch, i, b, p, s, h, train, keep, ops, new_state)
    h = bn("head/bn", ops.conv(h, p["head/conv/w"], 1, 1), arch.head_act)
    h = h.mean(dim=(2, 3))
    if arch.feature:
        h = ACTIVATIONS[arch.feature_act](ops.linear(h, p["feature/w"], p["feature/b"]))
    if train and arch.dropout:
        h = torch.where(noise["dropout"], h / (1.0 - arch.dropout), torch.zeros((), device=h.device))
    logits = ops.linear(h, p["classifier/w"], p["classifier/b"])
    return (logits, new_state) if train else logits


def _state_names(arch: Arch, i: int) -> list[str]:
    b = arch.blocks[i]
    names = ([f"blocks/{i}/expand_bn"] if b.expand else []) + [f"blocks/{i}/dw_bn", f"blocks/{i}/project_bn"]
    return [f"{n}/{k}" for n in names for k in ("mean", "var")]


def draw_noise(arch: Arch, generator: torch.Generator, batch: int, device) -> dict:
    """One train forward's random draws, in the order the step makes them: a (batch,) uniform
    draw for every residual block with a drop-connect rate, in block order, then a (batch,
    pooled) draw for dropout; each kept where it is under the keep probability."""
    noise: dict = {"drop_path": {}}
    for i, b in enumerate(arch.blocks):
        if b.drop > 0 and b.residual:
            noise["drop_path"][i] = torch.rand(batch, generator=generator, device=device) < 1.0 - b.drop
    if arch.dropout:
        noise["dropout"] = torch.rand((batch, arch.pooled), generator=generator, device=device) < 1.0 - arch.dropout
    return noise


def smoothed_cross_entropy(logits, labels, smoothing: float):
    """Mean over the batch of -sum(target * log softmax), target = (1 - e) onehot + e / K."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return ((1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)).mean()


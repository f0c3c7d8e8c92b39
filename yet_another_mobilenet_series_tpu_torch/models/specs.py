"""Block-spec grammar: the torch twin of ``yet_another_mobilenet_series_tpu/models/specs.py``.

``ArchDef``, ``build_network`` and the spec grammar are the JAX package's,
unchanged; ``Network.init`` draws from a ``torch.Generator`` and
``Network.apply`` is the eval forward (``train=False``, logits) or the
training forward (``train=True``, ``(logits, new_state)``) on tensors.

Reference behavior (SURVEY.md §2 #4-5, §3.4): every model — including searched
AtomNAS results — is a list of stage specs (t/exp, c, n, s, k, act, SE) plus
stem/head widths, scaled by a width multiplier with ``make_divisible`` channel
rounding. This module turns such a list into a concrete ``Network`` of ops
specs; it is the "single most important behavioral contract" called out in
SURVEY.md §3.4.

Spec dict keys (one dict per *stage*, expanded to ``n`` blocks):

- ``block``: 'mbconv' (default) | 'ds' (depthwise-separable, V1/MNASNet stem)
- ``t``: expansion ratio (hidden = make_divisible(c_in * t)), OR
  ``exp``: absolute expanded width pre-width-mult (MobileNetV3 tables give
  these explicitly and they are NOT exact multiples of the input width)
- ``c``: output channels pre-width-mult; ``n``: repeats; ``s``: stride of the
  first block in the stage
- ``k``: kernel size or list of kernel sizes — a list splits the expanded
  channels into equal atomic groups per kernel (AtomNAS supernet)
- ``act``: activation name (defaults to the model-wide ``active_fn``)
- ``se``: squeeze-excite ratio, 0 = off
- ``se_mode``: 'expand' (MobileNetV3: se = make_divisible(ratio * expanded))
  or 'input' (MNASNet: se = max(1, int(ratio * c_in)))
- ``se_gate``: gate activation ('hsigmoid' V3-style, 'sigmoid' MNAS-style)
- ``se_inner``: activation between the SE reduce/expand FCs ('relu' V3/MNAS
  convention; 'swish' for EfficientNet-family specs)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

from ..ops.activations import get_activation
from ..ops.blocks import ConvBNAct, InvertedResidual
from ..ops.layers import Dense, dropout, global_avg_pool, make_divisible


@dataclass(frozen=True)
class ArchDef:
    """A named architecture: stem/stages/head pre-width-mult."""

    stem_channels: int
    block_specs: tuple[Mapping[str, Any], ...]
    head_channels: int  # 0 = classifier directly on last block output
    feature_channels: int = 0  # V3's post-pool FC width (0 = none)
    stem_act: str = "relu6"
    head_act: str = "relu6"
    feature_act: str = "hswish"
    default_act: str = "relu6"
    default_se_mode: str = "expand"
    default_se_gate: str = "hsigmoid"
    default_se_inner: str = "relu"
    # Stochastic-depth max rate (EfficientNet drop_connect, 0 = off). Per
    # block the rate ramps linearly with depth: rate_i = drop_connect * i / n
    # over the n MBConv blocks (the official EfficientNet schedule; the first
    # block is never dropped).
    drop_connect: float = 0.0
    # MBV2/V3 convention: head width does not shrink below its 1.0x value.
    head_scales_down: bool = False


@dataclass(frozen=True)
class Network:
    """A fully-resolved model: static spec tree with init/apply.

    Block params live under ``blocks/<i>``; masks (AtomNAS) are a dict
    ``{block_index: (expanded,) array}`` applied inside each block.
    """

    stem: ConvBNAct
    blocks: tuple[InvertedResidual, ...]
    head: ConvBNAct | None
    feature: Dense | None
    feature_act: str
    classifier: Dense
    dropout: float = 0.0
    image_size: int = 224  # nominal profiling resolution

    def init(self, gen: torch.Generator):
        """Seeded parameters and BN state, in the port's layouts (OIHW
        convs, (in, out) dense), keyed like the JAX package's trees."""
        params: dict = {}
        state: dict = {}
        params["stem"], state["stem"] = self.stem.init(gen)
        bp, bs = {}, {}
        for i, blk in enumerate(self.blocks):
            bp[str(i)], bs[str(i)] = blk.init(gen)
        params["blocks"], state["blocks"] = bp, bs
        if self.head is not None:
            params["head"], state["head"] = self.head.init(gen)
        if self.feature is not None:
            params["feature"] = self.feature.init(gen)
        params["classifier"] = self.classifier.init(gen)
        return params, state

    def draw_noise(self, generator: torch.Generator, batch: int, device) -> dict:
        """The random draws of one training forward: a per-sample keep
        (N,) bool for every block with a drop-path rate, then the
        classifier dropout's keep mask. ``generator`` lives on ``device``.
        Drawn before the forward, so a recomputing (checkpointed) forward
        reuses them."""
        noise: dict = {"drop_path": {}}
        for i, blk in enumerate(self.blocks):
            if blk.drop_path > 0 and blk.has_residual:
                noise["drop_path"][i] = torch.rand(batch, generator=generator, device=device) < 1.0 - blk.drop_path
        if self.dropout:
            noise["dropout"] = torch.rand((batch, self.classifier.in_features), generator=generator,
                                          device=device) < 1.0 - self.dropout
        return noise

    def apply(self, params, state, x, *, train: bool = False, compute_dtype=None,
              masks: Mapping[int, Any] | None = None, generator: torch.Generator | None = None,
              noise: dict | None = None, bn_mode: str = "exact", conv1x1_dot: bool = False, group=None):
        """x (N, H, W, 3) NHWC -> (N, num_classes) float32 logits.

        Eval (``train=False``) normalizes with the running statistics and
        returns the logits. Training normalizes with the batch statistics
        in ``bn_mode`` and returns ``(logits, new_state)``; its drop-path
        and dropout draws come from ``noise`` (:meth:`draw_noise`'s layout,
        which is how a test injects the JAX package's masks) or are drawn
        from ``generator``. With neither, no block drops its path, as in
        the JAX package without an rng, and a net with dropout is refused.
        ``group`` (training only) is SyncBN's process group, the JAX
        package's ``axis_name``."""
        compute_dtype = compute_dtype or torch.float32
        if train and noise is None:
            if generator is not None:
                noise = self.draw_noise(generator, x.shape[0], x.device)
            elif self.dropout:
                raise ValueError("a training forward with dropout needs a generator (or noise)")
            else:
                noise = {"drop_path": {}}
        kw = {"train": train, "compute_dtype": compute_dtype, "bn_mode": bn_mode}
        if train:
            kw["group"] = group
        new_state: dict = {}

        def run(spec, name, p, s, h, **extra):
            if not train:
                return spec.apply(p, s, h, **kw, **extra)
            h, new_state[name] = spec.apply(p, s, h, **kw, **extra)
            return h

        # NHWC in memory == NCHW in channels_last: a view, no copy
        h = x.permute(0, 3, 1, 2)
        h = run(self.stem, "stem", params["stem"], state["stem"], h)
        nbs: dict = {}
        for i, blk in enumerate(self.blocks):
            mask = None if masks is None else masks.get(i)
            extra = {"mask": mask, "conv1x1_dot": conv1x1_dot}
            if train:
                extra["keep"] = noise["drop_path"].get(i)
                h, nbs[str(i)] = blk.apply(params["blocks"][str(i)], state["blocks"][str(i)], h, **kw, **extra)
            else:
                h = blk.apply(params["blocks"][str(i)], state["blocks"][str(i)], h, **kw, **extra)
        if train:
            new_state["blocks"] = nbs
        if self.head is not None:
            h = run(self.head, "head", params["head"], state["head"], h, conv1x1_dot=conv1x1_dot)
        h = global_avg_pool(h)  # (N, C)
        if self.feature is not None:
            h = self.feature.apply(params["feature"], h, compute_dtype=compute_dtype)
            h = get_activation(self.feature_act)(h)
        if train and self.dropout:
            h = dropout(h, self.dropout, True, keep=noise["dropout"])
        logits = self.classifier.apply(params["classifier"], h.float())
        return (logits, new_state) if train else logits


def random_bn_state(net: Network, gen: torch.Generator) -> dict:
    """BN running statistics drawn from ``gen`` at the scale a trained
    network's would have, for nets with seeded weights (there are no
    pretrained weights in the repository). A fresh state (mean 0, var 1)
    under kaiming fan_out weights shrinks every depthwise output by about
    sqrt(C/2), so a deep eval forward collapses to logits near 0 and any
    comparison of two forwards passes trivially. Here each BN's variance is
    its conv's expected output variance for inputs of unit second moment,
    ``2 * (in/groups) / out``, times U(0.5, 1.5), and its mean is N(0, 0.1) in
    units of that spread, so activations stay of order one through the
    depth."""

    def draw(c: int, var_scale: float) -> dict:
        var = var_scale * (0.5 + torch.rand(c, generator=gen))
        mean = 0.1 * torch.randn(c, generator=gen) * var.sqrt()
        return {"mean": mean, "var": var}

    def conv_state(in_per_group: int, out: int, c: int) -> dict:
        return draw(c, 2.0 * in_per_group / out)

    state: dict = {"stem": {"bn": conv_state(net.stem.in_channels // net.stem.groups,
                                             net.stem.out_channels, net.stem.out_channels)}}
    blocks = {}
    for i, b in enumerate(net.blocks):
        s = {}
        if b.has_expand:
            s["expand_bn"] = conv_state(b.in_channels, b.expanded_channels, b.expanded_channels)
        s["dw_bn"] = conv_state(1, b.expanded_channels, b.expanded_channels)
        s["project_bn"] = conv_state(b.expanded_channels, b.out_channels, b.out_channels)
        blocks[str(i)] = s
    state["blocks"] = blocks
    if net.head is not None:
        state["head"] = {"bn": conv_state(net.head.in_channels, net.head.out_channels, net.head.out_channels)}
    return state


def _split_groups(expanded: int, kernels: Sequence[int]) -> tuple[int, ...]:
    """Split expanded channels into one atomic group per kernel size.

    Equal split; the remainder goes to the first (smallest-kernel) groups so
    the sum is exact and every group is non-empty.
    """
    n = len(kernels)
    base = expanded // n
    rem = expanded - base * n
    groups = tuple(base + (1 if i < rem else 0) for i in range(n))
    if any(g <= 0 for g in groups):
        raise ValueError(f"expanded={expanded} too small for {n} kernel groups")
    return groups


def build_network(
    arch: ArchDef,
    *,
    width_mult: float = 1.0,
    num_classes: int = 1000,
    dropout: float = 0.2,
    bn_momentum: float = 0.1,
    bn_eps: float = 1e-5,
    image_size: int = 224,
    block_specs_override: Sequence[Mapping[str, Any]] | None = None,
    exact_channels: Mapping[str, int] | None = None,
    drop_connect: float | None = None,
) -> Network:
    """exact_channels pins {'stem','head','feature'} widths to FINAL values,
    exempt from width_mult scaling — an explicit ``model.head_channels: 1280``
    means 1280, not make_divisible(1280*width_mult) (the AtomNAS-C 1.1x seed
    needs a widened prunable trunk under an unscaled, unprunable head)."""
    specs = tuple(block_specs_override) if block_specs_override is not None else arch.block_specs
    exact = dict(exact_channels or {})
    if unknown := set(exact) - {"stem", "head", "feature"}:
        raise ValueError(f"unknown exact_channels key(s) {sorted(unknown)}; valid: stem, head, feature")

    stem_ch = exact["stem"] if "stem" in exact else make_divisible(arch.stem_channels * width_mult)
    stem = ConvBNAct(3, stem_ch, 3, 2, active_fn=arch.stem_act, bn_momentum=bn_momentum, bn_eps=bn_eps)

    dc_rate = arch.drop_connect if drop_connect is None else drop_connect
    if not 0.0 <= dc_rate < 1.0:
        raise ValueError(f"drop_connect must be in [0, 1), got {dc_rate}")
    total_blocks = sum(int(s.get("n", 1)) for s in specs)
    block_idx = 0
    blocks: list[InvertedResidual] = []
    c_in = stem_ch
    for spec in specs:
        spec = dict(spec)
        block_type = spec.get("block", "mbconv")
        n = int(spec.get("n", 1))
        c = make_divisible(spec["c"] * width_mult)
        s = int(spec.get("s", 1))
        kernels = spec.get("k", 3)
        if isinstance(kernels, int):
            kernels = (kernels,)
        kernels = tuple(int(k) for k in kernels)
        act = spec.get("act") or arch.default_act
        se_ratio = float(spec.get("se", 0.0) or 0.0)
        se_mode = spec.get("se_mode", arch.default_se_mode)
        se_gate = spec.get("se_gate", arch.default_se_gate)
        se_inner = spec.get("se_inner", arch.default_se_inner)
        for j in range(n):
            stride = s if j == 0 else 1
            if block_type in ("ds", "ds_act"):
                expanded = c_in
            elif "exp" in spec:
                # absolute expanded width (MobileNetV3 tables); only the
                # stage's first block uses it verbatim — repeats re-derive
                # from their own input if given as ratio, but V3 lists every
                # block as its own stage so this path is exact.
                expanded = make_divisible(float(spec["exp"]) * width_mult)
            else:
                expanded = make_divisible(c_in * float(spec["t"]))
            if se_ratio > 0:
                if se_mode == "expand":
                    se_ch = make_divisible(expanded * se_ratio)
                elif se_mode == "input":
                    se_ch = max(1, int(c_in * se_ratio))
                else:
                    raise ValueError(f"unknown se_mode {se_mode!r}")
            else:
                se_ch = 0
            blocks.append(
                InvertedResidual(
                    in_channels=c_in,
                    out_channels=c,
                    expanded_channels=expanded,
                    stride=stride,
                    kernel_sizes=kernels,
                    group_channels=_split_groups(expanded, kernels),
                    active_fn=act,
                    se_channels=se_ch,
                    se_gate_fn=se_gate,
                    se_inner_act=se_inner,
                    bn_momentum=bn_momentum,
                    bn_eps=bn_eps,
                    project_act=act if block_type == "ds_act" else "identity",
                    allow_residual=block_type not in ("ds", "ds_act"),
                    drop_path=dc_rate * block_idx / total_blocks,
                )
            )
            block_idx += 1
            c_in = c

    # membership (not truthiness) so an explicit override of 0 keeps the
    # documented "0 = no head/feature layer" semantics
    if "head" in exact:
        head_ch = exact["head"]
    elif arch.head_channels:
        hc = arch.head_channels
        scaled = make_divisible(hc * width_mult)
        head_ch = scaled if (arch.head_scales_down or width_mult > 1.0) else max(hc, scaled)
    else:
        head_ch = 0
    head = None
    head_out = c_in
    if head_ch:
        head = ConvBNAct(c_in, head_ch, 1, 1, active_fn=arch.head_act, bn_momentum=bn_momentum, bn_eps=bn_eps)
        head_out = head_ch

    if "feature" in exact:
        feat_ch = exact["feature"]
    elif arch.feature_channels:
        fc = arch.feature_channels
        feat_ch = make_divisible(fc * width_mult) if width_mult > 1.0 else fc
    else:
        feat_ch = 0
    feature = None
    feat_out = head_out
    if feat_ch:
        feature = Dense(head_out, feat_ch, use_bias=True)
        feat_out = feat_ch

    classifier = Dense(feat_out, num_classes, use_bias=True)
    return Network(
        stem=stem,
        blocks=tuple(blocks),
        head=head,
        feature=feature,
        feature_act=arch.feature_act,
        classifier=classifier,
        dropout=dropout,
        image_size=image_size,
    )

# Copy of yet_another_mobilenet_series_tpu/models/zoo.py: the port keeps its own copy so that it never imports the
# JAX package. Keep the two in step by hand.
"""Named architectures (reference: models/mobilenet_v1|v2|v3.py + MNASNet +
the AtomNAS supernet block-specs in apps/*.yml — SURVEY.md §2 #4-5).

Tables are transcribed from the public papers:
- MobileNetV1 (arXiv:1704.04861 Table 1)
- MobileNetV2 (arXiv:1801.04381 Table 2)
- MobileNetV3-Large/Small (arXiv:1905.02244 Tables 1-2)
- MNASNet-A1 (arXiv:1807.11626 Fig. 7)
- AtomNAS supernet (arXiv:1912.09640 §3: MobileNetV2-skeleton with each
  MBConv's expanded channels split into k=3/5/7 atomic groups)
- EfficientNet-B0 / Lite0 (arXiv:1905.11946 Table 1; beyond reference
  parity — same MNASNet search-space lineage, expressed in the same spec
  grammar: SE=0.25 of block INPUT width with sigmoid gate and swish inner
  FC, swish everywhere; Lite drops SE and uses ReLU6 for int8 friendliness)

Golden param/MAC counts are locked in tests/test_models.py.
"""

from __future__ import annotations

from .specs import ArchDef

# --- MobileNetV1: depthwise-separable stacks, ReLU throughout ---------------
MOBILENET_V1 = ArchDef(
    stem_channels=32,
    block_specs=(
        dict(block="ds_act", c=64, n=1, s=1),
        dict(block="ds_act", c=128, n=1, s=2),
        dict(block="ds_act", c=128, n=1, s=1),
        dict(block="ds_act", c=256, n=1, s=2),
        dict(block="ds_act", c=256, n=1, s=1),
        dict(block="ds_act", c=512, n=1, s=2),
        dict(block="ds_act", c=512, n=5, s=1),
        dict(block="ds_act", c=1024, n=1, s=2),
        dict(block="ds_act", c=1024, n=1, s=1),
    ),
    head_channels=0,
    stem_act="relu",
    default_act="relu",
)

# --- MobileNetV2 (t, c, n, s), ReLU6, head 1280 -----------------------------
MOBILENET_V2 = ArchDef(
    stem_channels=32,
    block_specs=(
        dict(t=1, c=16, n=1, s=1),
        dict(t=6, c=24, n=2, s=2),
        dict(t=6, c=32, n=3, s=2),
        dict(t=6, c=64, n=4, s=2),
        dict(t=6, c=96, n=3, s=1),
        dict(t=6, c=160, n=3, s=2),
        dict(t=6, c=320, n=1, s=1),
    ),
    head_channels=1280,
    stem_act="relu6",
    head_act="relu6",
    default_act="relu6",
)

# --- MobileNetV3-Large: per-block rows (exp absolute), SE on expanded/4 -----
MOBILENET_V3_LARGE = ArchDef(
    stem_channels=16,
    block_specs=(
        dict(exp=16, c=16, n=1, s=1, k=3, act="relu"),
        dict(exp=64, c=24, n=1, s=2, k=3, act="relu"),
        dict(exp=72, c=24, n=1, s=1, k=3, act="relu"),
        dict(exp=72, c=40, n=1, s=2, k=5, act="relu", se=0.25),
        dict(exp=120, c=40, n=1, s=1, k=5, act="relu", se=0.25),
        dict(exp=120, c=40, n=1, s=1, k=5, act="relu", se=0.25),
        dict(exp=240, c=80, n=1, s=2, k=3, act="hswish"),
        dict(exp=200, c=80, n=1, s=1, k=3, act="hswish"),
        dict(exp=184, c=80, n=1, s=1, k=3, act="hswish"),
        dict(exp=184, c=80, n=1, s=1, k=3, act="hswish"),
        dict(exp=480, c=112, n=1, s=1, k=3, act="hswish", se=0.25),
        dict(exp=672, c=112, n=1, s=1, k=3, act="hswish", se=0.25),
        dict(exp=672, c=160, n=1, s=2, k=5, act="hswish", se=0.25),
        dict(exp=960, c=160, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=960, c=160, n=1, s=1, k=5, act="hswish", se=0.25),
    ),
    head_channels=960,
    feature_channels=1280,
    stem_act="hswish",
    head_act="hswish",
    feature_act="hswish",
    default_act="hswish",
    default_se_mode="expand",
    default_se_gate="hsigmoid",
    head_scales_down=True,
)

# --- MobileNetV3-Small --------------------------------------------------------
MOBILENET_V3_SMALL = ArchDef(
    stem_channels=16,
    block_specs=(
        dict(exp=16, c=16, n=1, s=2, k=3, act="relu", se=0.25),
        dict(exp=72, c=24, n=1, s=2, k=3, act="relu"),
        dict(exp=88, c=24, n=1, s=1, k=3, act="relu"),
        dict(exp=96, c=40, n=1, s=2, k=5, act="hswish", se=0.25),
        dict(exp=240, c=40, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=240, c=40, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=120, c=48, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=144, c=48, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=288, c=96, n=1, s=2, k=5, act="hswish", se=0.25),
        dict(exp=576, c=96, n=1, s=1, k=5, act="hswish", se=0.25),
        dict(exp=576, c=96, n=1, s=1, k=5, act="hswish", se=0.25),
    ),
    head_channels=576,
    feature_channels=1024,
    stem_act="hswish",
    head_act="hswish",
    feature_act="hswish",
    default_act="hswish",
    head_scales_down=True,
)

# --- MNASNet-A1: sepconv stem block + SE(0.25 of input) gated by sigmoid ----
MNASNET_A1 = ArchDef(
    stem_channels=32,
    block_specs=(
        dict(block="ds", c=16, n=1, s=1, k=3),
        dict(t=6, c=24, n=2, s=2, k=3),
        dict(t=3, c=40, n=3, s=2, k=5, se=0.25),
        dict(t=6, c=80, n=4, s=2, k=3),
        dict(t=6, c=112, n=2, s=1, k=3, se=0.25),
        dict(t=6, c=160, n=3, s=2, k=5, se=0.25),
        dict(t=6, c=320, n=1, s=1, k=3),
    ),
    head_channels=1280,
    stem_act="relu",
    head_act="relu",
    default_act="relu",
    default_se_mode="input",
    default_se_gate="sigmoid",
)

# --- AtomNAS supernet: MBV2 skeleton, every MBConv split into k=3/5/7 atoms -
_ATOMNAS_SPECS = (
    dict(t=1, c=16, n=1, s=1, k=[3, 5, 7]),
    dict(t=6, c=24, n=2, s=2, k=[3, 5, 7]),
    dict(t=6, c=32, n=3, s=2, k=[3, 5, 7]),
    dict(t=6, c=64, n=4, s=2, k=[3, 5, 7]),
    dict(t=6, c=96, n=3, s=1, k=[3, 5, 7]),
    dict(t=6, c=160, n=3, s=2, k=[3, 5, 7]),
    dict(t=6, c=320, n=1, s=1, k=[3, 5, 7]),
)

ATOMNAS_SUPERNET = ArchDef(
    stem_channels=32,
    block_specs=_ATOMNAS_SPECS,
    head_channels=1280,
    stem_act="relu6",
    head_act="relu6",
    default_act="relu6",
)

# "+" variants (AtomNAS-A+/B+/C+): SE everywhere + swish (SURVEY.md §6).
ATOMNAS_SUPERNET_SE = ArchDef(
    stem_channels=32,
    block_specs=tuple(dict(s, se=0.25) for s in _ATOMNAS_SPECS),
    head_channels=1280,
    stem_act="swish",
    head_act="swish",
    default_act="swish",
    default_se_mode="expand",
    default_se_gate="sigmoid",
)

# --- EfficientNet-B0: MNASNet-style stages, swish + input-mode SE -----------
_EFFICIENTNET_B0_SPECS = (
    dict(t=1, c=16, n=1, s=1, k=3),
    dict(t=6, c=24, n=2, s=2, k=3),
    dict(t=6, c=40, n=2, s=2, k=5),
    dict(t=6, c=80, n=3, s=2, k=3),
    dict(t=6, c=112, n=3, s=1, k=5),
    dict(t=6, c=192, n=4, s=2, k=5),
    dict(t=6, c=320, n=1, s=1, k=3),
)

EFFICIENTNET_B0 = ArchDef(
    stem_channels=32,
    block_specs=tuple(dict(s, se=0.25) for s in _EFFICIENTNET_B0_SPECS),
    head_channels=1280,
    stem_act="swish",
    head_act="swish",
    default_act="swish",
    default_se_mode="input",
    default_se_gate="sigmoid",
    default_se_inner="swish",
    # EfficientNet round_filters scales EVERY width incl. the head at wm<1
    # (unlike the MBV2/V3 head-never-shrinks convention).
    head_scales_down=True,
    drop_connect=0.2,  # stochastic-depth max rate, paper default
)

# Lite0: SE removed, ReLU6 everywhere (quantization-friendly). At width 1.0
# this is exact; the lite papers also pin stem/head widths across width
# multipliers — reproduce that at other widths with explicit
# model.stem_channels=32 model.head_channels=1280 overrides (exact_channels).
EFFICIENTNET_LITE0 = ArchDef(
    stem_channels=32,
    block_specs=_EFFICIENTNET_B0_SPECS,
    head_channels=1280,
    stem_act="relu6",
    head_act="relu6",
    default_act="relu6",
    drop_connect=0.2,  # the official lite recipe keeps B0's stochastic depth
)

ARCHS: dict[str, ArchDef] = {
    "mobilenet_v1": MOBILENET_V1,
    "mobilenet_v2": MOBILENET_V2,
    "mobilenet_v3_large": MOBILENET_V3_LARGE,
    "mobilenet_v3_small": MOBILENET_V3_SMALL,
    "mnasnet_a1": MNASNET_A1,
    "atomnas_supernet": ATOMNAS_SUPERNET,
    "atomnas_supernet_se": ATOMNAS_SUPERNET_SE,
    "efficientnet_b0": EFFICIENTNET_B0,
    "efficientnet_lite0": EFFICIENTNET_LITE0,
}


def get_arch(name: str) -> ArchDef:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None

"""Operations and bytes counted from the model's shapes, the card's peaks, and the depthwise
stage's bound: the benchmark's own copies, which no later change to the program moves.

- ``forward_macs``: the MAC convention of ``yet_another_mobilenet_series_tpu_torch/utils/profiling.py``
  (convs and dense layers, SE's FCs included; BN, activations and pooling free), counted here
  from the reference's tables, not from the program's network;
- ``stage_bound`` and the card rates: copied from ``chip_smoke.py`` ``stage_bound`` and ``_BW`` /
  ``_F32`` (each input read once and each output written once over the memory rate, against
  2 k^2 + 4 float32 operations an output over the float32 rate);
- the data-sheet peaks: NVIDIA's H100 SXM sheet, dense, at the 700 W limit, as
  ``yet_another_mobilenet_series_tpu_torch/bench/train_bench.py`` ``H100_PEAK_FLOPS`` holds them,
  with TF32's added.
"""

from __future__ import annotations

from ..reference import nets

# dense peaks of one H100 SXM (FLOP/s) by the precision the convolutions and matmuls run in
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# memory rate (bytes/s) and float32 rate (FLOP/s) by part
_BW = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
_F32 = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}


def card_part(name: str) -> str | None:
    """'SXM', 'PCIe' or 'NVL' for an H100, None for another card (whose peaks no sheet here gives)."""
    if "H100" not in name:
        return None
    for key in ("PCIe", "NVL"):
        if key in name:
            return key
    return "SXM"


def peak_flops(name: str, precision: str) -> float | None:
    """The data sheet's dense peak for the SXM part; None for another part or card."""
    return PEAK_FLOPS[precision] if card_part(name) == "SXM" else None


def card_rates(name: str) -> tuple[float, float]:
    part = card_part(name) or "SXM"
    return _BW[part], _F32[part]


def stage_bound(n, h, c, k, s, itemsize, rates) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes) of one depthwise stage: each input read once and each
    output written once (x and y in ``itemsize`` bytes, the taps and the three (C,) vectors in
    float32) over the memory rate, against 2k^2 + 4 float32 operations per output over the
    float32 rate."""
    bw, f32_rate = rates
    oh = (h - 1) // s + 1
    out_elems = n * oh * oh * c
    nbytes = itemsize * (n * h * h * c + out_elems) + 4 * (k * k * c + 3 * c)
    flops = out_elems * (2 * k * k + 4)
    by_bytes, by_ops = nbytes / bw, flops / f32_rate
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations", nbytes


def forward_macs(arch: nets.Arch, image_size: int) -> int:
    """Multiply-adds of one image's forward."""
    hw = (image_size - 1) // 2 + 1
    macs = hw * hw * 27 * arch.stem
    for b in arch.blocks:
        out = (hw - 1) // b.stride + 1
        if b.expand:
            macs += hw * hw * b.cin * b.exp
        macs += out * out * b.k * b.k * b.exp
        macs += 2 * b.exp * b.se
        macs += out * out * b.exp * b.cout
        hw = out
    macs += hw * hw * arch.blocks[-1].cout * arch.head
    if arch.feature:
        macs += arch.head * arch.feature
    return macs + arch.pooled * arch.num_classes


def depthwise_stages(arch: nets.Arch, image_size: int) -> list[tuple[int, int, int, int]]:
    """(input size, channels, kernel, stride) of each depthwise stage, in forward order."""
    hw = (image_size - 1) // 2 + 1
    out = []
    for b in arch.blocks:
        out.append((hw, b.exp, b.k, b.stride))
        hw = (hw - 1) // b.stride + 1
    return out


def forward_bound_ms(arch: nets.Arch, image_size: int, rows: int, itemsize: int, rates) -> float:
    """The sum of ``stage_bound`` over one forward's depthwise stages at ``rows`` rows."""
    return sum(stage_bound(rows, h, c, k, s, itemsize, rates)[0] for h, c, k, s in depthwise_stages(arch, image_size))

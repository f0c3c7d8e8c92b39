"""Measured per-block latency table for latency-aware NAS: the torch twin of
``scripts/latency_table.py``.

It times every distinct block of a network (by ``nas/latency.py``
``block_key``: channels, expanded width, kernel split, stride, SE, input
size) at several expanded-channel width fractions (:func:`width_variant`,
the channels re-split over the kernel branches as the supernet builder
splits them) and writes the JSON that ``nas/latency.py`` loads (both
packages' copies): per entry the key, the block's fields, ``alive_channels``,
``latency_s`` per image, ``cost_flops`` (2 x the block's MACs x the batch,
counted from shapes, recorded as ``obs.cost_flops.latbl_<key>_w<e>``) and
``compile_s`` (here the CUDA-graph capture, warm run included).

The JAX script timed the block's eval forward, because its serving forward
had no kernel of its own. This one times each block **in the form the port
serves**: BN folded (``serve/export.py`` :func:`fold_block`,
:func:`prepare_block`), every depthwise branch a launch of K1
(:func:`apply_folded_block`), the block captured in a CUDA graph and its
replays timed by CUDA events. The table's purpose is what serving pays, so
a search with ``prune.cost=latency_table`` on it weighs each atom by the
card's serving time.

It prints one JSON line (``--out`` copies it) stamped with the card
(``card_provenance``); a failure prints a line with ``value: null`` and
``error`` and exits 1, as does a request for the card (the default)
without one. ``--device cpu`` rehearses it for the tests: each block runs
eagerly, timed by the host clock (``timer`` says so), and the table says
``cpu_rehearsal: true``: it loads, but its times are the CPU's.

Usage: python -m yet_another_mobilenet_series_tpu_torch.bench.latency_table
           [--arch mobilenet_v3_large] [--width-mult 1.0] [--app APP.yml] [--image-sizes 224]
           [--widths 0.375,0.6875,1.0] [--batch 8] [--iters 50]
           [--device cpu] [--out LATENCY_TABLE.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..utils.benchkit import card_provenance
from ..utils.device import resolve_device

# the shipped serving config's compute dtype (serve.compute_dtype)
DTYPE = torch.float32


def width_variant(spec, width: float):
    """The block at ``width`` x its expanded channels (at least one a kernel
    branch), re-split over the branches as the supernet builder splits them;
    the SE width stays (masking prunes expanded channels, not the SE
    bottleneck)."""
    from ..models.specs import _split_groups

    e = max(len(spec.kernel_sizes), int(round(spec.expanded_channels * width)))
    return dataclasses.replace(spec, expanded_channels=e, group_channels=_split_groups(e, spec.kernel_sizes),
                               force_expand=True)


def _time_block(blk, image_size: int, batch: int, iters: int, dev) -> tuple[float, float]:
    """(seconds per image, capture seconds) of the block's folded forward on
    a (batch, image_size) input: on the card a CUDA graph, captured after an
    eager warm run and timed over ``iters`` replays by CUDA events; on the
    CPU the eager forward by the host clock."""
    from ..serve.export import apply_folded_block, fold_block, prepare_block

    params, state = blk.init(torch.Generator().manual_seed(0))
    pb = prepare_block(blk, fold_block(blk, params, state), device=dev, compute_dtype=DTYPE)
    # NHWC in memory: the channels_last (N, C, H, W) view the folded forward takes
    x = torch.zeros((batch, image_size, image_size, blk.in_channels), device=dev, dtype=DTYPE).permute(0, 3, 1, 2)

    def run():
        with torch.inference_mode():
            return apply_folded_block(blk, pb, x, compute_dtype=DTYPE)

    if dev.type != "cuda":
        run()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return (time.perf_counter() - t0) / (iters * batch), 0.0
    t0 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run()  # lazy kernel loading and cuDNN's choice, outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            run()
    side.synchronize()
    capture_s = time.perf_counter() - t0
    graph.replay()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / (iters * batch), capture_s


def bench_block(spec, image_size: int, widths, batch: int, iters: int, dev) -> dict:
    """One table entry: the block at each width, timed as it is served."""
    from ..nas.latency import block_key
    from ..obs import device as obs_device
    from ..utils.profiling import _profile_block

    key = block_key(spec, image_size)
    alive, lat, compile_s, flops = [], [], [], []
    for w in sorted(widths):
        blk = width_variant(spec, w)
        seconds, capture_s = _time_block(blk, image_size, batch, iters, dev)
        cost_key = f"latbl_{key}_w{blk.expanded_channels}"
        obs_device.record_cost(cost_key, {"flops": 2.0 * _profile_block(blk, image_size)[0] * batch},
                               compile_seconds=capture_s)
        alive.append(blk.expanded_channels)
        lat.append(seconds)
        compile_s.append(capture_s)
        flops.append(obs_device.flops_for(cost_key))
    return {"key": key, "in_channels": spec.in_channels, "out_channels": spec.out_channels,
            "expanded_channels": spec.expanded_channels, "kernel_sizes": list(spec.kernel_sizes),
            "stride": spec.stride, "se_channels": spec.se_channels, "image_size": image_size,
            "alive_channels": alive, "latency_s": lat, "cost_flops": flops, "compile_s": compile_s}


def build_table(net, image_sizes, widths, batch: int, iters: int, dev, log=lambda msg: None) -> list[dict]:
    """Every distinct block of ``net`` at every image size, one measurement
    per table key (repeated stages share it)."""
    from ..nas.latency import block_input_sizes, block_key

    entries: dict[str, dict] = {}
    for image_size in image_sizes:
        sizes = block_input_sizes(net, image_size)
        for i, blk in enumerate(net.blocks):
            key = block_key(blk, sizes[i])
            if key in entries:
                continue
            t0 = time.perf_counter()
            entries[key] = bench_block(blk, sizes[i], widths, batch, iters, dev)
            log(f"[{len(entries)}] {key}: {[round(v * 1e6, 2) for v in entries[key]['latency_s']]} us/image "
                f"({time.perf_counter() - t0:.1f}s)")
    return list(entries.values())


def measure(args, dev: torch.device) -> dict:
    from ..config import ModelConfig
    from ..models import get_model

    if args.app:  # the model of an app config (e.g. a search's supernet)
        from ..config import parse_cli

        mc = parse_cli([f"app:{args.app}"]).model
        args.arch, args.width_mult = mc.arch, mc.width_mult
    elif args.arch == "tiny":  # the tests' preset: two distinct blocks, one of them two branches
        mc = ModelConfig(arch="mobilenet_v2", num_classes=8, dropout=0.0,
                         block_specs=[{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5]}, {"t": 2, "c": 16, "n": 1, "s": 2}])
    else:
        mc = ModelConfig(arch=args.arch, width_mult=args.width_mult)
    net = get_model(mc, args.image_sizes[0])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    entries = build_table(net, args.image_sizes, args.widths, args.batch, args.iters, dev, log)
    return {
        "arch": args.arch, "width_mult": args.width_mult, "image_sizes": list(args.image_sizes),
        "widths": list(args.widths), "batch": args.batch, "iters": args.iters, "compute_dtype": "float32",
        "form": "folded BN, K1 per depthwise branch, one CUDA graph per (block, width)" if dev.type == "cuda"
        else "folded BN, the kernel's plain version per depthwise branch, eager (CPU rehearsal)",
        "timer": "CUDA events over graph replays" if dev.type == "cuda" else "host clock over eager calls",
        "entries": entries, "value": float(len(entries)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mobilenet_v3_large")
    ap.add_argument("--width-mult", type=float, default=1.0)
    ap.add_argument("--app", default="", help="take the model from this app config instead (--arch, --width-mult)")
    ap.add_argument("--image-sizes", type=lambda s: [int(v) for v in s.split(",")], default=[224],
                    help="comma ladder of network input sizes")
    ap.add_argument("--widths", type=lambda s: [float(v) for v in s.split(",")], default=[0.375, 0.6875, 1.0],
                    help="expanded-channel width fractions per block (>= 2 for a slope)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50, help="timed replays per (block, width)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu' (a rehearsal)")
    ap.add_argument("--out", default="", help="also write the JSON line here")
    args = ap.parse_args(argv)
    out: dict = {"metric": f"{args.arch}_block_latency_table", "value": None, "unit": "entries"}
    rc = 0
    try:
        if len(args.widths) < 2:
            raise ValueError("need >= 2 widths to fit a latency-vs-channels slope")
        dev = resolve_device(args.device)
        out.update(platform=dev.type, cpu_rehearsal=dev.type == "cpu",
                   device_kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
        out.update(measure(args, dev))
    except Exception as e:  # noqa: BLE001 — the contract: an error line and a non-zero exit
        out["value"] = None
        out["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    out["provenance"] = card_provenance(args.device)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

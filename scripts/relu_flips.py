#!/usr/bin/env python3
"""One block of a zoo net in training, on the card against the PyTorch
port's CPU path, from the same input: where a float32 train step of the two
devices parts.

    python3 scripts/relu_flips.py [--arch mobilenet_v1] [--block 1] [--batch 8]

The net is ``arch`` 1.0 at 224 as chip_smoke.py's phase 17 builds it (its
shipped config), with seeded weights (every BN gamma 1 and beta 0, as at
init). The stem and the blocks before ``--block`` run on the CPU; their
output is the block's input on both devices. Then, on each device, the
block's training forward (batch statistics) and its gradients under one
seeded cotangent; and each convolution of the block alone, on the card with
cuDNN and with PyTorch's native convolutions. It prints, against the CPU,
the largest difference of each output and gradient over the largest |value|
(beside the CPU's own difference with the batch's samples in another
order: the same function, other float32 sums), and for every activation of
the block the elements whose sign differs between the two devices (a relu's
gradient is 0 on one side and 1 on the other there) with the largest
|input| among them. It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mobilenet_v1")
    ap.add_argument("--block", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from yet_another_mobilenet_series_tpu_torch.models import convert
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.ops import blocks as blocks_mod
    from yet_another_mobilenet_series_tpu_torch.utils.benchkit import card_line
    from yet_another_mobilenet_series_tpu_torch.utils.device import set_tf32

    if not torch.cuda.is_available():
        print("relu_flips: no CUDA card", file=sys.stderr)
        return 2
    card = torch.device("cuda", 0)
    set_tf32("float32")
    print(card_line(), flush=True)
    net = chip_smoke.family_net(args.arch)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    rs = np.random.RandomState(1)
    h = torch.from_numpy(rs.normal(0, 1, (args.batch, 224, 224, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    with torch.no_grad():
        h, _ = net.stem.apply(params["stem"], state["stem"], h, train=True)
        for i in range(args.block):
            h, _ = net.blocks[i].apply(params["blocks"][str(i)], state["blocks"][str(i)], h, train=True)
    blk, p, s = net.blocks[args.block], params["blocks"][str(args.block)], state["blocks"][str(args.block)]
    real_get = blocks_mod.get_activation

    def run(dev, ct=None, order=None):
        seen = []

        def recording(name):
            act = real_get(name)

            def fn(x):
                seen.append(x.detach().cpu())
                return act(x)
            return fn

        blocks_mod.get_activation = recording
        try:
            leaves = {k: v.to(dev).requires_grad_(True) for k, v in convert.flatten_tree(p).items()}
            a = (h if order is None else h[order]).to(dev).requires_grad_(True)
            sd = convert.unflatten_tree({k: v.to(dev) for k, v in convert.flatten_tree(s).items()})
            y, _ = blk.apply(convert.unflatten_tree(leaves), sd, a, train=True)
        finally:
            blocks_mod.get_activation = real_get
        if ct is None:
            ct = torch.from_numpy(rs.normal(0, 1, tuple(y.shape)).astype(np.float32))
        grads = torch.autograd.grad((y * (ct if order is None else ct[order]).to(dev)).sum(),
                                    list(leaves.values()) + [a])
        back = slice(None) if order is None else np.argsort(order)
        out = {"output": y.detach().cpu()[back], "input gradient": grads[-1].cpu()[back]}
        out.update({f"gradient of {k}": g.cpu() for k, g in zip(leaves, grads[:-1])})
        return out, seen, ct

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    ref, seen_cpu, ct = run(torch.device("cpu"))
    got, seen_card, _ = run(card, ct)
    # the same block on the CPU with the batch's samples in another order:
    # the same function, other float32 sums
    rolled, _, _ = run(torch.device("cpu"), ct, np.roll(np.arange(args.batch), args.batch // 2 - 1))
    print(f"{args.arch} block {args.block} ({blk.expanded_channels} channels, stride {blk.stride}, "
          f"{blk.active_fn}), batch {args.batch}, float32, TF32 off; |diff| over the largest |value|, card against "
          "CPU / CPU with the samples reordered against CPU:")
    for key in ref:
        print(f"  {key}: {rel(got[key], ref[key]):.2e} / {rel(rolled[key], ref[key]):.2e}")
    for i, (xc, xg) in enumerate(zip(seen_cpu, seen_card)):
        flips = (xc > 0) != (xg > 0)
        at = xc[flips].abs()
        print(f"  activation {i} ({xc.numel()} elements): {int(flips.sum())} differ in sign between the devices"
              + (f", |input| at most {float(at.max()):.3e} there" if flips.any() else ""))
    # each convolution of the block alone, from the same input and cotangent
    n, _, hh, ww = h.shape
    x = torch.from_numpy(rs.normal(0, 1, (n, blk.expanded_channels, hh, ww)).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    for name, w, kw in [(f"dw{i}_k{k}", p[f"dw{i}_k{k}"]["w"], dict(stride=blk.stride, padding=k // 2, groups=g))
                        for i, k, g, _ in blk._branches() if len(blk.kernel_sizes) == 1]:
        y0 = F.conv2d(x, w, **kw)
        cc = torch.from_numpy(rs.normal(0, 1, tuple(y0.shape)).astype(np.float32))
        res = {}
        for tag, dev, cudnn in (("cpu", torch.device("cpu"), True), ("cudnn", card, True), ("native", card, False)):
            torch.backends.cudnn.enabled = cudnn
            try:
                xa, wa = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
                y = F.conv2d(xa, wa, **kw)
                res[tag] = [y.detach().cpu()] + [g.cpu() for g in torch.autograd.grad((y * cc.to(dev)).sum(),
                                                                                     [xa, wa])]
            finally:
                torch.backends.cudnn.enabled = True
        for tag in ("cudnn", "native"):
            print(f"  {name} alone, {tag}: output {rel(res[tag][0], res['cpu'][0]):.2e}, input gradient "
                  f"{rel(res[tag][1], res['cpu'][1]):.2e}, weight gradient {rel(res[tag][2], res['cpu'][2]):.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

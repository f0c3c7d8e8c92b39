"""YAMT001 clean: host work around the capture, not in it."""
import time

import torch


def capture(x):
    g = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(g):
        y = x * 2
    print(time.perf_counter() - t0)
    return g, y


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stride):
        ctx.stride = int(stride)  # a Python number: no tensor is read
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2, None


def replay(g, y):
    g.replay()
    return y.clone().cpu()

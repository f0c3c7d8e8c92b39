"""YAMT001 bad: host effects and host syncs in code captured into a CUDA graph."""
import time

import torch


def step(x):
    print("stepping")  # reached from the capture below: runs once, at capture
    return x * 2


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, s):
        if float(x) > 0:  # reads a tensor argument on the host
            return x * s
        return x

    @staticmethod
    def backward(ctx, g):
        return g.cpu(), None  # a host sync in the backward


def capture(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        t0 = time.perf_counter()  # once, at capture
        y = step(x)
        n = y.sum().item()  # illegal under capture
    return g, y, t0, n


class Engine:
    def __init__(self, reg):
        self.reg = reg

    def _body(self, x):
        self.reg.counter("serve.images").inc()  # counts the capture, never a replay
        return x + 1

    def capture(self, x):
        g = torch.cuda.CUDAGraph()
        g.capture_begin()
        y = self._body(x)
        g.capture_end()
        return g, y


def graphed(model, x):
    def fwd(a):
        torch.cuda.synchronize()
        return model(a)

    return torch.cuda.make_graphed_callables(fwd, (x,))

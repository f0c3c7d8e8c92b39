"""YAMT008 bad: a graph's static output kept across a later replay."""
import torch


def run(exe):
    exe.graph.replay()
    first = exe.y
    exe.graph.replay()
    return first.sum()  # the second replay overwrote it


def collect(exe, n):
    outs = []
    for _ in range(n):
        exe.graph.replay()
        outs.append(exe.y)  # every entry is the same buffer
    return outs


def local(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    g.replay()
    a = y[0]
    g.replay()
    return a, g

"""YAMT009 bad: graphs captured by every call."""
import torch


def time_once(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    g.replay()
    return y.sum()


def graphed_once(fn, x):
    f = torch.cuda.make_graphed_callables(fn, (x,))
    return f(x)


class Cache:
    def __init__(self):
        self.graphs = {}

    def _capture(self, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        return g

    def get(self, fn, x):
        self.graphs[(id(x), tuple(x.shape))] = self._capture(fn, x)
        return self.graphs

"""YAMT009 clean: each graph is kept and replayed."""
import torch


class Cache:
    def __init__(self):
        self.graphs = {}

    def _capture(self, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(x)
        return g

    def get(self, fn, x, key):
        k = (key, tuple(x.shape))
        if k not in self.graphs:
            self.graphs[k] = self._capture(fn, x)
        return self.graphs[k]


class Step:
    def __init__(self):
        self._graph = None

    def __call__(self, fn, x):
        if self._graph is None:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn(x)
            self._graph = g
        self._graph.replay()

"""YAMT010 clean: each consumer gets its own seed."""
import torch


def init_weights(gen, seed, shape):
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen)


def build(seed):
    g = torch.Generator()
    w1 = init_weights(g, seed, (4, 4))
    w2 = init_weights(g, seed + 1, (4, 4))
    return w1, w2


def mixed(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.rand(3, generator=g)
    b = init_weights(g, seed + 1, (3,))
    return a, b

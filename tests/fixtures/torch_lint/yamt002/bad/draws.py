"""YAMT002 bad: draws from the global generator, and re-seeded generators."""
import torch


def noise(shape):
    return torch.randn(shape)


def dropout_mask(x, p):
    return torch.empty_like(x).bernoulli_(p)


def reseed(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.randn(4, generator=g)
    g.manual_seed(seed)  # the next consumer reads a's stream
    b = torch.randn(4, generator=g)
    return a, b


def per_iteration(seed, n):
    g = torch.Generator()
    out = []
    for _ in range(n):
        g.manual_seed(seed)  # every iteration the same stream
        out.append(torch.rand(2, generator=g))
    return out

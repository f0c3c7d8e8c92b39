"""YAMT002 clean: every draw takes a generator, every seeding its own seed."""
import torch


def noise(shape, generator):
    return torch.randn(shape, generator=generator)


def dropout_mask(x, p, generator):
    return torch.empty_like(x).bernoulli_(p, generator=generator)


def reseed(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.randn(4, generator=g)
    g.manual_seed(seed + 1)
    b = torch.randn(4, generator=g)
    return a, b


def per_iteration(seed, n):
    g = torch.Generator()
    out = []
    for i in range(n):
        g.manual_seed(seed + i)
        out.append(torch.rand(2, generator=g))
    return out


def branches(seed, flag):
    g = torch.Generator()
    if flag:
        g.manual_seed(seed)
        return torch.rand(1, generator=g)
    g.manual_seed(seed)
    return torch.randn(1, generator=g)

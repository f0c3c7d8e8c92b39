"""YAMT003 bad: collectives over the default world group."""
import torch.distributed as dist


def sync(t):
    dist.all_reduce(t)
    dist.barrier()


def share(t, src):
    dist.broadcast(t, src)

"""YAMT003 clean: every collective names its group."""
import torch.distributed as dist


def sync(t, group):
    dist.all_reduce(t, group=group)
    dist.barrier(group=group)


def share(t, src, group):
    dist.broadcast(t, src, group)


def world(t):
    dist.all_reduce(t, group=None)  # the caller says "the world"

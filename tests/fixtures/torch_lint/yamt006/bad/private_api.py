"""YAMT006 bad: private torch names outside a version guard."""
import torch
import torch.utils._pytree as pytree
from torch._dynamo import config


def stream(device):
    return torch._C._cuda_getCurrentRawStream(device)


def flat(tree):
    return pytree.tree_flatten(tree), config

"""YAMT006 clean: guarded, allowed by name, or public."""
import torch

try:
    from torch._dynamo import config
except ImportError:
    config = None


def stream(device):
    try:
        return torch._C._cuda_getCurrentRawStream(device)
    except AttributeError:
        return torch.cuda.current_stream(device).cuda_stream


def norms(tensors):
    return torch._foreach_norm(tensors)


def version():
    return torch.__version__, config

"""YAMT014 bad: host tensors touched while a non_blocking copy owns them."""
import torch


def stage(dev_buf, rows):
    host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(torch.from_numpy(rows))
    dev_buf.copy_(host, non_blocking=True)
    host.zero_()  # the card may still be reading it


def stage_loop(dev, batches):
    host = torch.empty((8, 4), pin_memory=True)
    out = []
    for b in batches:
        host[:] = b  # the previous iteration's copy may still read it
        out.append(host.to(dev, non_blocking=True))
    return out


def fetch(y):
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    return host.numpy()  # the bytes may not have landed

"""YAMT016 bad: a uint8 wire buffer widened on the host."""
import numpy as np
import torch


def stage_u8(images, dev):
    buf = torch.empty((len(images), 4, 4, 3), dtype=torch.uint8)
    for i, im in enumerate(images):
        buf[i] = torch.from_numpy(im)
    x = buf.float()
    return x.to(dev)


def stage_np(dev):
    arr = np.zeros((2, 4, 4, 3), np.uint8)
    t = torch.from_numpy(arr)
    return t.to(dev, torch.float32)


def as_tensor(images):
    arr = np.asarray(images, dtype=np.uint8)
    return torch.as_tensor(arr, dtype=torch.float32)

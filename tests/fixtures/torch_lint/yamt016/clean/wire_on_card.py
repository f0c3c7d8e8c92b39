"""YAMT016 clean: the wire stays narrow until it is on the card."""
import numpy as np
import torch


def stage_u8(images, dev):
    buf = torch.empty((len(images), 4, 4, 3), dtype=torch.uint8)
    x = buf.to(dev)
    return x.float()


def stage_var(dev, dtype):
    arr = np.zeros((2, 4, 4, 3), np.uint8)
    return torch.from_numpy(arr).to(dev, dtype)

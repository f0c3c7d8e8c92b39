"""YAMT014 clean: a sync before the host touches the buffer, or a hand-off."""
import torch


def stage(dev_buf, rows, stream):
    host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(torch.from_numpy(rows))
    dev_buf.copy_(host, non_blocking=True)
    stream.synchronize()
    host.zero_()


def fetch(y):
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def fetch_sync(y):
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    torch.cuda.synchronize()
    return host.numpy()

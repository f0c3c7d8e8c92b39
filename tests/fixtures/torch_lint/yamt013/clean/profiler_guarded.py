"""YAMT013 clean: every window stops in a finally, or is a with."""
import torch


def profile_steps(step, n):
    prof = torch.profiler.profile()
    prof.start()
    try:
        for _ in range(n):
            step()
    finally:
        prof.stop()
    return prof


def with_form(step):
    with torch.profiler.profile() as prof:
        step()
    return prof


def cuda_window(step):
    try:
        torch.cuda.profiler.start()
        step()
    finally:
        torch.cuda.profiler.stop()

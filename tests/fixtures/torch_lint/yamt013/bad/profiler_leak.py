"""YAMT013 bad: profiler windows with no finally-guaranteed stop."""
import torch


def profile_steps(step, n):
    prof = torch.profiler.profile()
    prof.start()
    for _ in range(n):
        step()
    prof.stop()
    return prof


def cuda_window(step):
    torch.cuda.profiler.start()
    step()
    torch.cuda.profiler.stop()


class Window:
    def open(self):
        self._prof = torch.profiler.profile()
        self._prof.start()

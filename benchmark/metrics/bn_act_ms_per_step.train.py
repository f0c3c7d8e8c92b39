"""``bn_act_ms_per_step.train``: device milliseconds a training step in the elementwise and
reduction kernels (``kernel_kind``), where train-mode BN's and the activations' chains run."""


def read(r):
    if not r.digest.busy_us or not r.window.get("steps"):
        return None
    us = r.digest.per_kind_us["elementwise"] + r.digest.per_kind_us["reductions"]
    return us / 1e3 / r.window["steps"]

"""YAMT008 clean: copied out between replays."""


def run(exe):
    exe.graph.replay()
    first = exe.y.clone()
    exe.graph.replay()
    return first.sum() + exe.y.sum()


def collect(exe, n):
    outs = []
    for _ in range(n):
        exe.graph.replay()
        outs.append(exe.y.clone())
    return outs


def bound_before(exe):
    out = exe.y  # a reference to the static output, read after each replay
    exe.graph.replay()
    return out.sum()

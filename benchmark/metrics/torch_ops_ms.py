"""Device time of PyTorch's own kernels (ATen, cuBLAS, copies and fills:
every kernel but the port's hand-written ones, told apart by name) in the
traced window, in ms per tick."""

from benchmark.harness import trace as tr


def read(ctx):
    t = ctx["trace"]
    ks = [(a, b) for name, a, b in t.in_window() if tr.kind(name) == "torch"]
    if not ks:
        return None
    return sum(b - a for a, b in ks) / 1e3 / t.ticks

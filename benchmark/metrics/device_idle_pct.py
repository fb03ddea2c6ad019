"""Share of the traced window in which no kernel ran on the card:
100 x (1 - union of the kernels' intervals / the window)."""

from benchmark.harness import trace as tr


def read(ctx):
    t = ctx["trace"]
    lo, hi = t.window
    if not t.kernels or hi <= lo:
        return None
    busy = tr.union_us(tr.clipped([(a, b) for _, a, b in t.kernels], lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))

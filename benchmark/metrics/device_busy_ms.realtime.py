"""Device busy time of the one-robot controller: the union of the
kernels' and copies' intervals inside the ticks' host ranges (first read
to last torque back), in ms per tick. The profiler stretches a tick's
span, not the device's work in it."""

from benchmark.harness import trace as tr


def read(ctx):
    t = ctx["trace"]
    ticks = t.ranges(tr.TICK)
    spans = [(a, b) for _, a, b in t.kernels]
    if not ticks or not spans:
        return None
    return sum(tr.union_us(tr.clipped(spans, a, b)) for a, b in ticks) / 1e3 / len(ticks)

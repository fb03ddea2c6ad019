"""Device busy time of the one-robot controller's solve, in ms per tick:
per ``realtime.tick`` span, the union of the device's intervals from the
tick's start to the end of its first ``realtime.torques`` span (the solve
and the first low-level period, which the host does not separate), less
one period's ``lowlevel_busy_ms.realtime``; the mean over ticks."""

from benchmark.harness import stages


def read(ctx):
    t = ctx["trace"]
    ticks = stages.realtime_ticks(t)
    periods = stages.lowlevel_periods_us(t, ticks)
    if not periods or not t.kernels:
        return None
    first = [stages.busy_us(t, a, torques[0][1]) for a, _, _, torques in ticks]
    return (sum(first) / len(first) - sum(periods) / len(periods)) / 1e3

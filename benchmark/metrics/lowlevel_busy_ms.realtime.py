"""Device busy time of one low-level period of the one-robot controller
(its graph's replay and the read's and torques' copies), in ms: the mean
over periods 2 to 8 of each tick of the union of the device's intervals
from the period's ``realtime.read`` span to the end of its
``realtime.torques`` span (the program's spans, ``runtime/realtime.py``)."""

from benchmark.harness import stages


def read(ctx):
    t = ctx["trace"]
    periods = stages.lowlevel_periods_us(t, stages.realtime_ticks(t))
    if not periods or not t.kernels:
        return None
    return sum(periods) / len(periods) / 1e3

"""Device time of the stage ``art.control`` (each low-level period's
feedback, sole positions and low-level control, on the ground under each
env) in one tick of the plain chain, in ms: the program's marks in its
captured tick, read after the last tick of the traced run's last call,
which runs without the profiler (``harness/stages.py``)."""

from benchmark.harness import stages


def read(ctx):
    return stages.stage_ms("art.control")

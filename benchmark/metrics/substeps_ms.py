"""Device time of the stage ``art.substeps`` (each low-level period's plain
substeps: Featherstone dynamics and the penalty contact along the ground's
normal) in one tick of the plain chain, in ms: the program's marks in its
captured tick, read after the last tick of the traced run's last call,
which runs without the profiler (``harness/stages.py``)."""

from benchmark.harness import stages


def read(ctx):
    return stages.stage_ms("art.substeps")

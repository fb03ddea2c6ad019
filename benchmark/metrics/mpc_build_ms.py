"""Device time of the stage ``mpc.build`` (the contact schedule, the
references, the horizon's linearization and the condensed QP) in one
tick, in ms: the program's marks in its captured tick, read after the
last tick of the traced run's last call, which runs without the profiler
(``harness/stages.py``)."""

from benchmark.harness import stages


def read(ctx):
    return stages.stage_ms("mpc.build")

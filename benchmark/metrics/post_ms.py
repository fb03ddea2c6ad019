"""Device time of the stage ``tick.post`` (everything after the physics:
fall reset, the controller state's advance, the metrics) in one tick, in
ms: the program's marks in its captured tick, read after the last tick
of the traced run's last call, which runs without the profiler
(``harness/stages.py``)."""

from benchmark.harness import stages


def read(ctx):
    return stages.stage_ms("tick.post")

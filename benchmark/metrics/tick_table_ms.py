"""Device time of the stage ``art.tick_table`` (the table of each env's
control constants that the tick kernel's per-env variant reads, formed in
the tick from the per-env values) in one tick, in ms: the program's marks
in its captured tick, read after the last tick of the traced run's last
call, which runs without the profiler (``harness/stages.py``)."""

from benchmark.harness import stages


def read(ctx):
    return stages.stage_ms("art.tick_table")

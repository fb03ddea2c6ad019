"""The tick kernel's share of its bound: the least time its operations
(8 x (2,117 + 5 x 4,324) an env, ``benchmark/roofline/counts.py``) or its
bytes take at the H100's peaks, over its mean device time a launch in the
traced window."""

from benchmark.harness import trace as tr
from benchmark.roofline import counts


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    ks = [(a, b) for name, a, b in t.in_window() if tr.kind(name) == "tick"]
    if not ks:
        return None
    kw = cell.config["entry"][cell.traffic["loop"]]["kwargs"]
    bound, _ = counts.tick_bound_ms(cell.traffic["envs"], kw["n_lowlevel"], kw["n_substeps"])
    ms = sum(b - a for a, b in ks) / len(ks) / 1e3
    return 100.0 * bound / ms

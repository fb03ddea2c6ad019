"""Device kernels (and copies) that ran in the traced window, per tick."""


def read(ctx):
    t = ctx["trace"]
    ks = t.in_window()
    return len(ks) / t.ticks if ks else None

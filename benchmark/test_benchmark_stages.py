"""The readers of the program's own spans (``harness/stages.py``): the two
one-robot readers on a synthetic trace, and the batched stage readers with
and without a replayed graph's marks."""

from __future__ import annotations

import pytest

from benchmark.harness import spec
from benchmark.harness import trace as tr

BATCHED = {"mpc_build_ms": "mpc.build", "ruiz_ms": "qp.ruiz", "unscale_ms": "qp.unscale",
           "post_ms": "tick.post", "feedback_ms": "art.feedback", "minv_ms": "art.minv",
           "srb_step_ms": "srb.step"}


def _ticks(n_ticks=2, n_ll=8):
    """A window of ``n_ticks`` one-robot ticks, 1,000 us apart: the solve's
    read and an 87 us solve kernel, then per period a read, a 10 us kernel
    and the torques; a 100 us kernel between ticks, and the harness's own
    tick range (``device_busy_ms.realtime``'s; the new readers do not use
    it)."""
    host, kernels = [], []
    for k in range(n_ticks):
        b = 1000.0 * k
        host += [("realtime.tick", b, b + 500), (tr.TICK, b + 1, b + 490),
                 ("realtime.read", b + 1, b + 2), ("realtime.solve", b + 2, b + 3)]
        kernels += [("solve", b + 3, b + 90), ("between", b + 600, b + 700)]
        for j in range(n_ll):
            p = b + 100 + 50 * j
            host += [("realtime.read", p, p + 1), ("realtime.lowlevel", p + 1, p + 2),
                     ("realtime.torques", p + 30, p + 40), ("realtime.apply", p + 40, p + 41)]
            kernels.append(("lowlevel", p + 2, p + 12))
    return tr.Trace(kernels=kernels, host=host, ticks=n_ticks, window=(0.0, 1000.0 * n_ticks))


def _read(name, trace):
    return spec.metric_reader(name)({"trace": trace, "cell": None})


def test_realtime_readers_on_a_synthetic_trace():
    t = _ticks()
    assert _read("lowlevel_busy_ms.realtime", t) == pytest.approx(0.010)
    assert _read("solve_busy_ms.realtime", t) == pytest.approx(0.087)
    # solve + 8 periods is the device's busy time inside the ticks
    assert _read("solve_busy_ms.realtime", t) + 8 * _read("lowlevel_busy_ms.realtime", t) \
        == pytest.approx(_read("device_busy_ms.realtime", t))


def test_realtime_readers_without_the_programs_spans():
    t = _ticks()
    bare = tr.Trace(kernels=t.kernels, host=[h for h in t.host if h[0] == tr.TICK],
                    ticks=t.ticks, window=t.window)
    assert _read("lowlevel_busy_ms.realtime", bare) is None
    assert _read("solve_busy_ms.realtime", bare) is None


class _Marks:
    def ms(self):
        return {stage: 1.0 + i for i, stage in enumerate(BATCHED.values())}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_readers(monkeypatch, name):
    from biped_mpc_py_torch.utils import profiling

    monkeypatch.setattr(profiling, "_replayed", None)
    assert _read(name, None) is None
    monkeypatch.setattr(profiling, "_replayed", _Marks())
    assert _read(name, None) == _Marks().ms()[BATCHED[name]]

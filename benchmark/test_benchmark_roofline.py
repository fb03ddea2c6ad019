"""The frozen work counts (``benchmark/roofline/counts.py``) against the
figures that PERF.md gives for them."""

from __future__ import annotations

import pytest

from benchmark.roofline import counts

FAST = dict(n_iters=40, n_phases=1, ns_iters=10, polish=False, bf16_iters=8)
DEFAULT = dict(n_iters=60, n_phases=3, ns_iters=14, polish=True, bf16_iters=0)


@pytest.mark.parametrize("budget, ms", [(FAST, 0.1651), (DEFAULT, 2.2849)])
def test_qp_bound_at_1024(budget, ms):
    bound, by = counts.qp_solve_bound_ms(counts.qp_solve_work(1024, 10, 24, **budget))
    assert by == "operations"
    assert round(bound, 4) == ms


def test_physics_operations_an_env():
    assert counts.SUBSTEP_OPS == 4324
    assert counts.PERIOD_OPS == 2117
    assert counts.tick_ops(1, 8, 5) == 8 * (2117 + 5 * 4324)


def test_tick_bound_is_operations():
    bound, by = counts.tick_bound_ms(1024, 8, 5)
    assert by == "operations"
    assert round(bound, 4) == 0.0029

"""The post stages' fall reset on non-finite states, on the CPU.

Both post stages (the SRB loop's ``rollout._finish_tick`` and the
articulated loop's ``rollout_art._art_post_stage``) reset an env whose new
simulator state holds a non-finite value, as they reset one out of the
height band: it restarts standing with a cold controller, its clock runs
on, ``metrics.falls`` and the device counter of ``utils/profiling.py``
count it, and its other running sums take nothing from the tick, so they
stay finite. Six envs: 1 with a NaN height, 2 with a NaN velocity (the
SRB state's forward velocity, the articulated state's knee velocity) and a
finite height, 3 with a height of +inf; 4 finite and under the band, 0 and
5 finite inside it. Envs 0, 4 and 5 are bit-equal, leaf by leaf, to the
same stage run on the finite state (the band alone resets env 4 there),
and the finite run resets env 4 only and counts no non-finite reset.
"""

import dataclasses

import pytest
import torch

from biped_mpc_py_torch import fast_mpc_config
from biped_mpc_py_torch.control.controller import ControllerState
from biped_mpc_py_torch.ops.qp import QpSolution
from biped_mpc_py_torch.parallel import rollout, rollout_art
from biped_mpc_py_torch.sim.engine import ArtState
from biped_mpc_py_torch.sim.srb_sim import SrbState
from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.graphs import leaves
from biped_mpc_py_torch.utils.metrics import RolloutMetrics
from torch_threads import one_torch_thread  # noqa: F401

N = 6
BLOWN, BAND, KEPT = [1, 2, 3], [4], [0, 4, 5]


def _randn(gen, *shape, scale=1.0):
    return scale * torch.randn((N,) + shape, generator=gen)


def _solution(gen, mpc):
    h, m = mpc.h, 24
    return QpSolution(controls=_randn(gen, h, 12, scale=50.0), states=_randn(gen, h, 13),
                      z=_randn(gen, h, m), y=_randn(gen, h, m),
                      res_prim=_randn(gen).abs(), res_dual=_randn(gen).abs())


def _metrics(gen):
    return RolloutMetrics(**{f.name: _randn(gen).abs() + 1.0
                             for f in dataclasses.fields(RolloutMetrics)})


def _srb(gen, mpc):
    """(the stage as a function of the new state, the finite new state,
    the same with envs 1-3 not finite, the standing state)."""
    x = SrbState.standing(N).x_fb + _randn(gen, 12, scale=0.01)
    x[4, 5] = 0.1
    sim = SrbState(x_fb=x, foot=SrbState.standing(N).foot, t=torch.full((N,), 0.12))
    bad = x.clone()
    bad[1, 5], bad[2, 9], bad[3, 5] = float("nan"), float("nan"), float("inf")
    sol, metrics = _solution(gen, mpc), _metrics(gen)
    sol.res_prim[2] = float("nan")  # the blown env's solve, not finite either
    cmd, v_int = _randn(gen, 3), _randn(gen, 2)

    def stage(sim_new):
        return rollout._finish_tick(sim_new, sol, cmd, metrics, mpc, v_int)

    return (stage, sim, dataclasses.replace(sim, x_fb=bad), SrbState.standing(N), metrics,
            ControllerState.init(mpc, N))


def _art(gen, mpc):
    base = ArtState.standing(N)
    sim = dataclasses.replace(base, pos=base.pos + _randn(gen, 3, scale=0.01),
                              qd=_randn(gen, 10), t=torch.full((N,), 0.12))
    sim.pos[4, 2] = 0.1
    pos, qd = sim.pos.clone(), sim.qd.clone()
    pos[1, 2], qd[2, 3], pos[3, 2] = float("nan"), float("nan"), float("inf")
    bad = dataclasses.replace(sim, pos=pos, qd=qd)
    world = rollout_art.ArtWorld(sim=base, ctrl=ControllerState.init(mpc, N),
                                 metrics=_metrics(gen))
    sol, x_fb = _solution(gen, mpc), _randn(gen, 12, scale=0.1)
    energy = _randn(gen).abs()
    t_g, hold = torch.full((N,), 0.08), torch.zeros(N, dtype=torch.int32)

    def stage(sim_new):
        e = energy.clone()
        e[~torch.isfinite(sim_new.qd).all(1)] = float("nan")  # work from a NaN velocity
        return rollout_art._art_post_stage(world, sim_new, e, x_fb, sol, t_g, hold, mpc)

    return stage, sim, bad, ArtState.standing(N), world.metrics, ControllerState.init(mpc, N)


@pytest.mark.parametrize("loop", ["srb", "art"])
def test_post_stage_resets_nonfinite_envs(loop):
    mpc = fast_mpc_config() if loop == "srb" else rollout_art.art_mpc_config()
    stage, sim, bad, standing, metrics, cold = (_srb if loop == "srb" else _art)(
        torch.Generator().manual_seed(0), mpc)
    count = profiling.nonfinite_resets("cpu")
    with torch.no_grad():
        clean = stage(sim)
        assert profiling.nonfinite_resets("cpu") == count  # a finite state: the band alone
        out = stage(bad)
    assert profiling.nonfinite_resets("cpu") == count + len(BLOWN)

    # the band alone on the finite state: env 4 falls, the others run on
    assert clean.metrics.falls.tolist() == (metrics.falls + torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 1.0, 0.0])).tolist()
    # every finite env of the corrupted batch is bit-equal to the finite run
    for a, b in zip(leaves(out), leaves(clean), strict=True):
        assert torch.equal(a[KEPT], b[KEPT])
    # the non-finite envs restart standing (clock kept) with a cold controller
    for name in (f.name for f in dataclasses.fields(standing)):
        want = sim.t if name == "t" else getattr(standing, name)
        assert torch.equal(getattr(out.sim, name)[BLOWN], want[BLOWN]), name
    for a, b in zip(leaves(out.ctrl), leaves(cold), strict=True):
        assert torch.equal(a[BLOWN], b[BLOWN])
    # they count the fall and the tick; their other running sums take nothing
    m = out.metrics
    assert torch.equal(m.falls[BLOWN], metrics.falls[BLOWN] + 1)
    assert torch.equal(m.n_steps[BLOWN], metrics.n_steps[BLOWN] + 1)
    for name in ("height_err_sq", "attitude_err_sq", "vel_err_sq", "fz_total",
                 "res_prim_max", "energy"):
        assert torch.equal(getattr(m, name)[BLOWN], getattr(metrics, name)[BLOWN]), name
    assert all(bool(torch.isfinite(t).all()) for t in leaves(out) if t.is_floating_point())


@pytest.mark.parametrize("loop", ["srb", "art"])
def test_fallen_marks_envs_and_counts_nothing(loop):
    """``rollout.fallen`` on the corrupted batch: ``blown`` the three
    non-finite envs, ``fell`` those and the env under the band; it adds
    nothing to the counter (the post stages do)."""
    mpc = fast_mpc_config() if loop == "srb" else rollout_art.art_mpc_config()
    _, _, bad, *_ = (_srb if loop == "srb" else _art)(torch.Generator().manual_seed(0), mpc)
    z = bad.x_fb[:, 5] if loop == "srb" else bad.pos[:, 2]
    count = profiling.nonfinite_resets("cpu")
    fell, blown = rollout.fallen(bad, z)
    assert profiling.nonfinite_resets("cpu") == count
    assert blown.nonzero().flatten().tolist() == BLOWN
    assert fell.nonzero().flatten().tolist() == sorted(BLOWN + BAND)

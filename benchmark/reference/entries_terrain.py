"""The reference's counterpart of the port's rough-ground entry,
``parallel/rollout_art.py::batched_art_rollout_terrain_fn``: one tick of the
plain chain on a height field per env, built from the reference's own parts.
It takes the batched counterparts' signature (``entries.py``) and the
fields of the envs it steps as ``terrains``.

An env can diverge inside the tick (the runaway of ``PERF.md`` §7.1): its
sole points then query the ground at NaN. The frozen ``Terrain.height``
converts such a query to an index off the grid; the fields here answer it
NaN instead, as the port's and JAX's clamped gathers do."""

from __future__ import annotations

import torch

from benchmark.reference import loops
from benchmark.reference.control.lowlevel import low_level_control
from benchmark.reference.sim.contact import Terrain
from benchmark.reference.sim.engine import art_step, feedback_and_soles, mass_matrix_inv
from benchmark.reference.sim.model import hector_model


class OnGrid(Terrain):
    """A height field whose query that is not a number reads NaN; every
    other query reads as the frozen ``Terrain.height``."""

    def height(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = torch.broadcast_tensors(x, y)
        bad = torch.isnan(x) | torch.isnan(y)
        h = super().height(torch.where(bad, 0.0, x), torch.where(bad, 0.0, y))
        return torch.where(bad, torch.nan, h)


def art_terrain_tick(world, bipeds, mpc, gait, x_cmd: torch.Tensor | None = None, *,
                     terrains: Terrain, n_lowlevel: int, n_substeps: int,
                     minv_ll_hold: int):
    """``_art_tick`` of the plain chain with ``terrains`` (N, H, W) under the
    envs: the MPC stage on the ground, one mass-matrix inverse per
    ``minv_ll_hold`` low-level periods, ``n_lowlevel`` periods of low-level
    control on the ground and ``n_substeps`` plain substeps of contact with
    it, the post stage. The physics steps the nominal HECTOR's model, the
    low-level control the per-env ``bipeds``, as the port's plain chain."""
    if x_cmd is not None:
        raise ValueError("the terrain entry takes the configuration's command only")
    if n_lowlevel % minv_ll_hold:
        raise ValueError(f"n_lowlevel {n_lowlevel} is not a multiple of minv_ll_hold "
                         f"{minv_ll_hold}")
    model = hector_model(device=world.sim.q.device)
    terrains = OnGrid(heights=terrains.heights, extent=terrains.extent)
    x_fb, t_g, hold, contact, sol = loops._art_control_stage(world, bipeds, mpc, gait, model,
                                                             terrains)
    u0 = sol.controls[:, 0]
    ll_dt = mpc.dt / n_lowlevel
    sim = world.sim
    t0 = sim.t
    energy = torch.zeros_like(t0)
    for _ in range(n_lowlevel // minv_ll_hold):
        Minv = mass_matrix_inv(model, sim.q)
        for _ in range(minv_ll_hold):
            t_ll = sim.t if not gait.contact_clock else t_g + (sim.t - t0)
            x, pf = feedback_and_soles(model, sim)
            tau = low_level_control(x, t_ll, pf, sim.q, sim.qd, mpc, bipeds, contact, u0,
                                    gait=gait, cmd_ref=world.ctrl.cmd_ref, terrain=terrains,
                                    v_int=world.ctrl.v_int)
            energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
            sim = art_step(model, sim, tau, ll_dt, n_substeps, terrains, Minv=Minv)
    return loops._art_post_stage(world, sim, energy, x_fb, sol, t_g, hold, mpc)

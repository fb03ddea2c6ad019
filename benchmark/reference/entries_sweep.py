"""The reference's counterpart of the port's sweep entry,
``parallel/sweep.py::art_sweep_fn`` at the tick path's Minv hold: one tick of
the articulated tick path with a config per env, built from the reference's
own parts, which take per-env commands (``x_cmd``) and per-env fields
(``per_env``, ``config.py``). The frozen ``ops/physics.py::fused_tick``
closes over one config, so the periods below the MPC are written out here
with each env's values."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import loops
from benchmark.reference.control.lowlevel import low_level_control
from benchmark.reference.ops.physics import fused_substeps
from benchmark.reference.sim.engine import feedback_and_soles, mass_matrix_inv
from benchmark.reference.sim.model import hector_model


def art_sweep_tick(world, bipeds, mpc, gait, x_cmd: torch.Tensor | None = None, *,
                   per_env: dict, n_lowlevel: int, n_substeps: int, minv_ll_hold: int):
    """One tick of the tick path with env i under its own config: the MPC
    stage with each env's command, weights and ADMM numerics, one
    mass-matrix inverse held all tick, ``n_lowlevel`` periods of feedback,
    low-level control with each env's command, gains and robot at the
    tick's clock ``t0 + p ll_dt``, and ``n_substeps`` plain substeps (which
    advance ``t`` once a period), then ``t`` set one MPC step on, as the
    tick kernel's clock does, and the post stage with each env's command
    shaping and fall reset. The physics steps the nominal HECTOR's model,
    the low-level control the per-env ``bipeds``. ``x_cmd`` (N,12);
    ``per_env`` the other fields ((N,) each, ``Q`` (N,13), ``R`` (N,12));
    one ``dt`` (``mpc.dt``)."""
    if minv_ll_hold != n_lowlevel:
        raise ValueError("the tick path holds one mass-matrix inverse a tick "
                         f"(minv_ll_hold {minv_ll_hold} != n_lowlevel {n_lowlevel})")
    if "dt" in per_env:
        raise ValueError("the tick path steps one dt: no per-env dt")
    model = hector_model(device=world.sim.q.device)
    x_fb, t_g, hold, contact, sol = loops._art_control_stage(world, bipeds, mpc, gait, model,
                                                             None, x_cmd, per_env)
    u0 = sol.controls[:, 0]
    sim = world.sim
    t0 = t_g if gait.contact_clock else sim.t
    Minv = mass_matrix_inv(model, sim.q)
    ll_dt = mpc.dt / n_lowlevel
    energy = torch.zeros_like(t0)
    for p in range(n_lowlevel):
        x, pf = feedback_and_soles(model, sim)
        tau = low_level_control(x, t0 + p * ll_dt, pf, sim.q, sim.qd, mpc, bipeds, contact, u0,
                                gait=gait, cmd_ref=world.ctrl.cmd_ref, v_int=world.ctrl.v_int,
                                x_cmd=x_cmd, per_env=per_env)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
        sim = fused_substeps(model, sim, tau, Minv, ll_dt, n_substeps)
    sim = dataclasses.replace(sim, t=world.sim.t + mpc.dt)
    return loops._art_post_stage(world, sim, energy, x_fb, sol, t_g, hold, mpc, x_cmd, per_env)

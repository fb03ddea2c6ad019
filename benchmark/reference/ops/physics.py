"""The physics kernels' plain versions, frozen: a tick of low-level control
and substeps (``csrc/tick.cu``) and a low-level period's substeps
(``csrc/substep.cu``), in plain PyTorch."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import GaitConfig, MpcConfig
from benchmark.reference.control.lowlevel import low_level_control
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.sim.engine import ArtState, art_substep, feedback_and_soles
from benchmark.reference.sim.model import ArticulatedModel


def fused_substeps(model: ArticulatedModel, state: ArtState,
                             tau: torch.Tensor, Minv: torch.Tensor, dt: float,
                             n_steps: int) -> ArtState:
    """The plain version of the substep kernel (``csrc/substep.cu``): ``n_steps`` calls
    of ``art_substep`` with the held ``Minv``, then ``t + dt``."""
    t = state.t
    sub_dt = dt / n_steps
    for _ in range(n_steps):
        state = art_substep(model, state, tau, sub_dt, Minv=Minv)
    return dataclasses.replace(state, t=t + dt)


def fused_tick(model: ArticulatedModel, biped: BipedParams, mpc: MpcConfig,
                         gait: GaitConfig, state: ArtState, u0: torch.Tensor,
                         c0: torch.Tensor, t0: torch.Tensor, cmd_yaw: torch.Tensor,
                         v_int: torch.Tensor, Minv: torch.Tensor, n_lowlevel: int = 8,
                         n_substeps: int = 5) -> tuple[ArtState, torch.Tensor]:
    """The plain version of the tick kernel (``csrc/tick.cu``): per period,
    ``feedback_and_soles``, ``low_level_control`` at ``t0 + p ll_dt`` (contact
    row 0 = ``c0``, command yaw = ``cmd_yaw``), the positive work, and
    ``fused_substeps``; then ``t + mpc.dt``."""
    n = state.q.shape[0]
    bipeds = biped.expand(n)
    contact = c0[:, None, :]
    cmd_ref = torch.stack([torch.zeros_like(cmd_yaw), torch.zeros_like(cmd_yaw), cmd_yaw], -1)
    ll_dt = mpc.dt / n_lowlevel
    energy = torch.zeros_like(t0)
    sim = state
    for p in range(n_lowlevel):
        x, pf = feedback_and_soles(model, sim)
        tau = low_level_control(x, t0 + p * ll_dt, pf, sim.q, sim.qd, mpc, bipeds, contact,
                                u0, gait=gait, cmd_ref=cmd_ref, v_int=v_int)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
        sim = fused_substeps(model, sim, tau, Minv, ll_dt, n_substeps)
    return dataclasses.replace(sim, t=state.t + mpc.dt), energy

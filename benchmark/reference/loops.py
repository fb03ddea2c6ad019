"""The closed-loop ticks the benchmark's cells time, frozen in plain PyTorch.

- :func:`srb_tick`: one tick of the batched SRB loop with per-env commands
  (``parallel/rollout.py::batched_closed_loop_tick``): contact schedule,
  references, linearization, condensing, Ruiz, the QP core, unscaling, the
  SRB step, fall reset and metrics.
- :func:`art_tick`: one tick of the articulated tick path
  (``parallel/rollout_art.py::_tick_kernel_tick``): feedback, the MPC stage,
  one mass-matrix inverse held all tick, the tick kernel's plain version,
  the post stage.
- :func:`realtime_solve` and :func:`realtime_lowlevel`: the two graphs of
  the one-robot loop (``runtime/realtime.py``), the solve and one
  low-level period, from a read of the plant.

Every matmul runs at the precision of the caller's
:func:`benchmark.reference.precision.matmul` block.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import GaitConfig, MpcConfig
from benchmark.reference.control.controller import (
    ControllerState,
    advance_cmd_ref,
    advance_pitch_ref,
    advance_v_int,
)
from benchmark.reference.control.gait import (
    advance_gait_clock,
    contact_sequence,
    measured_contact,
)
from benchmark.reference.control.lowlevel import low_level_control
from benchmark.reference.control.mpc import build_mpc_qp, solve_mpc
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.ops.physics import fused_tick
from benchmark.reference.ops.qp import QpSolution, solve_qp
from benchmark.reference.sim.engine import (
    ArtState,
    feedback_and_soles,
    mass_matrix_inv,
)
from benchmark.reference.sim.model import ArticulatedModel
from benchmark.reference.sim.srb_sim import SrbState, srb_step
from benchmark.reference.utils.device import DEFAULT_DEVICE, entry_device
from benchmark.reference.utils.metrics import RolloutMetrics
from benchmark.reference.utils.struct import TensorStruct

# fall detection band [m]: outside -> reset
FALL_Z_MIN = 0.25
SRB_FALL_Z_MAX = 0.85
ART_FALL_Z_MAX = 0.85


@dataclasses.dataclass(frozen=True)
class World(TensorStruct):
    """Every env's complete world state."""

    sim: SrbState
    ctrl: ControllerState
    metrics: RolloutMetrics


def init_world(mpc: MpcConfig, n: int = 1, device=DEFAULT_DEVICE,
               z0: float = 0.53) -> World:
    """``n`` standing envs at rest, on the card unless ``device`` names
    another (raises without a card)."""
    device = entry_device(device)
    return World(
        sim=SrbState.standing(n, z0=z0, device=device),
        ctrl=ControllerState.init(mpc, n, device=device),
        metrics=RolloutMetrics.zeros(n, device=device),
    )


def _finish_tick(sim_new: SrbState, sol: QpSolution, cmd_ref: torch.Tensor,
                 metrics: RolloutMetrics, mpc: MpcConfig,
                 v_int: torch.Tensor | None = None,
                 x_cmd: torch.Tensor | None = None) -> World:
    """Per-env fall detection, in-batch reset and metrics update
    (``rollout.py:54``). A fallen env restarts standing with a cold
    controller; its clock ``t`` runs on."""
    x = sim_new.x_fb
    n, dtype, device = x.shape[0], x.dtype, x.device
    z = x[:, 5]
    fell = (z < FALL_Z_MIN) | (z > SRB_FALL_Z_MAX)
    reset = dataclasses.replace(
        SrbState.standing(n, device=device, dtype=dtype), t=sim_new.t
    )
    sim_next = sim_new.where(fell, reset)
    if v_int is None:
        v_int = torch.zeros((n, 2), dtype=dtype, device=device)
    zeros = torch.zeros(n, dtype=dtype, device=device)
    carried = ControllerState(
        qp=sol, cmd_ref=cmd_ref, v_int=v_int, t_gait=zeros,
        hold_count=torch.zeros(n, dtype=torch.int32, device=device),
        pitch_ref=zeros,
    )
    ctrl_next = carried.where(fell, ControllerState.init(mpc, n, device, dtype, x_cmd))
    metrics = metrics.update(x, mpc.x_cmd if x_cmd is None else x_cmd,
                             sol.controls[:, 0], sol.res_prim, fell.to(dtype))
    return World(sim=sim_next, ctrl=ctrl_next, metrics=metrics)


def srb_tick(
    world: World, mpc: MpcConfig, gait: GaitConfig, biped: BipedParams,
    x_cmd: torch.Tensor | None = None,
) -> World:
    """One fused sim+MPC tick for every env (``rollout.py:100``); the QP
    solve is one ``fused_qp_solve`` call for the whole batch. ``x_cmd``
    ((12,) or (N,12)) overrides ``mpc.x_cmd`` throughout the tick."""
    sim = world.sim
    contact = contact_sequence(sim.t, mpc, gait)
    qp = build_mpc_qp(
        sim.x_fb, sim.t, sim.foot, mpc, biped, contact, gait,
        world.ctrl.cmd_ref, v_int=world.ctrl.v_int, x_cmd=x_cmd,
    )
    sol = solve_qp(qp, mpc, warm=world.ctrl.qp)
    sim_new = srb_step(sim, sol.controls[:, 0], mpc, gait, biped, x_cmd=x_cmd)
    ref_next = advance_cmd_ref(world.ctrl.cmd_ref, sim.x_fb, mpc, x_cmd)
    vi_next = advance_v_int(world.ctrl.v_int, sim.x_fb, mpc, x_cmd)
    return _finish_tick(sim_new, sol, ref_next, world.metrics, mpc, vi_next, x_cmd)


@dataclasses.dataclass(frozen=True)
class ArtWorld(TensorStruct):
    """Every env's articulated world state."""

    sim: ArtState
    ctrl: ControllerState
    metrics: RolloutMetrics


def init_art_world(mpc: MpcConfig, n: int = 1, device=DEFAULT_DEVICE,
                   z0: float = 0.533) -> ArtWorld:
    """``n`` standing envs at rest with cold controllers, on the card
    unless ``device`` names another (raises without a card)."""
    device = entry_device(device)
    return ArtWorld(
        sim=ArtState.standing(n, z0=z0, device=device),
        ctrl=ControllerState.init(mpc, n, device=device),
        metrics=RolloutMetrics.zeros(n, device=device),
    )


def _art_control_stage(world: ArtWorld, biped: BipedParams, mpc: MpcConfig,
                       gait: GaitConfig, model: ArticulatedModel, terrain=None,
                       x_cmd: torch.Tensor | None = None,
                       per_env: dict | None = None):
    """The MPC stage of a tick (``rollout_art.py:419``): feedback -> gait
    clock -> contact schedule -> solve_mpc. Returns (x_fb, t_g, hold,
    contact, sol). ``x_cmd`` ((12,) or (N,12)) overrides ``mpc.x_cmd``,
    ``per_env`` the config's other fields (``config.py``)."""
    sim = world.sim
    x_fb, pf_w = feedback_and_soles(model, sim)
    if gait.contact_clock:
        down = measured_contact(pf_w, terrain, gait)
        t_g, hold = advance_gait_clock(
            world.ctrl.t_gait, world.ctrl.hold_count, down, mpc, gait, per_env
        )
    else:
        t_g, hold = sim.t, world.ctrl.hold_count
    contact = contact_sequence(t_g, mpc, gait, per_env)
    foot_yaw = x_fb[:, 2:3] + sim.q[:, 0:6:5] if mpc.foot_frame_wrench else None
    sol = solve_mpc(
        x_fb, t_g, pf_w, mpc, biped, contact, warm=world.ctrl.qp, gait=gait,
        cmd_ref=world.ctrl.cmd_ref, foot_yaw=foot_yaw, terrain=terrain,
        v_int=world.ctrl.v_int, pitch_ref=world.ctrl.pitch_ref, x_cmd=x_cmd,
        per_env=per_env,
    )
    return x_fb, t_g, hold, contact, sol


def _art_post_stage(world: ArtWorld, sim_new: ArtState, energy, x_fb, sol,
                    t_g, hold, mpc: MpcConfig,
                    x_cmd: torch.Tensor | None = None,
                    per_env: dict | None = None) -> ArtWorld:
    """Fall reset, controller-state advance and metrics
    (``rollout_art.py:446``). A fallen env restarts standing with a cold
    controller; its clock runs on. ``x_cmd`` ((12,) or (N,12)) overrides
    ``mpc.x_cmd``, the metrics' command included; ``per_env`` the config's
    other fields."""
    n, dtype, device = x_fb.shape[0], x_fb.dtype, x_fb.device
    z = sim_new.pos[:, 2]
    fell = (z < FALL_Z_MIN) | (z > ART_FALL_Z_MAX)
    reset = dataclasses.replace(
        ArtState.standing(n, device=device, dtype=dtype), t=sim_new.t
    )
    ctrl = ControllerState(
        qp=sol,
        cmd_ref=advance_cmd_ref(world.ctrl.cmd_ref, x_fb, mpc, x_cmd, per_env),
        v_int=advance_v_int(world.ctrl.v_int, x_fb, mpc, x_cmd, per_env),
        t_gait=t_g.to(dtype), hold_count=hold,
        pitch_ref=advance_pitch_ref(world.ctrl.pitch_ref, x_fb, mpc, per_env),
    )
    metrics = world.metrics.update(
        sim_new.torso_state(), mpc.x_cmd if x_cmd is None else x_cmd,
        sol.controls[:, 0], sol.res_prim, fell.to(dtype), energy=energy,
    )
    return ArtWorld(
        sim=sim_new.where(fell, reset),
        ctrl=ctrl.where(fell, ControllerState.init(mpc, n, device, dtype, x_cmd, per_env)),
        metrics=metrics,
    )


def art_tick(w: ArtWorld, bipeds: BipedParams, mpc: MpcConfig, gait: GaitConfig,
                      model: ArticulatedModel, biped: BipedParams, n_lowlevel: int,
                      n_substeps: int) -> ArtWorld:
    """One tick of the tick-kernel path: the MPC stage, one mass-matrix
    inverse, one ``fused_tick``, the post stage."""
    x_fb, t_g, hold, contact, sol = _art_control_stage(w, bipeds, mpc, gait, model)
    sim = w.sim
    t0 = t_g if gait.contact_clock else sim.t
    Minv = mass_matrix_inv(model, sim.q)
    sim_new, energy = fused_tick(
        model, biped, mpc, gait, sim, sol.controls[:, 0], contact[:, 0, 0:2], t0,
        w.ctrl.cmd_ref[:, 2], w.ctrl.v_int, Minv, n_lowlevel, n_substeps,
    )
    return _art_post_stage(w, sim_new, energy, x_fb, sol, t_g, hold, mpc)



def realtime_solve(read: torch.Tensor, qp: QpSolution, cmd_ref: torch.Tensor,
                   v_int: torch.Tensor, mpc: MpcConfig, gait: GaitConfig,
                   biped: BipedParams):
    """The one-robot loop's solve from a read (N,39) = [x_fb, soles, q, qd,
    t] and the carried controller state (``runtime/realtime.py``'s solve
    graph, batched over independent reads) -> (sol, cmd_ref, v_int,
    contact, u0, v_int_ll)."""
    x, pf, t = read[:, 0:12], read[:, 12:18], read[:, 38]
    contact = contact_sequence(t, mpc, gait)
    sol = solve_mpc(x, t, pf, mpc, biped, contact, warm=qp, gait=gait,
                    cmd_ref=cmd_ref, v_int=v_int)
    return (sol, advance_cmd_ref(cmd_ref, x, mpc), advance_v_int(v_int, x, mpc),
            contact, sol.controls[:, 0], v_int)


def realtime_lowlevel(read: torch.Tensor, contact: torch.Tensor, u0: torch.Tensor,
                      cmd_ref: torch.Tensor, v_int_ll: torch.Tensor, mpc: MpcConfig,
                      gait: GaitConfig, biped: BipedParams) -> torch.Tensor:
    """One low-level period's torques (N,10) from a read (N,39), the tick's
    schedule, first control, advanced ``cmd_ref`` and the ``v_int`` from
    before the tick's advance (``runtime/realtime.py``'s low-level graph)."""
    r = read
    return low_level_control(r[:, 0:12], r[:, 38], r[:, 12:18], r[:, 18:28], r[:, 28:38],
                             mpc, biped, contact, u0, gait=gait, cmd_ref=cmd_ref,
                             v_int=v_int_ll)

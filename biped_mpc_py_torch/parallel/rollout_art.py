"""Batched closed-loop rollouts on the articulated engine: the counterpart of
``biped_mpc_py_tpu/parallel/rollout_art.py``.

One 40 ms tick for every env:

  25 Hz   MPC: feedback (whole-body CoM, sole positions) -> contact
          schedule -> references -> SRB linearization -> condensed QP ->
          the fused ADMM solve (one CUDA launch on the card)
  200 Hz  low-level: swing PD + Jᵀ torque map, re-evaluated on the current
          articulated state while holding the first MPC control
  1 kHz   physics: the leg-vectorized Featherstone substeps

then fall reset, controller-state advance and metrics. The mass-matrix
inverse is refreshed once per group of ``minv_ll_hold`` low-level periods.

Four entry points differ in how the work below the MPC layer runs:
:func:`batched_art_rollout_tick_kernel` runs the whole low-level + physics
hierarchy of a tick in one fused tick-kernel launch (the counterpart of
``batched_art_rollout_tick_kernel_fn`` and of ``bench.py BENCH_MODE=art
BENCH_ART_BACKEND=tick``); :func:`batched_art_rollout_kernel` launches the
fused substep kernel once per low-level period (the counterpart of
``batched_art_rollout_kernel_fn``, ``BENCH_ART_BACKEND=kernel``);
:func:`batched_art_rollout` runs the plain ``art_step`` chain (the
counterpart of ``batched_art_rollout_fn``), on the plane z = 0 or on one
height field under every env; :func:`batched_art_rollout_terrain` runs the
same chain with a height field per env (the counterpart of
``batched_art_rollout_terrain_fn`` and of ``bench.py BENCH_TERRAIN``). The
two kernels know flat ground only, as the TPU kernels do, so a terrain runs
the plain chain in both packages. :func:`batched_art_rollout_tick_kernel_fn`
and :func:`batched_art_rollout_kernel_fn` are the compiled forms of the
two kernel paths, :func:`batched_art_rollout_fn` and
:func:`batched_art_rollout_terrain_fn` those of the plain chain: the
counterparts of ``jax.jit`` of the JAX factories, one tick captured as a
CUDA graph and replayed (``utils/graphs.py``). The JAX package's single-env
``art_rollout_fn`` has no separate port: the batched functions at N = 1 are
its counterpart (``sim/replay.py`` replays the plain chain's graph at N =
1).
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig, config_value
from biped_mpc_py_torch.control.controller import (
    ControllerState,
    advance_cmd_ref,
    advance_pitch_ref,
    advance_v_int,
)
from biped_mpc_py_torch.control.gait import (
    advance_gait_clock,
    contact_sequence,
    gait_for_speed,
    measured_contact,
)
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick
from biped_mpc_py_torch.ops.qp import solve_qp
from biped_mpc_py_torch.parallel.rollout import fallen
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.engine import (
    ArtState,
    art_step,
    feedback_and_soles,
    mass_matrix_inv,
)
from biped_mpc_py_torch.sim.model import ArticulatedModel, hector_model
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.graphs import graphed
from biped_mpc_py_torch.utils.metrics import RolloutMetrics
from biped_mpc_py_torch.utils.precision import f32_precision
from biped_mpc_py_torch.utils.profiling import count_nonfinite, stage
from biped_mpc_py_torch.utils.struct import TensorStruct

FALL_Z_MIN = 0.25
FALL_Z_MAX = 0.85


def _x_cmd(vx: float = 0.0, wz: float = 0.0, vy: float = 0.0) -> tuple:
    x = [0.0] * 12
    x[5], x[8], x[9], x[10] = 0.55, wz, vx, vy
    return tuple(x)


def art_mpc_config(**overrides) -> MpcConfig:
    """MpcConfig tuned for the articulated closed loop (``rollout_art.py:43``):
    swing height 0.04, capture gain 0.5, stance width 0.04, foot-heading
    wrench 2.4/0.3, yaw-couple bound 8, touchdown damping 8, heel margin
    0.015. The JAX docstring gives the measurement behind each."""
    cfg = dataclasses.replace(
        MpcConfig(), swing_height=0.04, raibert_capture_gain=0.5,
        swing_y_offset=0.04, kp_hipyaw=2.4, kd_hipyaw=0.3, tau_z_max=8.0,
        swing_td_damp=8.0, lf_heel_shrink=0.015,
    )
    return dataclasses.replace(cfg, **overrides)


def art_config_for_speed(speed: float, **overrides):
    """(MpcConfig, GaitConfig) for a commanded forward speed
    (``rollout_art.py:106``): cadence by speed band, sin² swing above
    0.3 m/s, a higher apex and softer capture gain from 0.9 m/s."""
    s = abs(float(speed))
    if s > 0.3:
        overrides.setdefault("swing_z_sin2", True)
    if s >= 0.9:
        overrides.setdefault("swing_height", 0.06)
        overrides.setdefault("raibert_capture_gain", 0.3)
    return art_mpc_config(x_cmd=_x_cmd(vx=float(speed)), **overrides), gait_for_speed(s)


def art_config_for_run(speed: float, stabilized: bool = False, **overrides):
    """(MpcConfig, GaitConfig) for the running gait, p = 2 with one flight
    step (``rollout_art.py:141``); ``stabilized`` adds the measured
    stabilizer triple. Explicit ``overrides`` win."""
    kw = dict(
        swing_z_sin2=True, swing_height=0.08, raibert_capture_gain=0.3,
        swing_land_frac=0.8, swing_y_offset=0.06, raibert_ff_scale=0.85,
        swing_track_ff=1.0,
    )
    if stabilized:
        kw.update(
            raibert_ff_scale=0.77, raibert_pitch_place=0.2,
            raibert_pitch_nom=0.15, swing_land_frac=0.7,
        )
    kw.update(overrides)
    return (art_mpc_config(x_cmd=_x_cmd(vx=float(speed)), **kw),
            GaitConfig(steps_per_phase=2, flight_steps=1))


def art_config_for_turn(wz: float, vx: float = 0.0, **overrides):
    """(MpcConfig, GaitConfig) for a commanded turn rate [rad/s], optionally
    while walking at ``vx`` (``rollout_art.py:192``): the unified
    turn-in-place point up to 0.3 rad/s, else no heading wrench and a
    faster yaw leak."""
    x_cmd = _x_cmd(vx=float(vx), wz=float(wz))
    if abs(vx) < 0.05 and abs(wz) <= 0.3:
        kw = dict(cmd_body_frame=True, kp_hipyaw=3.0, kd_hipyaw=0.4, swing_z_sin2=True)
        kw.update(overrides)
        return art_mpc_config(x_cmd=x_cmd, **kw), GaitConfig(steps_per_phase=3)
    kw = dict(cmd_body_frame=True, kp_hipyaw=0.0, kd_hipyaw=0.0, cmd_leak_yaw=0.12)
    if abs(vx) >= 0.35:
        kw["swing_z_sin2"] = True
        gait = gait_for_speed(abs(vx))
    else:
        gait = GaitConfig(steps_per_phase=3)
    kw.update(overrides)
    return art_mpc_config(x_cmd=x_cmd, **kw), gait


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
    clock -> contact schedule -> the MPC's QP -> its solve (``solve_mpc``'s
    two steps, as stages ``art.feedback``, ``mpc.build`` and the solve's
    three: ``utils/profiling.py``). Returns (x_fb, t_g, hold, contact,
    sol). ``x_cmd`` ((12,) or (N,12)) overrides ``mpc.x_cmd``, ``per_env``
    the config's other fields (``config.py``)."""
    sim = world.sim
    with stage("art.feedback"):
        x_fb, pf_w = feedback_and_soles(model, sim)
        if gait.contact_clock:
            down = measured_contact(pf_w, terrain, gait)
            t_g, hold = advance_gait_clock(
                world.ctrl.t_gait, world.ctrl.hold_count, down, mpc, gait, per_env
            )
        else:
            t_g, hold = sim.t, world.ctrl.hold_count
    with stage("mpc.build"):
        contact = contact_sequence(t_g, mpc, gait, per_env)
        foot_yaw = x_fb[:, 2:3] + sim.q[:, 0:6:5] if mpc.foot_frame_wrench else None
        qp = build_mpc_qp(
            x_fb, t_g, pf_w, mpc, biped, contact, gait, world.ctrl.cmd_ref, foot_yaw,
            terrain, world.ctrl.v_int, world.ctrl.pitch_ref, x_cmd, per_env,
        )
    sol = solve_qp(qp, mpc, world.ctrl.qp, per_env)
    return x_fb, t_g, hold, contact, sol


def _art_post_stage(world: ArtWorld, sim_new: ArtState, energy, x_fb, sol,
                    t_g, hold, mpc: MpcConfig,
                    x_cmd: torch.Tensor | None = None,
                    per_env: dict | None = None) -> ArtWorld:
    """Fall reset, controller-state advance and metrics
    (``rollout_art.py:446``). A fallen env (``rollout.fallen``: out of the
    height band, or not finite) restarts standing with a cold controller;
    its clock runs on, and a non-finite env's running sums take only the
    tick and the fall. ``x_cmd`` ((12,) or (N,12)) overrides
    ``mpc.x_cmd``, the metrics' command included; ``per_env`` the config's
    other fields. The stage ``tick.post``."""
    with stage("tick.post"):
        n, dtype, device = x_fb.shape[0], x_fb.dtype, x_fb.device
        fell, blown = fallen(sim_new, sim_new.pos[:, 2], FALL_Z_MIN, FALL_Z_MAX)
        count_nonfinite(blown)
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
        ).keep(blown, world.metrics)
        return ArtWorld(
            sim=sim_new.where(fell, reset),
            ctrl=ctrl.where(fell, ControllerState.init(mpc, n, device, dtype, x_cmd, per_env)),
            metrics=metrics,
        )


def _lowlevel_stage(model, sim, t_ll, contact, u0, world, biped, mpc, gait,
                    terrain=None, x_cmd=None, per_env=None):
    """Joint torques of one low-level period on the current state."""
    x, pf = feedback_and_soles(model, sim)
    return low_level_control(
        x, t_ll, pf, sim.q, sim.qd, mpc, biped, contact, u0, gait=gait,
        cmd_ref=world.ctrl.cmd_ref, terrain=terrain, v_int=world.ctrl.v_int,
        x_cmd=x_cmd, per_env=per_env,
    )


def _art_tick(world: ArtWorld, biped: BipedParams, mpc: MpcConfig,
              gait: GaitConfig, model: ArticulatedModel, n_lowlevel: int,
              minv_ll_hold: int, physics, terrain=None,
              x_cmd: torch.Tensor | None = None,
              per_env: dict | None = None) -> ArtWorld:
    """One tick; ``physics(sim, tau, Minv, ll_dt)`` advances a low-level
    period (``ll_dt`` a float, or (N,) with a per-env ``dt``). The MPC
    stage and the low-level control take their references from
    ``terrain``; the ground under ``physics`` is the caller's. ``x_cmd``
    and ``per_env`` override the config's fields (``config.py``). Every
    low-level period, its mass-matrix inverses and physics included, is
    the one stage ``art.lowlevel``."""
    if n_lowlevel % minv_ll_hold:
        raise ValueError(
            f"n_lowlevel {n_lowlevel} is not a multiple of minv_ll_hold {minv_ll_hold}"
        )
    x_fb, t_g, hold, contact, sol = _art_control_stage(
        world, biped, mpc, gait, model, terrain, x_cmd, per_env
    )
    u0 = sol.controls[:, 0]
    ll_dt = config_value(mpc, "dt", per_env) / n_lowlevel
    sim = world.sim
    t0 = sim.t
    energy = torch.zeros_like(t0)
    with stage("art.lowlevel"):
        for _ in range(n_lowlevel // minv_ll_hold):
            # one mass-matrix inverse per group of low-level periods
            Minv = mass_matrix_inv(model, sim.q)
            for _ in range(minv_ll_hold):
                # gait-local low-level clock: the within-tick offset on the
                # (possibly held) MPC gait time
                t_ll = sim.t if not gait.contact_clock else t_g + (sim.t - t0)
                tau = _lowlevel_stage(model, sim, t_ll, contact, u0, world, biped, mpc,
                                      gait, terrain, x_cmd, per_env)
                # positive mechanical joint work this period (metrics.energy)
                energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
                sim = physics(sim, tau, Minv, ll_dt)
    return _art_post_stage(world, sim, energy, x_fb, sol, t_g, hold, mpc, x_cmd, per_env)


def art_closed_loop_tick(world: ArtWorld, mpc: MpcConfig, gait: GaitConfig,
                         biped: BipedParams, model: ArticulatedModel,
                         n_lowlevel: int = 8, n_substeps: int = 10,
                         terrain=None, minv_ll_hold: int = 1,
                         x_cmd: torch.Tensor | None = None,
                         per_env: dict | None = None) -> ArtWorld:
    """One full MPC period on the articulated robot with the plain substep
    chain (``rollout_art.py:254``). ``minv_ll_hold`` low-level periods share
    one Newton-Schulz mass-matrix inverse: 1 refreshes it every 5 ms, 8
    once per tick. ``terrain``: the :class:`Terrain` under the robots (one
    field for all, or one per env), None = the plane z = 0; contact, the
    measured contact, the CoM height and foot references and the swing
    apex all follow it. ``x_cmd`` ((12,) or (N,12)) and ``per_env`` (any
    of ``config.PER_ENV_FIELDS`` and ``config.MPC_PER_ENV_FIELDS`` as (N,)
    tensors, ``Q`` and ``R`` as (N,13) and (N,12)) override the config's,
    as a config batched under vmap does in JAX (``parallel/sweep.py``); a
    per-env ``dt`` steps each env's physics by its own period."""

    def physics(sim, tau, Minv, dt):
        return art_step(model, sim, tau, dt, n_substeps, terrain, Minv=Minv)

    return _art_tick(world, biped, mpc, gait, model, n_lowlevel, minv_ll_hold, physics,
                     terrain, x_cmd, per_env)


@f32_precision
@torch.no_grad()
def batched_art_rollout(worlds: ArtWorld, bipeds: BipedParams, n_steps: int,
                        mpc: MpcConfig, gait: GaitConfig,
                        model: ArticulatedModel | None = None,
                        n_lowlevel: int = 8, n_substeps: int = 10,
                        minv_ll_hold: int = 1,
                        terrain: Terrain | None = None) -> ArtWorld:
    """``n_steps`` articulated ticks with the plain substep chain: the
    counterpart of ``batched_art_rollout_fn(n_steps, mpc, gait, model,
    n_lowlevel=, n_substeps=, minv_ll_hold=, terrain=)``, and at N = 1 of
    ``art_rollout_fn``. ``worlds`` and ``bipeds`` share the env axis and
    the device. ``terrain``: one height field under every env (None = the
    plane z = 0); :func:`batched_art_rollout_terrain` takes one per env."""
    step = _plain_step(mpc, gait, model, n_lowlevel, n_substeps, minv_ll_hold, terrain)
    w = worlds
    for _ in range(n_steps):
        w = step(w, bipeds)
    return w


@f32_precision
@torch.no_grad()
def batched_art_rollout_terrain(worlds: ArtWorld, bipeds: BipedParams,
                                terrains: Terrain, n_steps: int, mpc: MpcConfig,
                                gait: GaitConfig,
                                model: ArticulatedModel | None = None,
                                n_lowlevel: int = 8, n_substeps: int = 10,
                                minv_ll_hold: int = 1) -> ArtWorld:
    """``n_steps`` articulated ticks with a height field per env: the
    counterpart of ``batched_art_rollout_terrain_fn(n_steps, mpc, gait,
    model, n_lowlevel, n_substeps, minv_ll_hold)(worlds, bipeds,
    terrains)``, randomized robots on randomized rough ground.
    ``terrains.heights`` is (N, H, W) with the worlds' env axis
    (``Terrain.rough_batch``). Runs the plain substep chain, as in JAX: the
    physics kernels know flat ground only."""
    _check_terrains(worlds, terrains)
    step = _plain_step(mpc, gait, model, n_lowlevel, n_substeps, minv_ll_hold)
    w = worlds
    for _ in range(n_steps):
        w = step(w, bipeds, terrains)
    return w


def _check_terrains(worlds: ArtWorld, terrains: Terrain) -> None:
    n = worlds.sim.q.shape[0]
    if not terrains.batched or terrains.heights.shape[0] != n:
        raise ValueError(
            f"terrains.heights of shape {tuple(terrains.heights.shape)} has no "
            f"env axis of the worlds' size {n}"
        )


def _plain_step(mpc: MpcConfig, gait: GaitConfig, model: ArticulatedModel | None = None,
                n_lowlevel: int = 8, n_substeps: int = 10, minv_ll_hold: int = 1,
                terrain: Terrain | None = None):
    """``step(worlds, bipeds, terrains=None, per_env=None) -> worlds``: one
    tick of the plain chain, the body of its eager loops and of their
    compiled forms. ``terrain`` (a shared field) is a constant; ``terrains``
    (a field per env) and ``per_env`` (:func:`~biped_mpc_py_torch.parallel.
    sweep.stack_configs`'s, ``x_cmd`` included) are inputs."""

    def step(w, bipeds, terrains=None, per_env=None):
        m = model or _defaults(w.sim.q.device)[0]
        fields = x_cmd = None
        if per_env is not None:
            fields = {k: v for k, v in per_env.items() if k != "x_cmd"}
            x_cmd = per_env.get("x_cmd")
        return art_closed_loop_tick(w, mpc, gait, bipeds, m, n_lowlevel, n_substeps,
                                    terrain if terrains is None else terrains, minv_ll_hold,
                                    x_cmd=x_cmd, per_env=fields)

    return step


def batched_art_rollout_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                           model: ArticulatedModel | None = None, n_lowlevel: int = 8,
                           n_substeps: int = 10, minv_ll_hold: int = 1,
                           terrain: Terrain | None = None):
    """``fn(worlds, bipeds) -> worlds``: ``n_steps`` ticks of the plain
    chain, the counterpart of ``jax.jit(batched_art_rollout_fn(n_steps,
    mpc, gait, model, n_lowlevel=, n_substeps=, minv_ll_hold=, terrain=))``.
    On the card the first call with a shape captures one tick (the MPC
    stage with its QP-kernel launch, the mass-matrix inverses, ``n_lowlevel``
    low-level stages of ``n_substeps`` plain substeps each, the post stage)
    as a CUDA graph and every call replays it ``n_steps`` times
    (``utils/graphs.py``); on the CPU the same static buffers step eagerly.
    ``model`` and the shared field ``terrain`` are factory constants, as in
    JAX. Bit-equal to :func:`batched_art_rollout`."""
    return graphed(_plain_step(mpc, gait, model, n_lowlevel, n_substeps, minv_ll_hold,
                               terrain), n_steps)


def batched_art_rollout_terrain_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                                   model: ArticulatedModel | None = None,
                                   n_lowlevel: int = 8, n_substeps: int = 10,
                                   minv_ll_hold: int = 1):
    """``fn(worlds, bipeds, terrains) -> worlds``: ``n_steps`` ticks of the
    plain chain with a height field per env, the counterpart of
    ``jax.jit(batched_art_rollout_terrain_fn(n_steps, mpc, gait, model,
    n_lowlevel, n_substeps, minv_ll_hold))``. ``terrains`` (N, H, W) is an
    input of the graph, as the JAX function's argument: new fields of the
    same shape and ``extent`` replay the same graph, another ``extent``
    captures another. Bit-equal to :func:`batched_art_rollout_terrain`."""
    run = graphed(_plain_step(mpc, gait, model, n_lowlevel, n_substeps, minv_ll_hold),
                  n_steps)

    def fn(worlds: ArtWorld, bipeds: BipedParams, terrains: Terrain) -> ArtWorld:
        _check_terrains(worlds, terrains)
        return run(worlds, bipeds, terrains)

    fn.graphs = run.graphs
    return fn


_DEFAULTS: dict = {}  # device -> (hector_model, BipedParams()) on it


def _defaults(device) -> tuple[ArticulatedModel, BipedParams]:
    """The default model and low-level robot on ``device``, one pair per
    device: the kernels' constant buffers are kept per object
    (``ops/cuda``), so a new default object per call would add a buffer per
    call."""
    device = torch.device(device)
    if device not in _DEFAULTS:
        _DEFAULTS[device] = (hector_model(device=device), BipedParams().to(device))
    return _DEFAULTS[device]


def _substep_kernel_tick(w: ArtWorld, bipeds: BipedParams, mpc: MpcConfig,
                         gait: GaitConfig, model: ArticulatedModel, n_lowlevel: int,
                         n_substeps: int, minv_ll_hold: int) -> ArtWorld:
    """One tick of the substep-kernel path."""

    def physics(sim, tau, Minv, dt):
        return fused_substeps(model, sim, tau, Minv, dt, n_substeps)

    return _art_tick(w, bipeds, mpc, gait, model, n_lowlevel, minv_ll_hold, physics)


def _tick_kernel_tick(w: ArtWorld, bipeds: BipedParams, mpc: MpcConfig, gait: GaitConfig,
                      model: ArticulatedModel, biped: BipedParams, n_lowlevel: int,
                      n_substeps: int) -> ArtWorld:
    """One tick of the tick-kernel path: the MPC stage, one mass-matrix
    inverse, one ``fused_tick``, the post stage (stages ``art.feedback``,
    ``mpc.build``, ``qp.ruiz``, ``qp.kernel``, ``qp.unscale``,
    ``art.minv``, ``art.tick_kernel``, ``tick.post``)."""
    x_fb, t_g, hold, contact, sol = _art_control_stage(w, bipeds, mpc, gait, model)
    sim = w.sim
    t0 = t_g if gait.contact_clock else sim.t
    with stage("art.minv"):
        Minv = mass_matrix_inv(model, sim.q)
    with stage("art.tick_kernel"):
        sim_new, energy = fused_tick(
            model, biped, mpc, gait, sim, sol.controls[:, 0], contact[:, 0, 0:2], t0,
            w.ctrl.cmd_ref[:, 2], w.ctrl.v_int, Minv, n_lowlevel, n_substeps,
        )
    return _art_post_stage(w, sim_new, energy, x_fb, sol, t_g, hold, mpc)


@f32_precision
@torch.no_grad()
def batched_art_rollout_kernel(worlds: ArtWorld, bipeds: BipedParams,
                               n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                               model: ArticulatedModel | None = None,
                               n_lowlevel: int = 8, n_substeps: int = 5,
                               minv_ll_hold: int = 8) -> ArtWorld:
    """``n_steps`` articulated ticks with each low-level period's substeps
    in one :func:`~biped_mpc_py_torch.ops.cuda.substep_kernel.fused_substeps`
    call (one kernel launch on the card, ``n_lowlevel`` per tick): the
    eager form of :func:`batched_art_rollout_kernel_fn`. Same semantics as
    :func:`batched_art_rollout` except that ``t`` advances once per period
    (not once per substep), as in JAX. Any number of envs."""
    model = model or _defaults(worlds.sim.q.device)[0]
    w = worlds
    for _ in range(n_steps):
        w = _substep_kernel_tick(w, bipeds, mpc, gait, model, n_lowlevel, n_substeps,
                                 minv_ll_hold)
    return w


@f32_precision
@torch.no_grad()
def batched_art_rollout_tick_kernel(worlds: ArtWorld, bipeds: BipedParams,
                                    n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                                    model: ArticulatedModel | None = None,
                                    biped: BipedParams | None = None,
                                    n_lowlevel: int = 8,
                                    n_substeps: int = 5) -> ArtWorld:
    """``n_steps`` articulated ticks with everything below the MPC layer in
    one :func:`~biped_mpc_py_torch.ops.cuda.tick_kernel.fused_tick` call per
    tick (one kernel launch on the card): the eager form of
    :func:`batched_art_rollout_tick_kernel_fn`.

    Each tick: the MPC stage, one mass-matrix inverse held all tick, the
    fused tick (``n_lowlevel`` periods of feedback, low-level control and
    ``n_substeps`` substeps), then fall reset, controller state and
    metrics. The MPC stage takes the per-env ``bipeds``; the low-level
    control takes the leg geometry of the one robot ``biped`` (default
    ``BipedParams()``), as in JAX. Walking gaits on flat ground; any number
    of envs.
    """
    default_model, default_biped = _defaults(worlds.sim.q.device)
    model = model or default_model
    biped = biped if biped is not None else default_biped
    w = worlds
    for _ in range(n_steps):
        w = _tick_kernel_tick(w, bipeds, mpc, gait, model, biped, n_lowlevel, n_substeps)
    return w


def batched_art_rollout_kernel_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                                  model: ArticulatedModel | None = None,
                                  n_lowlevel: int = 8, n_substeps: int = 5,
                                  minv_ll_hold: int = 8):
    """``fn(worlds, bipeds) -> worlds``: ``n_steps`` ticks of the
    substep-kernel path, the counterpart of
    ``jax.jit(batched_art_rollout_kernel_fn(n_steps, mpc, gait, model,
    n_lowlevel, n_substeps, minv_ll_hold))``. On the card the first call
    with a shape captures one tick (the MPC stage, the mass-matrix inverses,
    the low-level stages and ``n_lowlevel`` ``fused_substeps`` launches) as
    a CUDA graph and every call replays it ``n_steps`` times
    (``utils/graphs.py``); on the CPU the same static buffers step eagerly.
    ``model`` is a factory constant, as in JAX (default: the HECTOR model on
    the worlds' device). Bit-equal to :func:`batched_art_rollout_kernel`."""
    if n_lowlevel % minv_ll_hold:
        raise ValueError(
            f"n_lowlevel {n_lowlevel} is not a multiple of minv_ll_hold {minv_ll_hold}"
        )

    def step(w, bipeds):
        m = model or _defaults(w.sim.q.device)[0]
        return _substep_kernel_tick(w, bipeds, mpc, gait, m, n_lowlevel, n_substeps,
                                    minv_ll_hold)

    return graphed(step, n_steps)


def batched_art_rollout_tick_kernel_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                                       model: ArticulatedModel | None = None,
                                       biped: BipedParams | None = None,
                                       n_lowlevel: int = 8, n_substeps: int = 5):
    """``fn(worlds, bipeds) -> worlds``: ``n_steps`` ticks of the
    tick-kernel path, the counterpart of
    ``jax.jit(batched_art_rollout_tick_kernel_fn(n_steps, mpc, gait, model,
    biped, n_lowlevel, n_substeps))``. On the card the first call with a
    shape captures one tick (the MPC stage, ``mass_matrix_inv``, one
    ``fused_tick`` launch, the post stage) as a CUDA graph and every call
    replays it ``n_steps`` times (``utils/graphs.py``); on the CPU the same
    static buffers step eagerly. ``model`` and the low-level robot
    ``biped`` are factory constants, as in JAX (defaults: the HECTOR model
    and ``BipedParams()`` on the worlds' device). Bit-equal to
    :func:`batched_art_rollout_tick_kernel`."""

    def step(w, bipeds):
        default_model, default_biped = _defaults(w.sim.q.device)
        return _tick_kernel_tick(w, bipeds, mpc, gait, model or default_model,
                                 biped if biped is not None else default_biped,
                                 n_lowlevel, n_substeps)

    return graphed(step, n_steps)

"""Batched closed-loop SRB rollouts: the counterpart of
``biped_mpc_py_tpu/parallel/rollout.py``.

One tick for every env: contact schedule, CoM and foot references, horizon
linearization, condensation, Ruiz scaling, the fused ADMM solve (one CUDA
kernel launch for the whole batch on the card), the SRB physics step, fall
reset and metrics. ``lax.scan`` becomes a Python loop over ticks.

:func:`batched_rollout` drives every env with the config's command,
:func:`batched_cmd_rollout` each env with its own. :func:`batched_rollout_fn`
and :func:`batched_cmd_rollout_fn` are their compiled forms, the
counterparts of ``jax.jit`` of the JAX factories: one tick captured as a
CUDA graph and replayed (``utils/graphs.py``). The JAX package's
single-env ``closed_loop_tick`` and ``rollout_fn`` have no separate port:
the batched functions at N = 1 are their counterparts.
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.control.controller import (
    ControllerState,
    advance_cmd_ref,
    advance_v_int,
)
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.qp import QpSolution, solve_qp
from biped_mpc_py_torch.sim.srb_sim import SrbState, srb_step
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.graphs import graphed, leaves
from biped_mpc_py_torch.utils.metrics import RolloutMetrics
from biped_mpc_py_torch.utils.precision import f32_precision
from biped_mpc_py_torch.utils.profiling import count_nonfinite, stage
from biped_mpc_py_torch.utils.struct import TensorStruct

# fall detection band [m]: outside -> reset (elastic recovery)
FALL_Z_MIN = 0.25
FALL_Z_MAX = 0.85


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


def batch_worlds(mpc: MpcConfig, n: int, device=DEFAULT_DEVICE) -> World:
    """A batch of ``n`` identical standing worlds, on the card unless
    ``device`` names another."""
    return init_world(mpc, n, device=device)


def fallen(sim_new, z: torch.Tensor, lo: float = FALL_Z_MIN, hi: float = FALL_Z_MAX):
    """The envs a post stage resets -> (fell, blown), each (N,) bool:
    ``blown`` where the new simulator state ``sim_new`` (a state struct)
    holds a non-finite value, ``fell`` where it is blown or its height
    ``z`` (N,) is not inside [lo, hi] (a NaN height is outside). For a
    finite state ``fell`` is the height band alone. The post stages add
    ``blown`` to ``utils/profiling.py``'s count of non-finite resets."""
    n = z.shape[0]
    flat = torch.cat([t.reshape(n, -1) for t in leaves(sim_new) if t.is_floating_point()], 1)
    finite = torch.isfinite(flat).all(1)
    # z == clamp(z, lo, hi) exactly where lo <= z <= hi; never for a NaN or an infinity
    return ~(finite & (torch.clamp(z, lo, hi) == z)), ~finite


def _finish_tick(sim_new: SrbState, sol: QpSolution, cmd_ref: torch.Tensor,
                 metrics: RolloutMetrics, mpc: MpcConfig,
                 v_int: torch.Tensor | None = None,
                 x_cmd: torch.Tensor | None = None) -> World:
    """Per-env fall detection, in-batch reset and metrics update
    (``rollout.py:54``). A fallen env (``fallen``: out of the height band,
    or not finite) restarts standing with a cold controller; its clock
    ``t`` runs on. A non-finite env's running sums take only the tick and
    the fall."""
    x = sim_new.x_fb
    n, dtype, device = x.shape[0], x.dtype, x.device
    fell, blown = fallen(sim_new, x[:, 5])
    count_nonfinite(blown)
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
                             sol.controls[:, 0], sol.res_prim, fell.to(dtype)).keep(blown, metrics)
    return World(sim=sim_next, ctrl=ctrl_next, metrics=metrics)


def batched_closed_loop_tick(
    world: World, mpc: MpcConfig, gait: GaitConfig, biped: BipedParams,
    x_cmd: torch.Tensor | None = None,
) -> World:
    """One fused sim+MPC tick for every env (``rollout.py:100``); the QP
    solve is one ``fused_qp_solve`` call for the whole batch. ``x_cmd``
    ((12,) or (N,12)) overrides ``mpc.x_cmd`` throughout the tick. Its
    stages (``utils/profiling.py``): ``mpc.build``, the solve's
    ``qp.ruiz``, ``qp.kernel`` and ``qp.unscale``, ``srb.step``,
    ``tick.post``."""
    sim = world.sim
    with stage("mpc.build"):
        contact = contact_sequence(sim.t, mpc, gait)
        qp = build_mpc_qp(
            sim.x_fb, sim.t, sim.foot, mpc, biped, contact, gait,
            world.ctrl.cmd_ref, v_int=world.ctrl.v_int, x_cmd=x_cmd,
        )
    sol = solve_qp(qp, mpc, warm=world.ctrl.qp)
    with stage("srb.step"):
        sim_new = srb_step(sim, sol.controls[:, 0], mpc, gait, biped, x_cmd=x_cmd)
    with stage("tick.post"):
        ref_next = advance_cmd_ref(world.ctrl.cmd_ref, sim.x_fb, mpc, x_cmd)
        vi_next = advance_v_int(world.ctrl.v_int, sim.x_fb, mpc, x_cmd)
        return _finish_tick(sim_new, sol, ref_next, world.metrics, mpc, vi_next, x_cmd)


@f32_precision
@torch.no_grad()
def batched_rollout(
    worlds: World, bipeds: BipedParams, n_steps: int, mpc: MpcConfig,
    gait: GaitConfig,
) -> World:
    """``n_steps`` ticks of the batched closed loop: the counterpart of
    ``batched_rollout_fn(n_steps, mpc, gait, backend="pallas")(worlds,
    bipeds)``. ``worlds`` and ``bipeds`` share the env axis and the device;
    every matmul runs in full f32."""
    w = worlds
    for _ in range(n_steps):
        w = batched_closed_loop_tick(w, mpc, gait, bipeds)
    return w


@f32_precision
@torch.no_grad()
def batched_cmd_rollout(
    worlds: World, bipeds: BipedParams, x_cmd: torch.Tensor, n_steps: int,
    mpc: MpcConfig, gait: GaitConfig,
) -> World:
    """``n_steps`` ticks with per-env commands: the counterpart of
    ``batched_cmd_rollout_fn(n_steps, mpc, gait)(worlds, bipeds, x_cmd)``.
    ``x_cmd`` (N,12) holds each env's command (its own speed and heading)
    in the layout of ``MpcConfig.x_cmd`` and takes the place of the
    config's everywhere in the tick, the metrics included."""
    x_cmd = _check_cmd(worlds, x_cmd)
    w = worlds
    for _ in range(n_steps):
        w = batched_closed_loop_tick(w, mpc, gait, bipeds, x_cmd)
    return w


def batched_rollout_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig):
    """``fn(worlds, bipeds) -> worlds``: ``n_steps`` ticks of
    :func:`batched_closed_loop_tick`, the counterpart of
    ``jax.jit(batched_rollout_fn(n_steps, mpc, gait, backend="pallas"))``
    (the TPU block sizing has no counterpart). On the card the first call
    with a shape captures one tick as a CUDA graph and every call replays
    it ``n_steps`` times (``utils/graphs.py``); on the CPU the same static
    buffers step eagerly. Bit-equal to :func:`batched_rollout`; the inputs
    are not modified and the result aliases nothing of the graph's."""
    return graphed(lambda w, bipeds: batched_closed_loop_tick(w, mpc, gait, bipeds),
                   n_steps)


def _check_cmd(worlds: World, x_cmd: torch.Tensor) -> torch.Tensor:
    n = worlds.sim.x_fb.shape[0]
    if x_cmd.shape != (n, 12):
        raise ValueError(f"x_cmd of shape {tuple(x_cmd.shape)}, expected ({n}, 12)")
    return x_cmd.to(worlds.sim.x_fb.dtype)


def batched_cmd_rollout_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig):
    """``fn(worlds, bipeds, x_cmd) -> worlds`` with per-env commands (N,12):
    the counterpart of ``jax.jit(batched_cmd_rollout_fn(n_steps, mpc,
    gait))``, captured and replayed as :func:`batched_rollout_fn`;
    bit-equal to :func:`batched_cmd_rollout`."""
    run = graphed(lambda w, bipeds, x_cmd: batched_closed_loop_tick(
        w, mpc, gait, bipeds, x_cmd), n_steps)

    def fn(worlds: World, bipeds: BipedParams, x_cmd: torch.Tensor) -> World:
        return run(worlds, bipeds, _check_cmd(worlds, x_cmd))

    fn.graphs = run.graphs
    return fn


def randomize_params(generator: torch.Generator, n: int,
                     base: BipedParams | None = None,
                     device=DEFAULT_DEVICE) -> BipedParams:
    """Domain-randomized population of ``n`` robots (``rollout.py:216``):
    mass and inertia diagonal scaled by U(0.8, 1.2), friction mu ~
    U(0.4, 0.7). Draws on ``generator``'s device, returns on ``device``
    (the card unless named otherwise)."""
    device = entry_device(device)
    base = (base or BipedParams()).expand(n)
    gdev = generator.device

    def uniform(shape, lo, hi):
        r = torch.rand(shape, generator=generator, device=gdev)
        return (lo + (hi - lo) * r).to(device=device)

    out = base.to(device)
    return dataclasses.replace(
        out,
        m=out.m * uniform((n,), 0.8, 1.2),
        I_diag=out.I_diag * uniform((n, 3), 0.8, 1.2),
        mu=uniform((n,), 0.4, 0.7),
    )

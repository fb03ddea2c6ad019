"""The control tick (L6) and the controller state carried across ticks: the
counterpart of ``biped_mpc_py_tpu/control/controller.py``.

:func:`control_tick` runs FK -> contact schedule -> MPC solve -> low-level
torques for a batch of envs, the reference main script's stage chain. Each
function takes an optional ``per_env`` dict of (N,) tensors that override
the config's fields (``config.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import (
    GaitConfig,
    MpcConfig,
    cmd_entry,
    config_tensor,
    config_value,
)
from biped_mpc_py_torch.control.gait import advance_gait_clock, contact_sequence
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.control.mpc import solve_mpc
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.models.kinematics import foot_positions_world
from biped_mpc_py_torch.ops.qp import QpSolution, m_step
from biped_mpc_py_torch.utils.struct import TensorStruct


def _zeros_per_env(dtype=torch.float32):
    return dataclasses.field(default_factory=lambda: torch.zeros(1, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class ControllerState(TensorStruct):
    """The previous QP solution (ADMM warm start), the body-frame command
    anchor, the velocity-error integral, the contact-sensed gait clock and
    the leaky pitch reference (``controller.py:32``). Shapes: cmd_ref
    (N,3), v_int (N,2), the rest (N,)."""

    qp: QpSolution
    cmd_ref: torch.Tensor
    v_int: torch.Tensor
    t_gait: torch.Tensor = _zeros_per_env()
    hold_count: torch.Tensor = _zeros_per_env(torch.int32)
    pitch_ref: torch.Tensor = _zeros_per_env()

    @classmethod
    def init(cls, mpc: MpcConfig, n: int = 1, device=None,
             dtype=torch.float32, x_cmd: torch.Tensor | None = None,
             per_env: dict | None = None) -> "ControllerState":
        """A cold controller for ``n`` envs; ``x_cmd`` ((12,) or (N,12))
        overrides ``mpc.x_cmd`` (the leaky pitch reference starts at the
        commanded pitch), ``per_env`` the ``dt`` and ``pitch_ref_leak``."""
        h, m = mpc.h, m_step(mpc)

        def zero(*shape):
            return torch.zeros((n,) + shape, dtype=dtype, device=device)

        leak = config_value(mpc, "pitch_ref_leak", per_env)
        if isinstance(leak, torch.Tensor):  # JAX's branch-free form
            pitch_cmd = torch.full_like(leak, mpc.x_cmd[1]) if x_cmd is None else x_cmd[..., 1]
            pitch_ref = torch.where(leak > 0, pitch_cmd, 0.0).to(dtype).expand(n).clone()
        elif leak <= 0:
            pitch_ref = zero()
        elif x_cmd is None:
            pitch_ref = torch.full((n,), mpc.x_cmd[1], dtype=dtype, device=device)
        else:
            pitch_ref = x_cmd[..., 1].to(dtype).expand(n).clone()
        return cls(
            qp=QpSolution(
                controls=zero(h, 12), states=zero(h, 13), z=zero(h, m),
                y=zero(h, m), res_prim=zero(), res_dual=zero(),
            ),
            cmd_ref=zero(3),
            v_int=zero(2),
            t_gait=zero() - config_value(mpc, "dt", per_env),
            hold_count=torch.zeros(n, dtype=torch.int32, device=device),
            pitch_ref=pitch_ref,
        )


# Leak rate of the command anchor toward the measured pose, per 25 Hz tick
# (``controller.py:99``).
CMD_REF_LEAK = 0.05


def advance_cmd_ref(cmd_ref: torch.Tensor, x_fb: torch.Tensor,
                    mpc: MpcConfig, x_cmd: torch.Tensor | None = None,
                    per_env: dict | None = None) -> torch.Tensor:
    """One-tick update of the body-frame command anchor (N,3): integrate the
    commanded arc, then leak toward the measured pose. ``x_cmd`` ((12,) or
    (N,12)) overrides ``mpc.x_cmd``, ``per_env`` the ``dt`` and
    ``cmd_leak_yaw``."""
    yaw = cmd_ref[:, 2]
    vbx, vby = cmd_entry(mpc, x_cmd, 9), cmd_entry(mpc, x_cmd, 10)
    dt = config_value(mpc, "dt", per_env)
    dyaw = cmd_entry(mpc, x_cmd, 8) * dt
    if isinstance(dyaw, torch.Tensor):
        dyaw = dyaw.expand_as(yaw)
    else:
        dyaw = torch.full_like(yaw, dyaw)
    step = torch.stack(
        [
            (torch.cos(yaw) * vbx - torch.sin(yaw) * vby) * dt,
            (torch.sin(yaw) * vbx + torch.cos(yaw) * vby) * dt,
            dyaw,
        ],
        -1,
    )
    ref = cmd_ref + step
    actual = torch.stack([x_fb[:, 3], x_fb[:, 4], x_fb[:, 2]], -1)
    leak_yaw = config_value(mpc, "cmd_leak_yaw", per_env)
    if isinstance(leak_yaw, torch.Tensor):
        leak_xy = torch.full_like(leak_yaw, CMD_REF_LEAK)
        leak = torch.stack([leak_xy, leak_xy, leak_yaw], -1)
    else:
        leak = config_tensor((CMD_REF_LEAK, CMD_REF_LEAK, leak_yaw), ref)
    return ref + leak * (actual - ref)


def advance_pitch_ref(pitch_ref: torch.Tensor, x_fb: torch.Tensor,
                      mpc: MpcConfig, per_env: dict | None = None) -> torch.Tensor:
    """One-tick update of the leaky pitch reference (N,)."""
    leak = config_value(mpc, "pitch_ref_leak", per_env)
    return pitch_ref + leak * (x_fb[:, 1] - pitch_ref)


def advance_v_int(v_int: torch.Tensor, x_fb: torch.Tensor,
                  mpc: MpcConfig, x_cmd: torch.Tensor | None = None,
                  per_env: dict | None = None) -> torch.Tensor:
    """One-tick update of the xy velocity-error integrator (N,2): clipped
    at ``cmd_v_int_max``, held at 0 on axes with a zero command and in
    body-frame command mode. ``x_cmd`` ((12,) or (N,12)) overrides
    ``mpc.x_cmd``, ``per_env`` the ``cmd_v_int_gain`` and
    ``cmd_v_int_max``."""
    if mpc.cmd_body_frame:
        return torch.zeros_like(v_int)
    v_cmd = config_tensor(mpc.x_cmd[9:11], v_int) if x_cmd is None else x_cmd[..., 9:11]
    err = v_cmd - x_fb[:, 9:11]
    v_max = config_value(mpc, "cmd_v_int_max", per_env, 1)
    nxt = torch.clamp(
        v_int + config_value(mpc, "cmd_v_int_gain", per_env, 1) * err, -v_max, v_max
    )
    return torch.where(v_cmd != 0, nxt, torch.zeros_like(nxt))


def control_tick(
    x_fb: torch.Tensor,
    q: torch.Tensor,
    qd: torch.Tensor,
    t,
    mpc: MpcConfig,
    gait: GaitConfig,
    biped: BipedParams,
    ctrl_state: ControllerState | None = None,
    contact_meas: torch.Tensor | None = None,
    per_env: dict | None = None,
):
    """One full control tick for every env (``controller.py:166``).

    Args:
      x_fb: (N,12) state [roll, pitch, yaw, p, w, v].
      q, qd: (N,10) joint positions and velocities.
      t: (N,) times [s], or one float for every env.
      ctrl_state: the previous tick's state (warm start); None = cold.
      contact_meas: (N,2) measured contact flags; required with
        ``gait.contact_clock``, which then runs the schedule on the held
        gait clock instead of ``t``.
      per_env: config fields given per env as (N,) tensors (``Q`` (N,13),
        ``R`` (N,12)), as a config batched under JAX's vmap.

    Returns (tau (N,10), the next ControllerState, the QpSolution).
    """
    n, dtype, device = x_fb.shape[0], x_fb.dtype, x_fb.device
    t = torch.as_tensor(t, dtype=dtype, device=device).expand(n).contiguous()
    pf_w = foot_positions_world(x_fb, q, biped)
    warm = None if ctrl_state is None else ctrl_state.qp
    cmd_ref = None if ctrl_state is None else ctrl_state.cmd_ref
    v_int = None if ctrl_state is None else ctrl_state.v_int
    p_ref = None if ctrl_state is None else ctrl_state.pitch_ref
    if gait.contact_clock:
        if contact_meas is None:
            raise ValueError("gait.contact_clock=True requires contact_meas")
        if ctrl_state is None:
            raise ValueError(
                "gait.contact_clock=True requires ctrl_state "
                "(ControllerState.init carries the gait clock)"
            )
        t_g, hold = advance_gait_clock(
            ctrl_state.t_gait, ctrl_state.hold_count, contact_meas, mpc, gait, per_env
        )
    else:
        t_g = t
        hold = (ctrl_state.hold_count if ctrl_state is not None
                else torch.zeros(n, dtype=torch.int32, device=device))
    contact = contact_sequence(t_g, mpc, gait, per_env)
    foot_yaw = x_fb[:, 2:3] + q[:, 0:6:5] if mpc.foot_frame_wrench else None
    sol = solve_mpc(
        x_fb, t_g, pf_w, mpc, biped, contact, warm=warm, gait=gait,
        cmd_ref=cmd_ref, foot_yaw=foot_yaw, v_int=v_int, pitch_ref=p_ref,
        per_env=per_env,
    )
    tau = low_level_control(
        x_fb, t_g, pf_w, q, qd, mpc, biped, contact, sol.controls[:, 0],
        gait=gait, cmd_ref=cmd_ref, v_int=v_int, per_env=per_env,
    )

    def zeros(*shape):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)

    state_next = ControllerState(
        qp=sol,
        cmd_ref=advance_cmd_ref(zeros(3) if cmd_ref is None else cmd_ref, x_fb, mpc,
                                per_env=per_env),
        v_int=advance_v_int(zeros(2) if v_int is None else v_int, x_fb, mpc,
                            per_env=per_env),
        t_gait=t_g.to(dtype),
        hold_count=hold,
        pitch_ref=advance_pitch_ref(zeros() if p_ref is None else p_ref, x_fb, mpc,
                                    per_env),
    )
    return tau, state_next, sol

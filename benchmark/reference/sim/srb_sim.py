"""Single-rigid-body stub simulator: the counterpart of
``biped_mpc_py_tpu/sim/srb_sim.py``.

  omega_dot = I_w^{-1} (sum_i skew(r_i) f_i + m_i)         (world frame)
  v_dot     = sum_i f_i / m - g e_z
  eul_dot   = E(pitch, yaw)^{-1} omega
  p_dot     = v

Swing feet move kinematically along the swing controller's Raibert +
sinusoid target; stance feet stay planted on the ground plane.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import GaitConfig, MpcConfig, config_tensor
from benchmark.reference.control.gait import contact_sequence
from benchmark.reference.control.swing import swing_phase_z, swing_target_xy
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.ops.linalg3 import inv3
from benchmark.reference.ops.rotations import eul2rotm, euler_rate_matrix_inv, skew
from benchmark.reference.utils.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class SrbState(TensorStruct):
    """World state of the SRB abstraction, batched over envs."""

    x_fb: torch.Tensor  # (N,12) [roll,pitch,yaw, p, w_world, v_world]
    foot: torch.Tensor  # (N,6) world foot positions [left, right]
    t: torch.Tensor  # (N,) time [s]

    @classmethod
    def standing(cls, n: int = 1, z0: float = 0.53, foot_y: float = 0.09,
                 device=None, dtype=torch.float32) -> "SrbState":
        # leg 0 is the +y leg (side=+1)
        x = torch.zeros((n, 12), dtype=dtype, device=device)
        x[:, 5] = z0
        foot = config_tensor((-0.02, foot_y, 0.0, -0.02, -foot_y, 0.0), x).repeat(n, 1)
        return cls(x_fb=x, foot=foot, t=torch.zeros(n, dtype=dtype, device=device))


def srb_step(
    state: SrbState,
    u: torch.Tensor,
    mpc: MpcConfig,
    gait: GaitConfig,
    biped: BipedParams,
    n_substeps: int = 4,
    x_cmd: torch.Tensor | None = None,
) -> SrbState:
    """Advance every env by one MPC period dt under controls u (N,12).
    ``x_cmd`` ((12,) or (N,12)) overrides ``mpc.x_cmd`` in the swing
    targets."""
    dt_sub = mpc.dt / n_substeps
    x = state.x_fb
    f1, f2 = u[:, 0:3], u[:, 3:6]
    m1, m2 = u[:, 6:9], u[:, 9:12]
    I_body = biped.I_body.to(x.dtype)
    mass = biped.m.to(x.dtype)[:, None]
    g = biped.g.to(x.dtype)
    gravity = torch.stack([torch.zeros_like(g), torch.zeros_like(g), g], -1)

    def mv(M, v):
        return (M @ v[:, :, None])[..., 0]

    for _ in range(n_substeps):
        R = eul2rotm(x[:, 0:3])
        I_w = R.transpose(1, 2) @ I_body @ R
        I_w_inv = inv3(I_w)
        r1 = state.foot[:, 0:3] - x[:, 3:6]
        r2 = state.foot[:, 3:6] - x[:, 3:6]
        torque = mv(skew(r1), f1) + mv(skew(r2), f2) + m1 + m2
        w_dot = mv(I_w_inv, torque)
        v_dot = (f1 + f2) / mass - gravity
        eul_dot = mv(euler_rate_matrix_inv(x[:, 1], x[:, 2]), x[:, 6:9])
        x = torch.cat(
            [
                x[:, 0:3] + eul_dot * dt_sub,
                x[:, 3:6] + x[:, 9:12] * dt_sub,
                x[:, 6:9] + w_dot * dt_sub,
                x[:, 9:12] + v_dot * dt_sub,
            ],
            1,
        )

    t_new = state.t + mpc.dt
    foot_new = _advance_feet(state, x, t_new, mpc, gait, x_cmd)
    return SrbState(x_fb=x, foot=foot_new, t=t_new)


def _advance_feet(
    state: SrbState, x_new: torch.Tensor, t_new: torch.Tensor, mpc: MpcConfig,
    gait: GaitConfig, x_cmd: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kinematic swing-foot motion (N,6); stance feet stay planted and are
    dropped to the ground plane."""
    contact_now = contact_sequence(t_new, mpc, gait)[:, 0]  # (N,2)
    feet = []
    for leg, side in enumerate((1.0, -1.0)):
        fx, fy = swing_target_xy(x_new, mpc, side, gait, x_cmd=x_cmd)
        fz = swing_phase_z(t_new, mpc, gait, x_new.dtype, side=side)
        swing_pos = torch.stack([fx, fy, fz], -1)
        foot3 = state.foot[:, 3 * leg: 3 * leg + 3]
        stance_pos = torch.cat([foot3[:, :2], torch.zeros_like(foot3[:, 2:])], -1)
        feet.append(torch.where(contact_now[:, leg: leg + 1] > 0.5, stance_pos, swing_pos))
    return torch.cat(feet, -1)

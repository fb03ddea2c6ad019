"""Low-level force/moment -> joint-torque mapping (L5): the counterpart of
``biped_mpc_py_tpu/control/lowlevel.py``, batched over a leading env axis.

Per leg: the stance torque Jmᵀ (-[Rᵀ f; Rᵀ m]) of the first MPC control,
gated by the first horizon step's contact flag, plus the swing torque
Jfᵀ F_swing, the foot-heading wrench and the flight yaw damping, gated by
its complement. The stance leg also carries the pivot heading drive. See
the JAX module for the measurements behind each channel. An optional
``x_cmd`` tensor and ``per_env`` gains override the config's
(``config.py`` describes the mechanism).
"""

from __future__ import annotations

import torch

from benchmark.reference.config import GaitConfig, MpcConfig, cmd_entry, config_value
from benchmark.reference.control.swing import swing_leg_force
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.models.kinematics import SIDES, leg_jacobians
from benchmark.reference.ops.rotations import eul2rotm


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def low_level_control(
    x_fb: torch.Tensor,
    t: torch.Tensor,
    pf_w: torch.Tensor,
    q: torch.Tensor,
    qd: torch.Tensor,
    mpc: MpcConfig,
    biped: BipedParams,
    contact: torch.Tensor,
    u0: torch.Tensor,
    gait: GaitConfig | None = None,
    cmd_ref: torch.Tensor | None = None,
    terrain=None,
    v_int: torch.Tensor | None = None,
    x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> torch.Tensor:
    """Joint torques (N,10) from the first MPC control (``lowlevel.py:23``).

    Args:
      x_fb: (N,12) feedback; t: (N,) gait time; pf_w: (N,6) world feet.
      q, qd: (N,10) joint positions and velocities.
      contact: (N,h,2) horizon contact flags (row 0 is used).
      u0: (N,12) first-step MPC control [f_l, f_r, m_l, m_r].
      cmd_ref: (N,3) command anchor; its yaw is the foot-heading target in
        body-frame command mode, else the command's yaw is.
      x_cmd: (12,) or (N,12) command overriding ``mpc.x_cmd``.
      per_env: low-level and swing gains (``config.PER_ENV_FIELDS``) as
        (N,) tensors overriding the config's.
    """

    def gain(name, dims=0):
        return config_value(mpc, name, per_env, dims)

    R = eul2rotm(x_fb[:, 0:3])
    Rt = R.transpose(1, 2)
    c0 = contact[:, 0, 0:2]
    if mpc.cmd_body_frame and cmd_ref is not None:
        yaw_des = cmd_ref[:, 2]
    else:
        yaw_des = cmd_entry(mpc, x_cmd, 2)
    wz_cmd = cmd_entry(mpc, x_cmd, 8)
    dyaw = yaw_des - x_fb[:, 2]
    dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
    dyaw_tgt = dyaw - gain("hipyaw_rate_lead") * (x_fb[:, 8] - wz_cmd)
    yaw_clip = gain("hipyaw_target_clip")
    q_yaw_des = torch.clamp(dyaw_tgt, -yaw_clip, yaw_clip)
    flight = (1.0 - c0[:, 0]) * (1.0 - c0[:, 1])
    tau_clip = gain("tau_yaw_clip")
    tau_fly = flight * torch.clamp(
        gain("flight_yaw_kd") * (x_fb[:, 8] - wz_cmd), -tau_clip, tau_clip,
    )
    tau_clip_col = gain("tau_yaw_clip", 1)  # against (N,5) leg torques
    taus = []
    for leg, side in enumerate(SIDES):
        legs = slice(5 * leg, 5 * leg + 5)
        q5, qd5 = q[:, legs], qd[:, legs]
        jm, jf = leg_jacobians(q5, side, biped.jac_geometry)
        jqd = _mv(jf, qd5)
        # body-frame Jacobians: world foot velocity R Jf qd, world force
        # through Jfᵀ Rᵀ; compat_swing_frame_bug rotates both the
        # reference's (wrong) way
        vf_w = _mv(Rt, jqd) if mpc.compat_swing_frame_bug else _mv(R, jqd)
        f_swing = swing_leg_force(
            x_fb, t, pf_w[:, 3 * leg:3 * leg + 3], vf_w, mpc, side, gait,
            terrain, v_int, x_cmd, per_env,
        )
        if not mpc.compat_swing_frame_bug:
            f_swing = _mv(Rt, f_swing)
        f3, m3 = u0[:, 3 * leg:3 * leg + 3], u0[:, 6 + 3 * leg:9 + 3 * leg]
        u_w = -torch.cat([_mv(Rt, f3), _mv(Rt, m3)], -1)
        tau_stance = _mv(jm.transpose(1, 2), u_w)
        tau_pivot = (
            -gain("kp_pivot") * torch.clamp(dyaw, -0.3, 0.3)
            - gain("kd_pivot") * (qd5[:, 0] + wz_cmd)
        )
        tau_stance = torch.cat([tau_stance[:, :1] + tau_pivot[:, None], tau_stance[:, 1:]], -1)
        tau_swing = _mv(jf.transpose(1, 2), f_swing)
        # foot-heading wrench: a world-z moment on the swing foot through
        # the angular Jacobian rows, clamped as a secondary task
        m_yaw = gain("kp_hipyaw") * (q_yaw_des - q5[:, 0]) - gain("kd_hipyaw") * qd5[:, 0]
        tau_yaw = _mv(jm[:, 3:6].transpose(1, 2), Rt[:, :, 2] * m_yaw[:, None])
        tau_yaw = torch.clamp(tau_yaw, -tau_clip_col, tau_clip_col)
        tau_swing = torch.cat([tau_swing[:, :1] + tau_fly[:, None], tau_swing[:, 1:]], -1)
        c = c0[:, leg:leg + 1]
        taus.append(tau_stance * c + (tau_swing + tau_yaw) * (1.0 - c))
    return torch.cat(taus, -1)

"""Swing-foot targets (L5): the counterpart of
``biped_mpc_py_tpu/control/swing.py``.

The Raibert target with its stance-width offset, the swing height profile
and the swing PD force, batched over envs; ``side`` is +1 for the left leg
(leg 0) and -1 for the right. ``per_env`` maps swing gains to (N,)
tensors that override the config's (``config.config_value``), the MPC
step ``dt`` and the Raibert gains included.
"""

from __future__ import annotations

import math

import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig, cmd_entry, config_value
from biped_mpc_py_torch.control.gait import phase_time, swing_clock
from biped_mpc_py_torch.control.reference import _raibert_xy

Y_OFFSET = 0.04  # lateral swing-target offset [m] (reference ``:427``)


def swing_target_xy(
    x_fb: torch.Tensor, mpc: MpcConfig, side, gait: GaitConfig | None = None,
    v_int: torch.Tensor | None = None, x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
):
    """Raibert swing-foot target (x, y), each (N,), with the lateral
    stance-width offset rotated by the heading predicted at mid-touchdown
    (``compat_swing_yaw_bug`` adds it in world y, as the reference does).
    ``x_cmd`` ((12,) or (N,12)) overrides ``mpc.x_cmd``."""
    t_p = phase_time(mpc, gait, per_env)
    fx, fy = _raibert_xy(x_fb, mpc, t_p, v_int, x_cmd, per_env)
    if mpc.compat_swing_yaw_bug:
        return fx, fy + Y_OFFSET * side
    yaw = x_fb[:, 2] + cmd_entry(mpc, x_cmd, 8) * 0.5 * t_p
    y_offset = config_value(mpc, "swing_y_offset", per_env)
    return (
        fx - torch.sin(yaw) * y_offset * side,
        fy + torch.cos(yaw) * y_offset * side,
    )


def swing_phase_z(t: torch.Tensor, mpc: MpcConfig, gait: GaitConfig | None,
                  dtype, side=None, per_env: dict | None = None) -> torch.Tensor:
    """Swing height at time ``t`` (N,) within the current phase: the
    reference's half-sine (``:436-437``), or sin² with ``swing_z_sin2``;
    running gaits use the per-leg clock and need ``side``."""
    height = config_value(mpc, "swing_height", per_env)
    if gait is not None and gait.flight_steps > 0:
        if side is None:
            raise ValueError("running gait needs the per-leg clock (side)")
        frac, _ = swing_clock(t, mpc, gait, side, dtype, per_env)
        frac = torch.clamp(frac / config_value(mpc, "swing_land_frac", per_env), 0.0, 1.0)
        s = torch.sin(math.pi * frac)
        if mpc.swing_z_sin2:
            return height * s * s
        return height * s
    t_p = phase_time(mpc, gait, per_env)
    t_phase = torch.remainder(t.to(dtype), t_p)
    s = torch.sin(math.pi * t_phase / t_p)
    if mpc.swing_z_sin2:
        return height * s * s
    return height * s


def swing_phase_z_vel(t: torch.Tensor, mpc: MpcConfig, gait: GaitConfig | None,
                      dtype, side=None, per_env: dict | None = None) -> torch.Tensor:
    """Time derivative of :func:`swing_phase_z` [m/s], closed form."""
    height = config_value(mpc, "swing_height", per_env)
    if gait is not None and gait.flight_steps > 0:
        if side is None:
            raise ValueError("running gait needs the per-leg clock (side)")
        land_frac = config_value(mpc, "swing_land_frac", per_env)
        frac, T_sw = swing_clock(t, mpc, gait, side, dtype, per_env)
        g = frac / land_frac
        rate = math.pi / (T_sw * land_frac)
        gc = torch.clamp(g, 0.0, 1.0)
        if mpc.swing_z_sin2:
            dz = height * rate * torch.sin(2.0 * math.pi * gc)
        else:
            dz = height * rate * torch.cos(math.pi * gc)
        return torch.where(g < 1.0, dz, torch.zeros_like(dz))
    t_p = phase_time(mpc, gait, per_env)
    u = torch.remainder(t.to(dtype), t_p)
    rate = math.pi / t_p
    if mpc.swing_z_sin2:
        return height * rate * torch.sin(2.0 * rate * u)
    return height * rate * torch.cos(rate * u)


def swing_leg_force(
    x_fb: torch.Tensor, t: torch.Tensor, pf_w: torch.Tensor, vf_w: torch.Tensor,
    mpc: MpcConfig, side, gait: GaitConfig | None = None, terrain=None,
    v_int: torch.Tensor | None = None, x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> torch.Tensor:
    """World PD force (N,3) driving the swing foot (pf_w, vf_w (N,3)) to its
    Raibert target (``swing.py:113``), with the touchdown damping and
    retraction ramps, the tracking feedforward and the touchdown overdrive
    of the JAX function (each 0 by default). On a ``terrain`` the swing
    apex rides the surface under the target. ``x_cmd`` ((12,) or (N,12))
    overrides ``mpc.x_cmd``; ``per_env`` the swing gains."""
    dtype = x_fb.dtype

    def gain(name, dims=0):
        return config_value(mpc, name, per_env, dims)

    fx, fy = swing_target_xy(x_fb, mpc, side, gait, v_int, x_cmd, per_env)
    fz = swing_phase_z(t, mpc, gait, dtype, side=side, per_env=per_env)
    if terrain is not None:
        fz = fz + terrain.height(fx, fy)
    foot_des = torch.stack([fx, fy, fz], -1)
    if gait is not None and gait.flight_steps > 0:
        frac, _ = swing_clock(t, mpc, gait, side, dtype, per_env)
    else:
        t_p = phase_time(mpc, gait, per_env)
        frac = torch.remainder(t.to(dtype), t_p) / t_p
    ramp = torch.square(torch.clamp((frac - 0.6) / 0.4, 0.0, 1.0))
    yaw = x_fb[:, 2]
    foot_des = foot_des - (gain("swing_retract") * ramp)[:, None] * torch.stack(
        [torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], -1
    )
    dfz = swing_phase_z_vel(t, mpc, gait, dtype, side=side, per_env=per_env)
    v_des = gain("swing_track_ff", 1) * torch.stack([x_fb[:, 9], x_fb[:, 10], dfz], -1)
    f = gain("kp_swing", 1) * (foot_des - pf_w) + gain("kd_swing", 1) * (v_des - vf_w)
    f = torch.cat(
        [f[:, :2],
         f[:, 2:] + (-gain("kp_swing") * gain("swing_td_overdrive") * ramp)[:, None]], -1
    )
    damp = (gain("swing_td_damp") * ramp)[:, None]
    return f - damp * torch.cat([vf_w[:, :2], torch.zeros_like(vf_w[:, :1])], -1)

"""Reference-trajectory generation (L3): the counterpart of
``biped_mpc_py_tpu/control/reference.py``.

Batched over a leading env axis. See the JAX module for the reference
defects the ``compat_*`` flags replicate and for the framework extensions
(body-frame commands, velocity-integral boost, leaky pitch reference).
With a ``terrain`` the future foot targets land on the height field. Every
function that reads the command takes an optional ``x_cmd`` tensor that
overrides ``mpc.x_cmd``, and a ``per_env`` dict whose (N,) tensors override
the config's ``dt``, ``kv``, Raibert and command-shaping gains
(``config.py`` describes the mechanism).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import (
    GaitConfig,
    MpcConfig,
    cmd_entry,
    config_tensor,
    config_value,
)
from benchmark.reference.control.gait import phase_time


def com_reference(
    x_fb: torch.Tensor,
    mpc: MpcConfig,
    cmd_ref: torch.Tensor | None = None,
    z_ground: torch.Tensor | float = 0.0,
    v_int: torch.Tensor | None = None,
    pitch_ref: torch.Tensor | None = None,
    x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> torch.Tensor:
    """CoM/state reference over the horizon -> (N, 13, h).

    Args:
      x_fb: (N, 12) feedback states.
      cmd_ref: (N, 3) body-frame command anchor [x, y, yaw].
      z_ground: local ground height, scalar or (N,).
      v_int: (N, 2) velocity-error integral.
      pitch_ref: (N,) leaky pitch reference.
      x_cmd: (12,) or (N, 12) command overriding ``mpc.x_cmd``.
      per_env: (N,) ``dt``, ``cmd_v_int_ref_scale``, ``pitch_ref_leak``
        overriding the config's.
    """
    h, n = mpc.h, x_fb.shape[0]
    dtype, device = x_fb.dtype, x_fb.device
    start = 0 if mpc.compat_ref_col0_bug else 1
    ks = torch.arange(start, h + start, dtype=dtype, device=device)  # (h,)
    x_cmd_t = config_tensor(mpc.x_cmd, x_fb) if x_cmd is None else x_cmd
    v_cmd_raw = x_cmd_t[..., 6:12]  # (6,) or (N,6)
    v_cmd = v_cmd_raw.expand(n, 6)
    if v_int is not None:
        boost = v_int * config_value(mpc, "cmd_v_int_ref_scale", per_env, 1)
        v_cmd = torch.cat([v_cmd[:, :3], v_cmd[:, 3:5] + boost, v_cmd[:, 5:]], 1)
    dtk = ks * config_value(mpc, "dt", per_env, 1)  # (h,) or (N,h)
    pose_int = x_fb[:, :6, None] + v_cmd[:, :, None] * dtk.unsqueeze(-2)  # (N,6,h)
    pose_cmd = x_cmd_t[..., :6].expand(n, 6)
    pose_cmd = torch.cat(
        [pose_cmd[:, :5], (pose_cmd[:, 5] + z_ground).expand(n)[:, None]], 1
    )
    leak = config_value(mpc, "pitch_ref_leak", per_env)
    if pitch_ref is not None and (isinstance(leak, torch.Tensor) or leak > 0):
        if isinstance(leak, torch.Tensor):  # JAX's branch-free form
            pitch_ref = torch.where(leak > 0, pitch_ref, pose_cmd[:, 1])
        pose_cmd = torch.cat(
            [pose_cmd[:, :1], pitch_ref[:, None], pose_cmd[:, 2:]], 1
        )
    pose_hold = pose_cmd[:, :, None].expand(n, 6, h)
    integrate = (v_cmd_raw != 0)[..., None].expand(n, 6, 1)
    pose = torch.where(integrate, pose_int, pose_hold)
    vel = v_cmd[:, :, None].expand(n, 6, h)
    if mpc.cmd_body_frame:
        if cmd_ref is None:
            x0a, y0a, yaw0 = x_fb[:, 3:4], x_fb[:, 4:5], x_fb[:, 2:3]
        else:
            x0a, y0a, yaw0 = cmd_ref[:, 0:1], cmd_ref[:, 1:2], cmd_ref[:, 2:3]
        # closed-form arc integral of p_dot = Rz(yaw0 + wz s) @ v_body,
        # with the wz -> 0 limit
        if x_cmd is None:
            wz, vbx, vby = mpc.x_cmd[8], mpc.x_cmd[9], mpc.x_cmd[10]
            yaw_k = yaw0 + wz * dtk  # (N,h)
            if abs(wz) < 1e-6:
                ax = dtk * torch.cos(yaw0)
                ay = dtk * torch.sin(yaw0)
            else:
                ax = (torch.sin(yaw_k) - torch.sin(yaw0)) / wz
                ay = (torch.cos(yaw0) - torch.cos(yaw_k)) / wz
        else:  # commands as (1,) or (N,1) columns against the (N,h) rows
            wz, vbx, vby = (x_cmd[..., i:i + 1] for i in (8, 9, 10))
            yaw_k = yaw0 + wz * dtk
            small = torch.abs(wz) < 1e-6
            w_safe = torch.where(small, torch.ones_like(wz), wz)
            ax = torch.where(small, dtk * torch.cos(yaw0),
                             (torch.sin(yaw_k) - torch.sin(yaw0)) / w_safe)
            ay = torch.where(small, dtk * torch.sin(yaw0),
                             (torch.cos(yaw0) - torch.cos(yaw_k)) / w_safe)
        px = x0a + ax * vbx - ay * vby
        py = y0a + ay * vbx + ax * vby
        vx = torch.cos(yaw_k) * vbx - torch.sin(yaw_k) * vby
        vy = torch.sin(yaw_k) * vbx + torch.cos(yaw_k) * vby
        pose = torch.cat([pose[:, :2], yaw_k[:, None], px[:, None], py[:, None],
                          pose[:, 5:]], 1)
        vel = torch.cat([vel[:, :3], vx[:, None], vy[:, None], vel[:, 5:]], 1)
    ones = torch.ones((n, 1, h), dtype=dtype, device=device)
    x_ref = torch.cat([pose, vel, ones], dim=1)
    if mpc.compat_ref_col0_bug:
        # column 0 = feedback state (reference ``:63``)
        x0 = torch.cat([x_fb[:, :12], torch.ones((n, 1), dtype=dtype, device=device)], 1)
        x_ref = torch.cat([x0[:, :, None], x_ref[:, :, 1:]], 2)
    return x_ref


def _raibert_xy(x_fb: torch.Tensor, mpc: MpcConfig, lookahead,
                v_int: torch.Tensor | None = None,
                x_cmd: torch.Tensor | None = None,
                per_env: dict | None = None):
    """Raibert foot target ``p + v T_eff + kv (p - p_cmd)`` -> (fx, fy),
    each (N,). ``lookahead``: a float or (N,); ``per_env``: the gains as
    (N,) tensors overriding the config's."""

    def gain(name):
        return config_value(mpc, name, per_env)

    ff = 0.5 * lookahead * gain("raibert_ff_scale")
    cmd_vx, cmd_vy = cmd_entry(mpc, x_cmd, 9), cmd_entry(mpc, x_cmd, 10)
    if mpc.cmd_body_frame:
        yaw = x_fb[:, 2]
        vcx = torch.cos(yaw) * cmd_vx - torch.sin(yaw) * cmd_vy
        vcy = torch.sin(yaw) * cmd_vx + torch.cos(yaw) * cmd_vy
        kv_x = kv_y = 0.0
    else:
        vcx, vcy = cmd_vx, cmd_vy
        kv_x = gain("kv") * (x_fb[:, 3] - cmd_entry(mpc, x_cmd, 3))
        kv_y = gain("kv") * (x_fb[:, 4] - cmd_entry(mpc, x_cmd, 4))
    v_err = torch.sqrt((x_fb[:, 9] - vcx) ** 2 + (x_fb[:, 10] - vcy) ** 2)
    capture = torch.clamp(
        gain("raibert_capture_gain") + gain("capture_sched") * v_err, max=1.0
    )
    if x_cmd is None:
        kc = capture * math.sqrt(max(mpc.x_cmd[5], 0.0) / 9.81)
    else:
        kc = capture * torch.sqrt(torch.clamp(x_cmd[..., 5], min=0.0) / 9.81)
    vx_m = x_fb[:, 9] + gain("raibert_am_y") * x_fb[:, 7]
    vy_m = x_fb[:, 10] - gain("raibert_am_x") * x_fb[:, 6]
    pp = gain("raibert_pitch_place") * (x_fb[:, 1] - gain("raibert_pitch_nom"))
    fx = x_fb[:, 3] + vx_m * ff + kc * (vx_m - vcx) + kv_x + pp
    fy = x_fb[:, 4] + vy_m * ff + kc * (vy_m - vcy) + kv_y
    if v_int is not None:
        fx = fx - gain("raibert_vint") * v_int[:, 0]
        fy = fy - gain("raibert_vint") * v_int[:, 1]
    return fx, fy


def foot_reference(
    x_fb: torch.Tensor,
    t: torch.Tensor,
    foot: torch.Tensor,
    mpc: MpcConfig,
    contact: torch.Tensor,
    gait: GaitConfig | None = None,
    terrain=None,
    v_int: torch.Tensor | None = None,
    x_cmd: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> torch.Tensor:
    """Foot-position reference over the horizon -> (N, 6, h).

    Columns hold the current feet for the rest of this stance phase, the
    one-phase Raibert target for the next, then the two-phase target; the
    selector is the cumulative contact-flip count along the window. Falls
    back to the current feet when the first step is not single-stance. On a
    ``terrain`` the two targets land on its surface (z = 0 without one).

    Args:
      foot: (N, 6) current world foot positions.
      contact: (N, h, 2) contact flags.
      per_env: (N,) ``dt``, ``kv`` and Raibert gains overriding the
        config's.
    """
    n, h = x_fb.shape[0], mpc.h
    t_p = phase_time(mpc, gait, per_env)
    fx1, fy1 = _raibert_xy(x_fb, mpc, t_p, v_int, x_cmd, per_env)
    fx2, fy2 = _raibert_xy(x_fb, mpc, 2.0 * t_p, v_int, x_cmd, per_env)
    if mpc.compat_foot_ref_bug:
        # reference ``:87``: x_fb[10] in place of x_fb[4]
        fy2 = (
            x_fb[:, 10]
            + x_fb[:, 10] * 0.5 * mpc.h * config_value(mpc, "dt", per_env)
            + config_value(mpc, "kv", per_env) * (x_fb[:, 4] - cmd_entry(mpc, x_cmd, 4))
        )
    if terrain is None:
        z1 = torch.zeros_like(fx1)
        z2 = torch.zeros_like(fx2)
    else:
        z1 = terrain.height(fx1, fy1)
        z2 = terrain.height(fx2, fy2)
    foot_1 = torch.stack([fx1, fy1, z1, fx1, fy1, z1], -1)  # (N,6)
    foot_2 = torch.stack([fx2, fy2, z2, fx2, fy2, z2], -1)

    flips = torch.any(contact[:, 1:] != contact[:, :-1], dim=2).to(torch.int64)
    sel = torch.cat(
        [torch.zeros((n, 1), dtype=torch.int64, device=x_fb.device),
         torch.cumsum(flips, dim=1)], 1,
    ).clamp(max=2)  # (N,h)
    stacked = torch.stack([foot, foot_1, foot_2], dim=1)  # (N,3,6)
    walking_ref = torch.gather(
        stacked, 1, sel[:, :, None].expand(n, h, 6)
    ).transpose(1, 2)  # (N,6,h)
    tiled = foot[:, :, None].expand(n, 6, h)
    single_stance = (contact[:, 0, :].sum(-1) == 1)[:, None, None]
    return torch.where(single_stance, walking_ref, tiled)

"""Single-rigid-body linearization (L4): the counterpart of
``biped_mpc_py_tpu/models/srb.py``.

Per-horizon-step model ``x_{k+1} = A_k x_k + B_k u_k`` of the
gravity-augmented SRB state, built in closed form for every env and step at
once. The documented deviations from the reference (canonical Euler order,
intrinsic ZYX rotation, ``I_w = Rᵀ I_body R``) are those of the JAX module.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import MpcConfig, config_value
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.ops.linalg3 import inv3, mm3, mtm3
from benchmark.reference.ops.rotations import eul2rotm, euler_rate_matrix_inv, skew


def _per_env(p: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Broadcast a (N, ...) parameter over ``batch_dims - 1`` extra axes
    after the env axis."""
    n, rest = p.shape[0], p.shape[1:]
    return p.reshape((n,) + (1,) * (batch_dims - 1) + rest)


def linearize(
    mpc: MpcConfig,
    biped: BipedParams,
    x_ref: torch.Tensor,
    foot_ref: torch.Tensor,
    per_env: dict | None = None,
):
    """Linearization -> (A (..., 13, 13), B (..., 13, 12)).

    Args:
      x_ref: (N, ..., 13) reference states; the first axis is the env axis
        that ``biped``'s fields carry.
      foot_ref: (N, ..., 6) both feet's world positions.
      per_env: an (N,) ``"dt"`` overriding the config's step.
    """
    dtype, device = x_ref.dtype, x_ref.device
    batch = x_ref.shape[:-1]
    nb = len(batch)
    pitch, yaw = x_ref[..., 1], x_ref[..., 2]
    Rot = eul2rotm(x_ref[..., 0:3])
    I_diag = _per_env(biped.I_diag.to(dtype), nb)
    # reference form I_w = Rᵀ I_body R; diag(I_body) @ R is a row scale
    I_w = mtm3(Rot, I_diag[..., :, None] * Rot)
    I_w_inv = inv3(I_w)

    E_inv = euler_rate_matrix_inv(pitch, yaw)

    eye3 = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
    z33 = torch.zeros(batch + (3, 3), dtype=dtype, device=device)
    z31 = torch.zeros(batch + (3, 1), dtype=dtype, device=device)
    g = _per_env(biped.g.to(dtype), nb)
    g_col = torch.stack(
        [torch.zeros_like(g), torch.zeros_like(g), -g], -1
    ).expand(batch + (3,))[..., None]
    dt = config_value(mpc, "dt", per_env)
    if isinstance(dt, torch.Tensor):
        dt = _per_env(dt.to(dtype), nb)[..., None, None]  # against (N, ..., 3, 3)
    row0 = torch.cat([eye3, z33, E_inv * dt, z33, z31], dim=-1)
    row1 = torch.cat([z33, eye3, z33, eye3 * dt, z31], dim=-1)
    row2 = torch.cat([z33, z33, eye3, z33, z31], dim=-1)
    row3 = torch.cat([z33, z33, z33, eye3, g_col * dt], dim=-1)
    last = torch.cat(
        [torch.zeros(batch + (1, 12), dtype=dtype, device=device),
         torch.ones(batch + (1, 1), dtype=dtype, device=device)],
        dim=-1,
    )
    A = torch.cat([row0, row1, row2, row3, last], dim=-2)

    r1 = foot_ref[..., 0:3] - x_ref[..., 3:6]
    r2 = foot_ref[..., 3:6] - x_ref[..., 3:6]
    Iinv_dt = I_w_inv * dt
    m = _per_env(biped.m.to(dtype), nb)
    m_eye = eye3 * (dt / m[..., None, None])
    z3_12 = torch.zeros(batch + (3, 12), dtype=dtype, device=device)
    brow2 = torch.cat(
        [mm3(Iinv_dt, skew(r1)), mm3(Iinv_dt, skew(r2)), Iinv_dt, Iinv_dt],
        dim=-1,
    )
    brow3 = torch.cat([m_eye, m_eye, z33, z33], dim=-1)
    B = torch.cat(
        [z3_12, z3_12, brow2, brow3,
         torch.zeros(batch + (1, 12), dtype=dtype, device=device)],
        dim=-2,
    )
    return A, B


def linearize_horizon(
    mpc: MpcConfig,
    biped: BipedParams,
    x_ref: torch.Tensor,
    foot_ref: torch.Tensor,
    per_env: dict | None = None,
):
    """All h horizon steps of every env -> (A (N, h, 13, 13), B (N, h, 13, 12)).

    Args:
      x_ref: (N, 13, h) state reference.
      foot_ref: (N, 6, h) foot reference.
      per_env: an (N,) ``"dt"`` overriding the config's step.
    """
    return linearize(mpc, biped, x_ref.transpose(1, 2), foot_ref.transpose(1, 2), per_env)

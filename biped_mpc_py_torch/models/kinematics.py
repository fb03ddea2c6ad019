"""HECTOR leg kinematics (L2): the counterpart of
``biped_mpc_py_tpu/models/kinematics.py``, batched over a leading env axis.

One 5-DoF chain per leg,

    p_foot_body(q) = Rz(q0) @ (hip + Rx(q1) @ (abd + pitch_chain(q2, q3, q4))),

and its position Jacobian in closed form (the JAX package differentiates
the same function with ``jax.jacfwd``; the columns here are its analytic
derivative, as ``ops/pallas/tick_kernel.py::_leg_jac_cols`` writes them).
The joint-axis rows of the motor Jacobian follow from the chain. ``side``
is +1 for leg 0 (left) and -1 for leg 1; geometry fields are per env (N,).
"""

from __future__ import annotations

import torch

from biped_mpc_py_torch.models.biped import BipedParams, LegGeometry
from biped_mpc_py_torch.ops.rotations import eul2rotm

SIDES = (1.0, -1.0)


def _pitch_sums(q: torch.Tensor, geom: LegGeometry):
    """Cumulative pitch angles th (N,3), link lengths L (N,3), and
    s = Σ L sin th, c = Σ L cos th (N,)."""
    th = torch.cumsum(q[:, 2:5], -1)
    L = torch.stack([geom.l_thigh, geom.l_shank, geom.l_foot], -1).to(q.dtype)
    return th, L, torch.sum(L * torch.sin(th), -1), torch.sum(L * torch.cos(th), -1)


def leg_fk_body(q: torch.Tensor, side, geom: LegGeometry) -> torch.Tensor:
    """Foot position in the body frame (N,3) from the joint angles q (N,5)
    [hip yaw, hip roll, hip pitch, knee, ankle] (``kinematics.py:31``)."""
    _, _, s, c = _pitch_sums(q, geom)
    abd = (geom.abd_y.to(q.dtype) * side + geom.abd_y_const.to(q.dtype)).expand_as(s)
    c1, s1 = torch.cos(q[:, 1]), torch.sin(q[:, 1])
    v = torch.stack([-s, c1 * abd - s1 * -c, s1 * abd + c1 * -c], -1)  # Rx(q1) (abd + pc)
    w = torch.stack([geom.hip_x, geom.hip_y * side, geom.hip_z], -1).to(q.dtype) + v
    c0, s0 = torch.cos(q[:, 0]), torch.sin(q[:, 0])
    return torch.stack([c0 * w[:, 0] - s0 * w[:, 1], s0 * w[:, 0] + c0 * w[:, 1], w[:, 2]], -1)


def leg_joint_axes(q: torch.Tensor) -> torch.Tensor:
    """Rotation axes of the 5 joints in the body frame (N,3,5): z, Rz(q0) x,
    and Rz(q0) Rx(q1) y for the three pitch joints."""
    c0, s0 = torch.cos(q[:, 0]), torch.sin(q[:, 0])
    c1, s1 = torch.cos(q[:, 1]), torch.sin(q[:, 1])
    zero, one = torch.zeros_like(c0), torch.ones_like(c0)
    a0 = torch.stack([zero, zero, one], -1)
    a1 = torch.stack([c0, s0, zero], -1)
    ap = torch.stack([-s0 * c1, c0 * c1, s1], -1)
    return torch.stack([a0, a1, ap, ap, ap], -1)


def leg_jacobians(q: torch.Tensor, side, geom: LegGeometry):
    """Motor Jacobian Jm (N,6,5) and foot position Jacobian Jf (N,3,5)
    (``kinematics.py:102``): rows 0:3 are ∂p_foot/∂q of
    :func:`leg_fk_body`, rows 3:6 the joint axes."""
    th, L, s, c = _pitch_sums(q, geom)
    c0, s0 = torch.cos(q[:, 0]), torch.sin(q[:, 0])
    c1, s1 = torch.cos(q[:, 1]), torch.sin(q[:, 1])
    u1 = (geom.abd_y * side + geom.abd_y_const).to(q.dtype)
    u0, u2 = -s, -c  # u = abd + pitch chain
    w0 = geom.hip_x.to(q.dtype) + u0  # w = hip + Rx(q1) u
    w1 = geom.hip_y.to(q.dtype) * side + (c1 * u1 - s1 * u2)
    zero = torch.zeros_like(s)

    def rz(x, y, z):
        return torch.stack([c0 * x - s0 * y, s0 * x + c0 * y, z], -1)

    cols = [
        torch.stack([-s0 * w0 - c0 * w1, c0 * w0 - s0 * w1, zero], -1),  # dRz/dq0 w
        rz(zero, -s1 * u1 - c1 * u2, c1 * u1 - s1 * u2),  # Rz dRx/dq1 u
    ]
    LC, LS = L * torch.cos(th), L * torch.sin(th)
    for j in range(3):  # Rz Rx dpc/dq, dpc = (-Σ_{i>=j} L cos, 0, Σ_{i>=j} L sin)
        ds, dz = torch.sum(LC[:, j:], -1), torch.sum(LS[:, j:], -1)
        cols.append(rz(-ds, -s1 * dz, c1 * dz))
    jf = torch.stack(cols, -1)
    return torch.cat([jf, leg_joint_axes(q)], 1), jf


def _hip(biped: BipedParams, side, dtype) -> torch.Tensor:
    h = biped.hip_offset.to(dtype)
    return torch.stack([h[:, 0], h[:, 1] * side, h[:, 2]], -1)


def foot_positions_world(x_fb: torch.Tensor, q: torch.Tensor,
                         biped: BipedParams) -> torch.Tensor:
    """World positions of both feet (N,6) (``kinematics.py:115``):
    ``p + Rᵀ (p_foot_body + hip_offset_mirrored)`` with R =
    eul2rotm(x_fb[:, 0:3]) (the reference's Rᵀ, kept for parity)."""
    R = eul2rotm(x_fb[:, 0:3])
    out = []
    for leg, side in enumerate(SIDES):
        pf_b = leg_fk_body(q[:, 5 * leg:5 * leg + 5], side, biped.leg)
        local = pf_b + _hip(biped, side, q.dtype)
        out.append(x_fb[:, 3:6] + (R.transpose(1, 2) @ local[..., None])[..., 0])
    return torch.cat(out, -1)


def foot_velocities_world(x_fb: torch.Tensor, q: torch.Tensor, qd: torch.Tensor,
                          biped: BipedParams) -> torch.Tensor:
    """World foot velocities (N,2,3) through the leg Jacobians, ``Rᵀ Jf
    qd`` as the reference writes it (base twist ignored)."""
    R = eul2rotm(x_fb[:, 0:3])
    out = []
    for leg, side in enumerate(SIDES):
        _, jf = leg_jacobians(q[:, 5 * leg:5 * leg + 5], side, biped.jac_geometry)
        vb = jf @ qd[:, 5 * leg:5 * leg + 5, None]
        out.append((R.transpose(1, 2) @ vb)[..., 0])
    return torch.stack(out, 1)

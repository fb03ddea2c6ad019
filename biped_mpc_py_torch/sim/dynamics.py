"""Floating-base articulated dynamics, RNEA bias and CRBA mass matrix: the
counterpart of ``biped_mpc_py_tpu/sim/dynamics.py``, batched over a leading
env axis.

EOM:  M(q) qdd = tau_gen - bias(q, qd, f_ext)

External (contact) forces enter the RNEA backward pass directly. Two forms
of each algorithm, as in the JAX package: the generic tree walk over the 11
bodies, and the leg-vectorized ``*_lv`` form whose per-body tensors carry a
(2,) leg axis (5 levels deep). The engine runs the ``_lv`` form; the
generic one is its cross-check.
"""

from __future__ import annotations

import torch

from biped_mpc_py_torch.config import device_constant
from biped_mpc_py_torch.ops.rotations import quat_to_rotm, skew
from biped_mpc_py_torch.sim.model import (
    JOINT_AXES,
    N_BODIES,
    PARENT,
    ArticulatedModel,
)
from biped_mpc_py_torch.sim.spatial import (
    SpatialTransform,
    _mv,
    crf,
    crm,
    spatial_inertia,
    xform_force_inv,
    xform_inertia,
    xform_motion,
)

GRAVITY = 9.81


def _axes(dtype, device) -> torch.Tensor:
    return device_constant(JOINT_AXES, device, dtype)


def _motion_subspace(dtype, device) -> torch.Tensor:
    """S (10,6): joint j's motion subspace [axis; 0]."""
    axes = _axes(dtype, device)
    return torch.cat([axes, torch.zeros_like(axes)], -1)


def _axis_rotation(K: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """R_pc = I + sin(q) K + (1 - cos(q)) K² for skew(axis) K (...,3,3)
    and angles q (...), broadcast."""
    c, s = torch.cos(q)[..., None, None], torch.sin(q)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1 - c) * (K @ K)


def _gravity_accel(R_base: torch.Tensor, g: float) -> torch.Tensor:
    """The gravity trick's base acceleration [0; R_baseᵀ (0, 0, g)] (N,6)."""
    a_lin = g * R_base[:, 2, :]
    return torch.cat([torch.zeros_like(a_lin), a_lin], -1)


# ---------------------------------------------------------------------------
# generic tree walk
# ---------------------------------------------------------------------------


def joint_transforms(model: ArticulatedModel, q: torch.Tensor):
    """Per-joint parent->child transforms X_up[j] (list of 10), each with
    R (N,3,3) and p (3,)."""
    K = skew(_axes(q.dtype, q.device))  # (10,3,3)
    offs = model.joint_offset.to(q.dtype)
    return [
        SpatialTransform(
            R=_axis_rotation(K[j], q[:, j]).transpose(-1, -2), p=offs[j]
        )
        for j in range(10)
    ]


def body_inertias(model: ArticulatedModel):
    """6x6 spatial inertias of all bodies in their own frames (list)."""
    I6 = spatial_inertia(model.mass, model.com, model.inertia)
    return [I6[i] for i in range(N_BODIES)]


def forward_kinematics(model: ArticulatedModel, pos, quat, q):
    """World pose of every body: (R_wb list of (N,3,3), p_w list of (N,3)),
    body -> world."""
    R_wb = [quat_to_rotm(quat)]
    p_w = [pos]
    X_up = joint_transforms(model, q)
    for i in range(1, N_BODIES):
        par, X = PARENT[i], X_up[i - 1]
        p_w.append(p_w[par] + _mv(R_wb[par], X.p.expand_as(pos)))
        R_wb.append(R_wb[par] @ X.R.transpose(-1, -2))
    return R_wb, p_w


def _body_velocities(X_up, S, qd, v_base):
    """Body spatial velocities in body coordinates (list of 11, (N,6))."""
    v = [v_base]
    for i in range(1, N_BODIES):
        j = i - 1
        v.append(xform_motion(X_up[j], v[PARENT[i]]) + S[j] * qd[:, j, None])
    return v


def rnea_bias(model: ArticulatedModel, q, qd, v_base, R_base, f_ext,
              g: float = GRAVITY) -> torch.Tensor:
    """Bias force b(q, qd, f_ext) (N,16): RNEA with qdd = 0.

    Args:
      v_base: (N,6) base spatial velocity [omega; v] in base coordinates.
      R_base: (N,3,3) base -> world rotation.
      f_ext: list of 11 spatial forces (N,6) in each body's own frame,
        applied positively to the body.
    """
    S = _motion_subspace(q.dtype, q.device)
    X_up = joint_transforms(model, q)
    I_sp = body_inertias(model)
    a = [_gravity_accel(R_base, g)]
    v = [v_base]
    for i in range(1, N_BODIES):
        j = i - 1
        vJ = S[j] * qd[:, j, None]
        vi = xform_motion(X_up[j], v[PARENT[i]]) + vJ
        a.append(xform_motion(X_up[j], a[PARENT[i]]) + crm(vi, vJ))
        v.append(vi)
    f = [
        _mv(I_sp[i], a[i]) + crf(v[i], _mv(I_sp[i], v[i])) - f_ext[i]
        for i in range(N_BODIES)
    ]
    bias_joint = [None] * 10
    for i in range(N_BODIES - 1, 0, -1):
        j = i - 1
        bias_joint[j] = torch.sum(S[j] * f[i], -1)
        f[PARENT[i]] = f[PARENT[i]] + xform_force_inv(X_up[j], f[i])
    return torch.cat([f[0], torch.stack(bias_joint, -1)], -1)


def crba_mass_matrix(model: ArticulatedModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix M(q) (N,16,16) by the composite-rigid-body
    algorithm; rows/cols 0:6 are the floating base (base coordinates)."""
    n = q.shape[0]
    S = _motion_subspace(q.dtype, q.device)
    X_up = joint_transforms(model, q)
    Ic = [I.expand(n, 6, 6) for I in body_inertias(model)]
    for i in range(N_BODIES - 1, 0, -1):
        Ic[PARENT[i]] = Ic[PARENT[i]] + xform_inertia(X_up[i - 1], Ic[i])
    M = torch.zeros((n, 16, 16), dtype=q.dtype, device=q.device)
    M[:, 0:6, 0:6] = Ic[0]
    for i in range(1, N_BODIES):
        j = i - 1
        F = _mv(Ic[i], S[j].expand(n, 6))
        M[:, 6 + j, 6 + j] = torch.sum(S[j] * F, -1)
        b = i
        while PARENT[b] != -1:
            F = xform_force_inv(X_up[b - 1], F)
            b = PARENT[b]
            if b == 0:
                M[:, 0:6, 6 + j] = F
                M[:, 6 + j, 0:6] = F
            else:
                k = b - 1
                val = torch.sum(S[k] * F, -1)
                M[:, 6 + k, 6 + j] = val
                M[:, 6 + j, 6 + k] = val
    idx = torch.arange(6, 16, device=q.device)
    M[:, idx, idx] += model.armature
    return M


def _cholesky_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(M)
    return torch.cholesky_solve(rhs[..., None], L)[..., 0]


def forward_dynamics(model: ArticulatedModel, pos, quat, q, v_base, qd, tau,
                     f_ext, g: float = GRAVITY) -> torch.Tensor:
    """qdd (N,16): [base spatial acceleration (base coords); joint
    accelerations], by Cholesky of the CRBA mass matrix."""
    bias = rnea_bias(model, q, qd, v_base, quat_to_rotm(quat), f_ext, g)
    tau_gen = torch.cat([torch.zeros_like(tau[:, :6]), tau], -1)
    return _cholesky_solve(crba_mass_matrix(model, q), tau_gen - bias)


# ---------------------------------------------------------------------------
# leg-vectorized form: per-body tensors carry a (2,) leg axis
# ---------------------------------------------------------------------------


def _leg_transforms(model: ArticulatedModel, q2: torch.Tensor) -> SpatialTransform:
    """Joint transforms of both legs: R (N,2,5,3,3), p (2,5,3); q2 (N,2,5)."""
    K = skew(_axes(q2.dtype, q2.device)).reshape(2, 5, 3, 3)
    R_pc = _axis_rotation(K, q2)
    return SpatialTransform(
        R=R_pc.transpose(-1, -2), p=model.joint_offset.to(q2.dtype).reshape(2, 5, 3)
    )


def _leg_S(dtype, device) -> torch.Tensor:
    return _motion_subspace(dtype, device).reshape(2, 5, 6)


def _leg_inertias(model: ArticulatedModel) -> torch.Tensor:
    """(2,5,6,6) spatial inertias of the leg bodies."""
    return spatial_inertia(
        model.mass[1:].reshape(2, 5), model.com[1:].reshape(2, 5, 3),
        model.inertia[1:].reshape(2, 5, 3, 3),
    )


def _torso_inertia(model: ArticulatedModel) -> torch.Tensor:
    return spatial_inertia(model.mass[0], model.com[0], model.inertia[0])


def _level(X: SpatialTransform, l: int) -> SpatialTransform:
    return SpatialTransform(R=X.R[:, :, l], p=X.p[:, l])


def leg_kinematics_lv(model: ArticulatedModel, pos, quat, q, v_base, qd):
    """World poses and body-frame spatial velocities of the leg bodies.

    Returns (R_w (N,2,5,3,3), p_w (N,2,5,3), v (N,2,5,6), R0 (N,3,3)).
    """
    n = q.shape[0]
    q2, qd2 = q.reshape(n, 2, 5), qd.reshape(n, 2, 5)
    X = _leg_transforms(model, q2)
    S = _leg_S(q.dtype, q.device)
    R0 = quat_to_rotm(quat)
    R_prev = R0[:, None].expand(n, 2, 3, 3)
    p_prev = pos[:, None].expand(n, 2, 3)
    v_prev = v_base[:, None].expand(n, 2, 6)
    R_ws, p_ws, vs = [], [], []
    for l in range(5):
        Xl = _level(X, l)
        p_prev = p_prev + _mv(R_prev, Xl.p.expand(n, 2, 3))
        R_prev = R_prev @ Xl.R.transpose(-1, -2)
        v_prev = xform_motion(Xl, v_prev) + S[:, l] * qd2[:, :, l, None]
        R_ws.append(R_prev)
        p_ws.append(p_prev)
        vs.append(v_prev)
    return torch.stack(R_ws, 2), torch.stack(p_ws, 2), torch.stack(vs, 2), R0


def rnea_bias_lv(model: ArticulatedModel, q, qd, v_base, R_base, f_ext_legs,
                 f_ext_base, g: float = GRAVITY) -> torch.Tensor:
    """Leg-vectorized RNEA bias (N,16); equals :func:`rnea_bias`.

    ``f_ext_legs`` (N,2,5,6) in the leg bodies' frames, ``f_ext_base``
    (N,6)."""
    n = q.shape[0]
    q2, qd2 = q.reshape(n, 2, 5), qd.reshape(n, 2, 5)
    X = _leg_transforms(model, q2)
    S = _leg_S(q.dtype, q.device)
    I_legs = _leg_inertias(model).to(q.dtype)
    a_base = _gravity_accel(R_base, g)
    v_prev = v_base[:, None].expand(n, 2, 6)
    a_prev = a_base[:, None].expand(n, 2, 6)
    fs = []
    for l in range(5):
        Xl = _level(X, l)
        vJ = S[:, l] * qd2[:, :, l, None]
        v_l = xform_motion(Xl, v_prev) + vJ
        a_l = xform_motion(Xl, a_prev) + crm(v_l, vJ)
        Iv = _mv(I_legs[:, l], v_l)
        fs.append(_mv(I_legs[:, l], a_l) + crf(v_l, Iv) - f_ext_legs[:, :, l])
        v_prev, a_prev = v_l, a_l
    bias_cols = [None] * 5
    f_acc = fs[4]
    for l in range(4, -1, -1):
        bias_cols[l] = torch.sum(S[:, l] * f_acc, -1)  # (N,2)
        f_acc = xform_force_inv(_level(X, l), f_acc)
        if l > 0:
            f_acc = f_acc + fs[l - 1]
    I0 = _torso_inertia(model).to(q.dtype)
    f0 = (_mv(I0, a_base) + crf(v_base, _mv(I0, v_base)) - f_ext_base
          + torch.sum(f_acc, 1))
    bias_joints = torch.stack(bias_cols, -1).reshape(n, 10)  # leg-major
    return torch.cat([f0, bias_joints], -1)


def crba_mass_matrix_lv(model: ArticulatedModel, q: torch.Tensor) -> torch.Tensor:
    """Leg-vectorized CRBA (N,16,16); equals :func:`crba_mass_matrix`."""
    n = q.shape[0]
    X = _leg_transforms(model, q.reshape(n, 2, 5))
    S = _leg_S(q.dtype, q.device)
    I_legs = _leg_inertias(model).to(q.dtype)
    Ic = [None] * 5
    Ic[4] = I_legs[:, 4].expand(n, 2, 6, 6)
    for l in range(4, 0, -1):
        Ic[l - 1] = I_legs[:, l - 1] + xform_inertia(_level(X, l), Ic[l])
    base_block = _torso_inertia(model).to(q.dtype) + torch.sum(
        xform_inertia(_level(X, 0), Ic[0]), 1
    )
    Mj = torch.zeros((n, 2, 5, 5), dtype=q.dtype, device=q.device)
    coup = torch.zeros((n, 2, 5, 6), dtype=q.dtype, device=q.device)
    for j in range(4, -1, -1):
        F = _mv(Ic[j], S[:, j].expand(n, 2, 6))
        Mj[:, :, j, j] = torch.sum(S[:, j] * F, -1)
        for k in range(j - 1, -1, -1):
            F = xform_force_inv(_level(X, k + 1), F)
            val = torch.sum(S[:, k] * F, -1)
            Mj[:, :, j, k] = val
            Mj[:, :, k, j] = val
        coup[:, :, j] = xform_force_inv(_level(X, 0), F)
    M = torch.zeros((n, 16, 16), dtype=q.dtype, device=q.device)
    M[:, 0:6, 0:6] = base_block
    M[:, 6:11, 6:11] = Mj[:, 0]
    M[:, 11:16, 11:16] = Mj[:, 1]
    M[:, 0:6, 6:11] = coup[:, 0].transpose(-1, -2)
    M[:, 6:11, 0:6] = coup[:, 0]
    M[:, 0:6, 11:16] = coup[:, 1].transpose(-1, -2)
    M[:, 11:16, 0:6] = coup[:, 1]
    idx = torch.arange(6, 16, device=q.device)
    M[:, idx, idx] += model.armature
    return M


def forward_dynamics_lv(model: ArticulatedModel, pos, quat, q, v_base, qd, tau,
                        f_ext_legs, f_ext_base, g: float = GRAVITY,
                        Minv: torch.Tensor | None = None) -> torch.Tensor:
    """Leg-vectorized forward dynamics (N,16). ``Minv`` (N,16,16)
    optionally replaces the per-call Cholesky of M with a held inverse
    (see ``engine.art_step``)."""
    bias = rnea_bias_lv(model, q, qd, v_base, quat_to_rotm(quat), f_ext_legs,
                        f_ext_base, g)
    rhs = torch.cat([torch.zeros_like(tau[:, :6]), tau], -1) - bias
    if Minv is not None:
        return _mv(Minv, rhs)
    return _cholesky_solve(crba_mass_matrix_lv(model, q), rhs)

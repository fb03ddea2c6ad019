"""The articulated simulation engine: the counterpart of
``biped_mpc_py_tpu/sim/engine.py``, batched over a leading env axis.

:func:`art_step` advances the 16-DoF HECTOR by one control period with
``n_substeps`` semi-implicit Euler substeps of the leg-vectorized
Featherstone dynamics (``sim/dynamics.py``) and toe/heel penalty contact
(``sim/contact.py``) on the plane z = 0 or on a height-field ``Terrain``.
The torso frame origin is the nominal CoM, so the controller's feedback
``x_fb = [euler, pos, R omega_b, R v_b]`` has the SRB state's meaning.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from biped_mpc_py_torch.config import config_tensor
from biped_mpc_py_torch.ops.qp import ns_inverse
from biped_mpc_py_torch.ops.rotations import quat_integrate, quat_to_eul, quat_to_rotm
from biped_mpc_py_torch.sim.contact import contact_force_world
from biped_mpc_py_torch.sim.dynamics import (
    _body_velocities,
    _motion_subspace,
    crba_mass_matrix_lv,
    forward_dynamics_lv,
    forward_kinematics,
    joint_transforms,
    leg_kinematics_lv,
)
from biped_mpc_py_torch.sim.model import FOOT_BODIES, ArticulatedModel
from biped_mpc_py_torch.sim.spatial import _mv, _mtv
from biped_mpc_py_torch.utils.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class ArtState(TensorStruct):
    """Full articulated state of every env (``engine.py:36``)."""

    pos: torch.Tensor  # (N,3) base (nominal-CoM) position, world
    quat: torch.Tensor  # (N,4) base orientation (w,x,y,z), body -> world
    v_base: torch.Tensor  # (N,6) spatial base velocity [omega; v], base coords
    q: torch.Tensor  # (N,10) joint angles
    qd: torch.Tensor  # (N,10) joint velocities
    t: torch.Tensor  # (N,) time [s]

    @classmethod
    def standing(cls, n: int = 1, z0: float = 0.551, device=None,
                 dtype=torch.float32) -> "ArtState":
        """The reference's initial joint vector with feet just touching
        z = 0."""

        def zeros(*shape):
            return torch.zeros((n,) + shape, dtype=dtype, device=device)

        pos, quat = zeros(3), zeros(4)
        pos[:, 2] = z0
        quat[:, 0] = 1.0
        # the memoized constant: no host-to-device copy after the first call
        q = config_tensor([0, 0, -math.pi / 4, math.pi / 2, -math.pi / 4] * 2, pos)
        return cls(pos=pos, quat=quat, v_base=zeros(6),
                   q=q.repeat(n, 1), qd=zeros(10), t=zeros())

    def torso_state(self) -> torch.Tensor:
        """The raw torso-frame state (N,12) in the reference convention
        (:func:`com_feedback_state` is the controller's feedback)."""
        R = quat_to_rotm(self.quat)
        return torch.cat([
            quat_to_eul(self.quat), self.pos,
            _mv(R, self.v_base[:, 0:3]), _mv(R, self.v_base[:, 3:6]),
        ], -1)


def _soles_from_fk(model: ArticulatedModel, R_w, p_w) -> torch.Tensor:
    """World sole centers (N,6): the FK chain tip (0, 0, -l_foot) in each
    foot frame, with -l_foot read from the model's toe contact row."""
    tip_z = model.contact_points[0, 2].to(p_w.dtype)
    soles = p_w[:, :, 4] + R_w[:, :, 4, :, 2] * tip_z
    return soles.reshape(-1, 6)


def feedback_and_soles(model: ArticulatedModel, state: ArtState):
    """(x_fb (N,12), pf_w (N,6)) from one leg-kinematics pass
    (``engine.py:116``).

    The feedback is hybrid: whole-body CoM for x/y position and velocity,
    torso frame for z, torso attitude and angular velocity (see the JAX
    docstring for why).
    """
    R_w, p_w, v_legs, R0 = leg_kinematics_lv(
        model, state.pos, state.quat, state.q, state.v_base, state.qd
    )
    dtype = state.q.dtype
    m_legs = model.mass[1:].reshape(2, 5).to(dtype)
    c_legs = model.com[1:].reshape(2, 5, 3).to(dtype)
    total_m = torch.sum(model.mass)
    com_pts = p_w + _mv(R_w, c_legs.expand_as(p_w))  # (N,2,5,3)
    v_ci = v_legs[..., 3:6] + torch.cross(
        v_legs[..., 0:3], c_legs.expand_as(p_w), dim=-1
    )
    mom_legs = torch.einsum("lk,nlki->ni", m_legs, _mv(R_w, v_ci))
    c0 = model.com[0].to(dtype)
    m0 = model.mass[0]
    p_com = (
        m0 * (state.pos + _mv(R0, c0.expand_as(state.pos)))
        + torch.einsum("lk,nlki->ni", m_legs, com_pts)
    ) / total_m
    v0_ci = state.v_base[:, 3:6] + torch.cross(
        state.v_base[:, 0:3], c0.expand_as(state.pos), dim=-1
    )
    v_com = (m0 * _mv(R0, v0_ci) + mom_legs) / total_m
    v_t = _mv(R0, state.v_base[:, 3:6])
    x_fb = torch.cat([
        quat_to_eul(state.quat),
        p_com[:, 0:2], state.pos[:, 2:3],
        _mv(R0, state.v_base[:, 0:3]),
        v_com[:, 0:2], v_t[:, 2:3],
    ], -1)
    return x_fb, _soles_from_fk(model, R_w, p_w)


def com_feedback_state(model: ArticulatedModel, state: ArtState) -> torch.Tensor:
    """The controller feedback (N,12): :func:`feedback_and_soles`' first
    half."""
    return feedback_and_soles(model, state)[0]


def sole_positions(model: ArticulatedModel, state: ArtState) -> torch.Tensor:
    """World positions (N,6) of both sole centers."""
    R_w, p_w, _, _ = leg_kinematics_lv(
        model, state.pos, state.quat, state.q, state.v_base, state.qd
    )
    return _soles_from_fk(model, R_w, p_w)


def contact_point_states(model: ArticulatedModel, state: ArtState):
    """World positions (N,4,3) and velocities (N,4,3) of the toe/heel
    contact points by the generic tree walk, their bodies, and the world
    poses (R_wb, p_w) of every body."""
    R_wb, p_w = forward_kinematics(model, state.pos, state.quat, state.q)
    v = _body_velocities(
        joint_transforms(model, state.q),
        _motion_subspace(state.q.dtype, state.q.device), state.qd, state.v_base,
    )
    points, vels, bodies = [], [], []
    for c in range(4):
        b = FOOT_BODIES[c // 2]
        r = model.contact_points[c].expand_as(state.pos)
        points.append(p_w[b] + _mv(R_wb[b], r))
        w_b, v_b = v[b][:, 0:3], v[b][:, 3:6]
        vels.append(_mv(R_wb[b], v_b + torch.cross(w_b, r, dim=-1)))
        bodies.append(b)
    return torch.stack(points, 1), torch.stack(vels, 1), bodies, (R_wb, p_w)


def art_substep(model: ArticulatedModel, state: ArtState, tau: torch.Tensor,
                dt, terrain=None, Minv: torch.Tensor | None = None) -> ArtState:
    """One semi-implicit Euler substep of ``dt`` (a float, or (N,) per env,
    each env's ``t`` advancing by its own in f32) under joint torques tau
    (N,10) (``engine.py:188``). ``terrain``: the ``sim.contact.Terrain``
    under the toe/heel points, None = the plane z = 0.
    ``Minv`` (N,16,16) optionally holds the mass-matrix inverse (see
    :func:`art_step`)."""
    n, dtype = state.q.shape[0], state.q.dtype
    R_w, p_w, v_b, _ = leg_kinematics_lv(
        model, state.pos, state.quat, state.q, state.v_base, state.qd
    )
    # toe/heel contact points per foot: (N, 2 legs, 2 points, 3)
    r_local = model.contact_points.reshape(2, 2, 3).to(dtype)
    R_wf, p_wf, v_f = R_w[:, :, 4], p_w[:, :, 4], v_b[:, :, 4]
    R_wf2 = R_wf[:, :, None].expand(n, 2, 2, 3, 3)
    r_b = r_local.expand(n, 2, 2, 3)
    pts = p_wf[:, :, None] + _mv(R_wf2, r_b)
    v_pts = _mv(R_wf2, v_f[:, :, None, 3:6]
                + torch.cross(v_f[:, :, None, 0:3].expand_as(r_b), r_b, dim=-1))
    f_world = contact_force_world(model, pts, v_pts, terrain)
    f_b = _mtv(R_wf2, f_world)  # world -> foot frame
    n_b = torch.cross(r_b, f_b, dim=-1)
    wrench_foot = torch.cat([torch.sum(n_b, 2), torch.sum(f_b, 2)], -1)  # (N,2,6)
    f_ext_legs = torch.zeros((n, 2, 5, 6), dtype=dtype, device=state.q.device)
    f_ext_legs[:, :, 4] = wrench_foot

    # soft joint limits + viscous joint damping
    lim = model.joint_limits
    over = torch.clamp(state.q - lim[:, 1], min=0.0)
    under = torch.clamp(lim[:, 0] - state.q, min=0.0)
    in_violation = ((over > 0) | (under > 0)).to(dtype)
    tau_lim = (
        -model.joint_limit_stiffness * (over - under)
        - model.joint_limit_damping * state.qd * in_violation
    )
    tau_eff = tau + tau_lim - model.joint_damping * state.qd
    qdd = forward_dynamics_lv(
        model, state.pos, state.quat, state.q, state.v_base, state.qd,
        tau_eff, f_ext_legs, torch.zeros_like(state.v_base), Minv=Minv,
    )

    # semi-implicit: velocities first, then positions
    dt_col = dt[:, None] if isinstance(dt, torch.Tensor) else dt
    v_base = state.v_base + qdd[:, 0:6] * dt_col
    qd = state.qd + qdd[:, 6:16] * dt_col
    R = quat_to_rotm(state.quat)
    pos = state.pos + _mv(R, v_base[:, 3:6]) * dt_col
    quat = quat_integrate(state.quat, _mv(R, v_base[:, 0:3]), dt_col)
    return ArtState(pos=pos, quat=quat, v_base=v_base, q=state.q + qd * dt_col,
                    qd=qd, t=state.t + dt)


def mass_matrix_inv(model: ArticulatedModel, q: torch.Tensor) -> torch.Tensor:
    """Newton-Schulz inverse (12 steps) of the CRBA mass matrix at q
    (N,16,16)."""
    return ns_inverse(crba_mass_matrix_lv(model, q), n_iters=12)


def art_step(model: ArticulatedModel, state: ArtState, tau: torch.Tensor,
             dt, n_substeps: int = 80, terrain=None, m_refresh: int = 1,
             Minv: torch.Tensor | None = None) -> ArtState:
    """Advance one control period ``dt`` (a float, or (N,) per env) with tau
    held, in ``n_substeps`` substeps (``engine.py:261``).

    ``Minv``: a mass-matrix inverse held for the whole period. Otherwise
    ``m_refresh`` > 1 refreshes :func:`mass_matrix_inv` every ``m_refresh``
    substeps, and ``m_refresh`` = 1 factorizes M exactly at every substep.
    (The JAX ``unroll`` argument only tunes the scan's compilation; a
    Python loop has nothing to unroll.)
    """
    sub_dt = dt / n_substeps
    if Minv is not None:
        for _ in range(n_substeps):
            state = art_substep(model, state, tau, sub_dt, terrain, Minv)
        return state
    if m_refresh <= 1:
        for _ in range(n_substeps):
            state = art_substep(model, state, tau, sub_dt, terrain)
        return state
    if n_substeps % m_refresh:
        raise ValueError(f"n_substeps {n_substeps} is not a multiple of m_refresh {m_refresh}")
    for _ in range(n_substeps // m_refresh):
        Minv_ = mass_matrix_inv(model, state.q)
        for _ in range(m_refresh):
            state = art_substep(model, state, tau, sub_dt, terrain, Minv_)
    return state

"""MPC QP assembly and solve (L4): the counterpart of
``biped_mpc_py_tpu/ops/qp.py``.

The QP is the JAX package's: the states are eliminated losslessly
(``X = Sx x0 + Su U``), leaving 12h = 120 control variables and h per-step
blocks of ``m_step(mpc)`` constraint rows (24, or 28 with the torsional
cone). Every function takes a leading env axis.

One solve path: :func:`solve_qp` Ruiz-equilibrates the batch and maps the
warm start into the scaled space (on the card in one launch of the Ruiz
kernel, ``ops/cuda/ruiz_kernel.py``; on the CPU by :func:`ruiz_equilibrate`
and :func:`scaled_warm_start`), runs the scaled ADMM core
(:func:`biped_mpc_py_torch.ops.cuda.qp_kernel.fused_qp_solve`: the CUDA
kernel for tensors on the card, its plain PyTorch version for tensors on
the CPU), then unscales and recovers the predicted states and residuals.
A ``per_env`` dict (``config.py``) gives each env its own weights ``Q``
(N,13) and ``R`` (N,12), line-foot margins and ADMM ``rho``, ``sigma`` and
``alpha`` (N,), which the kernel reads per env.
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import MpcConfig, config_tensor, config_value, config_vector
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda.qp_kernel import fused_qp_solve
from biped_mpc_py_torch.ops.cuda.ruiz_kernel import fused_ruiz
from biped_mpc_py_torch.ops.linalg3 import mm3
from biped_mpc_py_torch.ops.rotations import eul2rotm
from biped_mpc_py_torch.utils.profiling import stage
from biped_mpc_py_torch.utils.struct import TensorStruct

_BIG = 1e20  # stand-in for +inf in one-sided rows (f32-safe)


@dataclasses.dataclass(frozen=True)
class CondensedQp(TensorStruct):
    """A batch of condensed MPC QPs."""

    P: torch.Tensor  # (N,120,120) cost Hessian (strictly PD)
    q: torch.Tensor  # (N,120)
    A_step: torch.Tensor  # (N,m_step,12) per-step constraint rows
    l: torch.Tensor  # (N,h,m_step) lower bounds
    u: torch.Tensor  # (N,h,m_step) upper bounds
    Sx: torch.Tensor  # (N,h,13,13) free response maps
    Su: torch.Tensor  # (N,h,13,12h) forced response map
    x0: torch.Tensor  # (N,13) initial augmented state


@dataclasses.dataclass(frozen=True)
class QpSolution(TensorStruct):
    """ADMM iterates and recovered trajectories (also the warm start)."""

    controls: torch.Tensor  # (N,h,12)
    states: torch.Tensor  # (N,h,13)
    z: torch.Tensor  # (N,h,m_step) constraint-space iterate
    y: torch.Tensor  # (N,h,m_step) dual iterate
    res_prim: torch.Tensor  # (N,) ||A u - z||_inf
    res_dual: torch.Tensor  # (N,) ||P u + q + A^T y||_inf


def friction_rows(mu: torch.Tensor) -> torch.Tensor:
    """Friction-pyramid rows (N,8,12): ±f_{x,y} - mu f_z <= 0 per foot
    (reference ``A_mu1``, ``bipedalLocomotionMPC.py:220-229``)."""
    n = mu.shape[0]
    F = torch.zeros((n, 8, 12), dtype=torch.float32, device=mu.device)
    for foot in range(2):
        o = 3 * foot
        F[:, 4 * foot + 0, o + 0] = 1.0
        F[:, 4 * foot + 1, o + 1] = 1.0
        F[:, 4 * foot + 2, o + 0] = -1.0
        F[:, 4 * foot + 3, o + 1] = -1.0
        F[:, 4 * foot: 4 * foot + 4, o + 2] = -mu.to(torch.float32)[:, None]
    return F


def m_step(mpc: MpcConfig) -> int:
    """Constraint rows per horizon step: 24, +4 torsional-cone rows when
    ``mpc.mu_z`` is set."""
    return 28 if mpc.mu_z is not None else 24


def torsional_rows(mpc: MpcConfig, device=None) -> torch.Tensor:
    """Torsional friction cone rows (4,12): ``±m_z - mu_z f_z <= 0`` per
    foot (only built when ``mpc.mu_z`` is set)."""
    Z = torch.zeros((4, 12), dtype=torch.float32, device=device)
    for foot, (fz, mzc) in enumerate(((2, 8), (5, 11))):
        Z[2 * foot + 0, mzc] = 1.0
        Z[2 * foot + 1, mzc] = -1.0
        Z[2 * foot: 2 * foot + 2, fz] = -float(mpc.mu_z)
    return Z


def _rz(psi: torch.Tensor) -> torch.Tensor:
    """(N,3,3) z-rotations for headings ``psi`` (N,)."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def line_foot_rows(
    biped: BipedParams, R: torch.Tensor, foot_yaw: torch.Tensor | None = None,
    shrink: tuple | None = None,
) -> torch.Tensor:
    """Line-foot (toe/heel rollover) rows (N,4,12) (reference ``A_LF1``,
    ``bipedalLocomotionMPC.py:253-263``).

    ``R`` (N,3,3) is the body attitude; ``foot_yaw`` (N,2) absolute foot
    headings turn the rows into each planted foot's frame
    ``Rz(psi - yaw) @ R``; ``shrink`` = (toe, heel) lever-arm margins,
    each a float or (N,).
    """
    toe_s, heel_s = (0.01, 0.02) if shrink is None else shrink
    lt = (biped.lt.to(R.dtype) - toe_s)[:, None]
    lh = (biped.lh.to(R.dtype) - heel_s)[:, None]
    if foot_yaw is None:
        a_l = a_r = R[:, :, 2]
        b_l = b_r = R[:, :, 1]
    else:
        yaw = torch.atan2(R[:, 1, 0], R[:, 0, 0])
        Rl = mm3(_rz(foot_yaw[:, 0] - yaw), R)
        Rr = mm3(_rz(foot_yaw[:, 1] - yaw), R)
        a_l, a_r = Rl[:, :, 2], Rr[:, :, 2]
        b_l, b_r = Rl[:, :, 1], Rr[:, :, 1]
    z3 = torch.zeros_like(a_l)
    return torch.stack(
        [
            torch.cat([-lh * a_l, z3, b_l, z3], -1),
            torch.cat([-lt * a_l, z3, -b_l, z3], -1),
            torch.cat([z3, -lh * a_r, z3, b_r], -1),
            torch.cat([z3, -lt * a_r, z3, -b_r], -1),
        ],
        1,
    )


def constraint_bounds(mpc: MpcConfig, biped: BipedParams, contact: torch.Tensor):
    """Per-step bounds (l, u), each (N, h, m_step(mpc)), contact-gated.

    Rows 0:8 friction (<= 0), 8:20 box on u (two-sided), 20:24 line-foot
    (<= 0), 24:28 torsional cone (<= 0, only with ``mpc.mu_z``). Swing feet
    get [0, 0] boxes. ``compat_force_box_bug`` bounds every force component
    below by ``f_min`` as the reference does; the default bounds only f_z.
    """
    c = contact  # (N,h,2)
    f_max, f_min = biped.f_max.to(c.dtype), biped.f_min.to(c.dtype)
    if mpc.compat_force_box_bug:
        f_lo = f_min
    else:
        f_lo = torch.stack([-f_max[:, 0], -f_max[:, 1], f_min[:, 2]], -1)
    tau_hi = biped.tau_max.to(c.dtype)
    if mpc.tau_z_max is not None:
        tau_hi = torch.cat(
            [tau_hi[:, :2], torch.clamp(tau_hi[:, 2:], max=float(mpc.tau_z_max))], -1
        )
    cl, cr = c[:, :, 0:1], c[:, :, 1:2]
    ub_box = torch.cat(
        [cl * f_max[:, None], cr * f_max[:, None],
         cl * tau_hi[:, None], cr * tau_hi[:, None]], -1,
    )  # (N,h,12)
    lb_box = torch.cat(
        [cl * f_lo[:, None], cr * f_lo[:, None],
         cl * (-tau_hi[:, None]), cr * (-tau_hi[:, None])], -1,
    )
    free = torch.full(c.shape[:2] + (8,), -_BIG, dtype=c.dtype, device=c.device)
    zero = torch.zeros_like(free)
    l_parts = [free, lb_box, free[..., :4]]
    u_parts = [zero, ub_box, zero[..., :4]]
    if mpc.mu_z is not None:
        l_parts.append(free[..., :4])
        u_parts.append(zero[..., :4])
    return torch.cat(l_parts, -1), torch.cat(u_parts, -1)


def condense(
    mpc: MpcConfig,
    biped: BipedParams,
    x_fb: torch.Tensor,
    x_ref: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    contact: torch.Tensor,
    foot_yaw: torch.Tensor | None = None,
    per_env: dict | None = None,
) -> CondensedQp:
    """Condensed QP from the horizon linearization (``qp.py:266``).

    Dynamics: ``X_0 = A_0 x0 + B_0 u_0``, ``X_k = A_k X_{k-1} + B_k u_k``,
    so ``Sx[k] = A_k...A_0`` and ``Su[k, :, 12j:12j+12] = A_k...A_{j+1} B_j``.
    The prediction maps are built by the same paired chain as the JAX
    module, so the two agree to f32 roundoff.

    Args:
      x_fb: (N,12) feedback states.
      x_ref: (N,13,h) state references.
      A: (N,h,13,13), B: (N,h,13,12) from ``linearize_horizon``.
      contact: (N,h,2) contact flags.
      per_env: ``Q`` (N,13), ``R`` (N,12), ``lf_toe_shrink`` and
        ``lf_heel_shrink`` (N,) overriding the config's.
    """
    n = x_fb.shape[0]
    h, nx, nu = mpc.h, 13, 12
    dtype, device = A.dtype, A.device
    x0 = torch.cat([x_fb[:, :12], torch.ones((n, 1), dtype=dtype, device=device)], 1)
    eye = torch.eye(nx, dtype=dtype, device=device).expand(n, nx, nx)

    S0 = torch.zeros((n, h, nx, h, nu), dtype=dtype, device=device)
    for k in range(h):
        S0[:, k, :, k, :] = B[:, k]
    S0 = S0.reshape(n, h, nx, nu * h)
    if h % 2 == 0:
        A_ev, A_od = A[:, 0::2], A[:, 1::2]  # (N,h/2,13,13)
        A2 = A_od @ A_ev
        S2 = A_od @ S0[:, 0::2] + S0[:, 1::2]  # (N,h/2,13,12h)
        sx_p = eye
        su_p = torch.zeros((n, nx, nu * h), dtype=dtype, device=device)
        sx_odd, su_odd = [], []
        for k in range(h // 2):
            sx_p = A2[:, k] @ sx_p
            su_p = A2[:, k] @ su_p + S2[:, k]
            sx_odd.append(sx_p)
            su_odd.append(su_p)
        sx_odd = torch.stack(sx_odd, 1)  # prefixes at steps 1,3,...,h-1
        su_odd = torch.stack(su_odd, 1)
        sx_prev = torch.cat([eye[:, None], sx_odd[:, :-1]], 1)
        su_prev = torch.cat([torch.zeros_like(su_odd[:, :1]), su_odd[:, :-1]], 1)
        sx_even = A_ev @ sx_prev
        su_even = A_ev @ su_prev + S0[:, 0::2]
        Sx = torch.stack([sx_even, sx_odd], 2).reshape(n, h, nx, nx)
        Su = torch.stack([su_even, su_odd], 2).reshape(n, h, nx, nu * h)
    else:
        sx_rows, su_rows = [], []
        sx_prev = eye
        su_prev = torch.zeros((n, nx, nu * h), dtype=dtype, device=device)
        for k in range(h):
            sx_prev = A[:, k] @ sx_prev
            su_prev = A[:, k] @ su_prev + S0[:, k]
            sx_rows.append(sx_prev)
            su_rows.append(su_prev)
        Sx = torch.stack(sx_rows, 1)
        Su = torch.stack(su_rows, 1)

    Qd = config_vector(mpc, "Q", per_env, A)  # (13,) or (N,13)
    Rd = config_vector(mpc, "R", per_env, A)  # (12,) or (N,12)
    # P = Suᵀ Q̄ Su + R̄ ; q = Suᵀ Q̄ (Sx x0 - xref)
    SuQ = Su * (Qd[:, None, :, None] if Qd.dim() == 2 else Qd[:, None])
    Su_flat = Su.reshape(n, h * nx, nu * h)
    SuQ_flat = SuQ.reshape(n, h * nx, nu * h)
    P = SuQ_flat.transpose(1, 2) @ Su_flat + torch.diag_embed(Rd.tile((h,)))
    free = torch.einsum("nkij,nj->nki", Sx, x0) - x_ref.transpose(1, 2)  # (N,h,13)
    q = (SuQ_flat.transpose(1, 2) @ free.reshape(n, h * nx, 1))[..., 0]

    R = eul2rotm(x_fb[:, 0:3])
    box = torch.eye(nu, dtype=dtype, device=device).repeat(n, 1, 1)
    if foot_yaw is not None:
        box[:, 6:9, 6:9] = _rz(foot_yaw[:, 0]).transpose(1, 2)
        box[:, 9:12, 9:12] = _rz(foot_yaw[:, 1]).transpose(1, 2)
    rows = [
        friction_rows(biped.mu).to(dtype),
        box,
        line_foot_rows(
            biped, R, foot_yaw, shrink=(config_value(mpc, "lf_toe_shrink", per_env),
                                        config_value(mpc, "lf_heel_shrink", per_env)),
        ),
    ]
    if mpc.mu_z is not None:
        rows.append(torsional_rows(mpc, device).to(dtype).expand(n, 4, nu))
    A_step = torch.cat(rows, 1)
    l, u = constraint_bounds(mpc, biped, contact)
    return CondensedQp(P=P, q=q, A_step=A_step, l=l, u=u, Sx=Sx, Su=Su, x0=x0)


def sparse_qp_matrices(
    mpc: MpcConfig,
    biped: BipedParams,
    x_fb: torch.Tensor,
    x_ref: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    contact: torch.Tensor,
):
    """The reference script's sparse QP form, a parity surface
    (``qp.py:781``): the 25h stacked states and controls, from the same
    horizon linearization as :func:`condense` (same argument shapes). Not
    on any solve path.

    Returns (H, f, Aeq, beq, G, h_vec), each with a leading env axis:
    H (N,25h,25h), f (N,25h), Aeq (N,13h,25h), beq (N,13h), G (N,36h,25h),
    h_vec (N,36h). The inequality rows are grouped as in the reference: all
    friction rows (8h), all box rows (24h, upper then lower per step), all
    line-foot rows (4h).
    """
    n = x_fb.shape[0]
    h, nx, nu = mpc.h, 13, 12
    dtype, device = A.dtype, A.device
    nv = (nx + nu) * h
    ctrl0 = nx * h  # first control column
    Qd = config_tensor(mpc.Q, A)
    Rd = config_tensor(mpc.R, A)
    H = (2.0 * torch.diag(torch.cat([Qd.repeat(h), Rd.repeat(h)]))).expand(n, nv, nv)
    f = 2.0 * torch.cat(
        [-(x_ref.transpose(1, 2) * Qd).reshape(n, nx * h),
         torch.zeros((n, nu * h), dtype=dtype, device=device)], 1,
    )

    x0 = torch.cat([x_fb[:, :12], torch.ones((n, 1), dtype=dtype, device=device)], 1)
    Aeq = torch.zeros((n, nx * h, nv), dtype=dtype, device=device)
    eye = torch.eye(nx, dtype=dtype, device=device)
    for i in range(h):
        rows = slice(nx * i, nx * i + nx)
        Aeq[:, rows, rows] = eye
        Aeq[:, rows, ctrl0 + nu * i: ctrl0 + nu * i + nu] = -B[:, i]
        if i > 0:
            Aeq[:, rows, nx * (i - 1): nx * i] = -A[:, i]
    beq = torch.cat(
        [(A[:, 0] @ x0[:, :, None])[..., 0],
         torch.zeros((n, nx * (h - 1)), dtype=dtype, device=device)], 1,
    )

    R = eul2rotm(x_fb[:, 0:3])
    F = friction_rows(biped.mu).to(dtype)
    LF = line_foot_rows(biped, R).to(dtype)
    eye_u = torch.eye(nu, dtype=dtype, device=device)
    box = torch.cat([eye_u, -eye_u], 0).expand(n, 2 * nu, nu)

    def place(block):
        r = block.shape[1]
        G_blk = torch.zeros((n, r * h, nv), dtype=dtype, device=device)
        for k in range(h):
            G_blk[:, r * k: r * k + r, ctrl0 + nu * k: ctrl0 + nu * k + nu] = block
        return G_blk

    G = torch.cat([place(F), place(box), place(LF)], 1)
    l, u = constraint_bounds(mpc, biped, contact)
    h_box = torch.cat([u[:, :, 8:20], -l[:, :, 8:20]], -1).reshape(n, 2 * nu * h)
    h_vec = torch.cat(
        [torch.zeros((n, 8 * h), dtype=dtype, device=device), h_box,
         torch.zeros((n, 4 * h), dtype=dtype, device=device)], 1,
    )
    return H, f, Aeq, beq, G, h_vec


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with bf16 operands (rounded to nearest even), f32
    accumulation and an f32 result (``qp.py:387``, ``_mm_bf16``). A
    product of two bf16 values is exact in f32, so the f32 product of the
    rounded operands is that arithmetic."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def ns_inverse(K: torch.Tensor, n_iters: int = 14, bf16_iters: int = 0) -> torch.Tensor:
    """SPD inverse by Jacobi-preconditioned Newton-Schulz (``qp.py:403``),
    batched over leading axes.

      Khat = S K S   (S = diag(1/sqrt(diag K)))
      X_0  = I / ||Khat||_inf
      X    <- X (2I - Khat X)

    The first ``min(bf16_iters, n_iters)`` steps form both products by
    :func:`mm_bf16` (``MpcConfig.kinv_bf16_iters``: the climb, which the
    f32 steps after it correct), the others in f32.

    The diagonal is clamped at 1e-30 before the rsqrt, as the TPU kernel
    does (``qp_kernel.py:62``; the JAX plain path does not clamp): the CUDA
    kernel and this plain version then agree on a singular diagonal too.
    """
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    s = torch.rsqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30))
    Khat = K * s[..., :, None] * s[..., None, :]
    nrm = torch.amax(torch.sum(torch.abs(Khat), dim=-1), dim=-1)
    X = eye / nrm[..., None, None]
    two_eye = 2.0 * eye
    for _ in range(min(bf16_iters, n_iters)):
        X = mm_bf16(X, two_eye - mm_bf16(Khat, X))
    for _ in range(max(n_iters - bf16_iters, 0)):
        X = X @ (two_eye - Khat @ X)
    return X * s[..., :, None] * s[..., None, :]


def ruiz_equilibrate(qp: CondensedQp, n_iters: int = 10, bf16_norms: bool = False):
    """Modified-Ruiz equilibration (``qp.py:445``) of every env's QP.

      P̂ = c D P D,  q̂ = c D q,  Â_k = E_k A_step D_k,  l̂ = E l,  û = E u

    Returns ``(Ph (N,n,n), qh (N,n), Ah (N,h,m,12), lh, uh (N,h,m),
    D (N,h,12), E (N,h,m), c (N,))``. The row scaling is clamped at 1e6:
    an all-zero row would otherwise compound to f32 inf.

    ``bf16_norms`` (``MpcConfig.ruiz_bf16_norms``) takes the column norms
    of |P| in bf16, as the JAX package does: |P| and the scaling are
    rounded to bf16 (nearest even), so is each product, and the column
    maximum comes back to f32. The |A| norms and the scaled outputs stay
    f32.
    """
    n_env, h, m = qp.l.shape
    nu = 12
    dtype, device = qp.P.dtype, qp.P.device
    P, q = qp.P, qp.q
    norm_dtype = torch.bfloat16 if bf16_norms else dtype
    absP = torch.abs(P).to(norm_dtype)
    absA = torch.abs(qp.A_step)[:, None]  # (N,1,m,nu)
    D = torch.ones((n_env, h, nu), dtype=dtype, device=device)
    E = torch.ones((n_env, h, m), dtype=dtype, device=device)
    c = torch.ones((n_env,), dtype=dtype, device=device)

    def col_norm_P(Dg):
        # max_i |P_ij| D_i, per column j
        return torch.amax(absP * Dg.to(norm_dtype)[:, :, None], dim=1).to(dtype)

    for _ in range(n_iters):
        Dg = D.reshape(n_env, -1)
        colP = (c[:, None] * Dg * col_norm_P(Dg)).reshape(n_env, h, nu)
        EA = E[..., None] * absA  # (N,h,m,nu)
        colA = torch.amax(EA, dim=2) * D
        col = torch.sqrt(torch.clamp(torch.maximum(colP, colA), min=1e-8))
        d = 1.0 / col
        rowA = torch.sqrt(torch.clamp(torch.amax(EA * D[:, :, None, :], dim=3), min=1e-8))
        e = 1.0 / rowA
        Dn = D * d
        Dng = Dn.reshape(n_env, -1)
        colPn = c[:, None] * Dng * col_norm_P(Dng)
        gamma = 1.0 / torch.clamp(torch.mean(colPn, dim=1), min=1e-8)
        D, E, c = Dn, torch.clamp(E * e, max=1e6), c * gamma
    d_flat = D.reshape(n_env, -1)
    Ph = c[:, None, None] * P * d_flat[:, :, None] * d_flat[:, None, :]
    Ah = qp.A_step[:, None] * E[..., None] * D[:, :, None, :]
    qh = c[:, None] * d_flat * q
    return Ph, qh, Ah, E * qp.l, E * qp.u, D, E, c


def solver_args(mpc: MpcConfig, per_env: dict | None = None) -> dict:
    """The ADMM budget of ``mpc`` as keyword arguments of
    ``fused_qp_solve``: ``rho``, ``sigma`` and ``alpha`` are floats, or the
    (N,) ``per_env`` tensors where given; the bf16 knobs of the inverse and
    of the ADMM matvec are one value per launch (``STATIC_FIELDS``)."""
    def numeric(name):
        v = config_value(mpc, name, per_env)
        return v if isinstance(v, torch.Tensor) else float(v)

    return dict(
        rho=numeric("admm_rho"), n_iters=mpc.n_admm_iters,
        n_phases=mpc.admm_rho_phases, ns_iters=mpc.kinv_ns_iters,
        sigma=numeric("admm_sigma"), alpha=numeric("admm_alpha"),
        polish=bool(mpc.admm_polish), bf16_iters=int(mpc.kinv_bf16_iters),
        bf16_matvec=bool(mpc.admm_bf16_matvec),
    )


def scaled_warm_start(warm: QpSolution | None, D, E, c, n_var: int):
    """Map unscaled warm iterates into the scaled space -> (x0 (N,n),
    z0, y0 (N,h,m)); zeros for a cold start."""
    if warm is None:
        return (
            torch.zeros(D.shape[0], n_var, dtype=D.dtype, device=D.device),
            torch.zeros_like(E),
            torch.zeros_like(E),
        )
    x0 = (warm.controls.to(D.dtype) / D).reshape(D.shape[0], -1)
    z0 = E * warm.z.to(D.dtype)
    y0 = c[:, None, None] * warm.y.to(D.dtype) / E
    return x0, z0, y0


def recover_solution(qp: CondensedQp, x, z, y, D, E, c) -> QpSolution:
    """Unscale the ADMM iterates and recover states and residuals.

    The scaled stationarity ``cDPD x̂ + cDq + DAᵀE ŷ = 0`` makes the
    unscaled dual ``y = E ŷ / c``.
    """
    n_env, h, nu = D.shape
    x_u = D * x.reshape(n_env, h, nu)
    z_u = z / E
    y_u = E * y / c[:, None, None]
    U = x_u.reshape(n_env, -1)
    states = (
        torch.einsum("nkij,nj->nki", qp.Sx, qp.x0)
        + torch.einsum("nkij,nj->nki", qp.Su, U)
    )
    Ax = torch.einsum("nij,nkj->nki", qp.A_step, x_u)
    res_prim = torch.amax(torch.abs(Ax - torch.clamp(Ax, qp.l, qp.u)), dim=(1, 2))
    Aty = torch.einsum("nji,nkj->nki", qp.A_step, y_u).reshape(n_env, -1)
    res_dual = torch.amax(
        torch.abs(torch.einsum("nij,nj->ni", qp.P, U) + qp.q + Aty), dim=1
    )
    return QpSolution(
        controls=x_u, states=states, z=z_u, y=y_u,
        res_prim=res_prim, res_dual=res_dual,
    )


def scale_qp(qp: CondensedQp, mpc: MpcConfig, warm: QpSolution | None = None):
    """The stage ``qp.ruiz`` of :func:`solve_qp`: the Ruiz scaling at
    ``mpc.ruiz_iters`` and ``mpc.ruiz_bf16_norms`` and the warm start
    mapped into the scaled space -> ``(Ph, qh, Ah, lh, uh, D, E, c, x0, z0,
    y0)``, as :func:`ruiz_equilibrate` and :func:`scaled_warm_start` return
    them. On the card one launch of the Ruiz kernel
    (``ops/cuda/ruiz_kernel.py::fused_ruiz``), on the CPU
    :func:`scale_qp_reference`."""
    if qp.P.is_cuda:
        return fused_ruiz(
            qp.P, qp.q, qp.A_step, qp.l, qp.u,
            None if warm is None else (warm.controls, warm.z, warm.y),
            n_iters=mpc.ruiz_iters, bf16_norms=mpc.ruiz_bf16_norms,
        )
    return scale_qp_reference(qp, mpc, warm)


def scale_qp_reference(qp: CondensedQp, mpc: MpcConfig, warm: QpSolution | None = None):
    """The plain version of :func:`scale_qp` on any device:
    :func:`ruiz_equilibrate`, then :func:`scaled_warm_start`."""
    scaled = ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    D, E, c = scaled[5:]
    return scaled + scaled_warm_start(warm, D, E, c, scaled[0].shape[-1])


def solve_qp(
    qp: CondensedQp, mpc: MpcConfig, warm: QpSolution | None = None,
    per_env: dict | None = None,
) -> QpSolution:
    """Fixed-budget ADMM (BoxOSQP) solve of a batch of condensed QPs.

    Merges the JAX ``solve_qp`` (``qp.py:523``) and ``solve_qp_batch``
    (``qp.py:701``): Ruiz scaling, warm-start mapping, the scaled core in
    one ``fused_qp_solve`` call, unscaling. The device of the tensors picks
    the scaling (:func:`scale_qp`: the Ruiz kernel on the card) and the
    core (the QP kernel on the card, its plain version on the CPU).
    ``per_env``: (N,) ``admm_rho``, ``admm_sigma``, ``admm_alpha``
    overriding the config's, one value per env in the one launch. The
    config's three bf16 knobs (``ruiz_bf16_norms``, ``kinv_bf16_iters``,
    ``admm_bf16_matvec``) run as in the JAX ``solve_qp``. Its stages
    (``utils/profiling.py``): ``qp.ruiz`` (scaling and warm start),
    ``qp.kernel``, ``qp.unscale``.
    """
    with stage("qp.ruiz"):
        Ph, qh, Ah, lh, uh, D, E, c, x0, z0, y0 = scale_qp(qp, mpc, warm)
    with stage("qp.kernel"):
        x, z, y = fused_qp_solve(Ph, Ah, qh, lh, uh, x0, z0, y0, **solver_args(mpc, per_env))
    with stage("qp.unscale"):
        return recover_solution(qp, x, z, y, D, E, c)

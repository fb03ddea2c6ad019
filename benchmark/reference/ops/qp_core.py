"""The fused ADMM QP solve's plain version, frozen: the scaled core that
``csrc/qp_admm.cu`` computes on the card, in plain PyTorch.

For each rho phase it forms K = P + σI + blkdiag(Â_kᵀ diag(ρ_k) Â_k)
(equality rows u - l < 1e-6 get ρ ×1e3), inverts K by Newton-Schulz, runs
``n_iters // n_phases`` over-relaxed ADMM steps and re-picks ρ from the
residual ratio; an optional active-set polish follows. ``bf16_iters`` and
``bf16_matvec`` are the configuration's bf16 knobs, as the kernel runs them.
"""

from __future__ import annotations

import torch

EQ_RHO_BOOST = 1e3


def _kkt(P, Ah, weights, sigma):
    """K = P + σI + blkdiag(Âᵀ diag(w) Â) -> (N,n,n)."""
    n_env, h, _, nu = Ah.shape
    n = h * nu
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    AtWA = torch.einsum("nkji,nkj,nkjl->nkil", Ah, weights, Ah)  # (N,h,nu,nu)
    K = P + sigma * eye
    blocks = K.view(n_env, h, nu, h, nu).diagonal(dim1=1, dim2=3)  # (N,nu,nu,h)
    blocks += AtWA.permute(0, 2, 3, 1)
    return K


def _apply_A(Ah, v):
    """Â v per step: (N,h,m,nu) x (N,h,nu) -> (N,h,m)."""
    return torch.einsum("nkij,nkj->nki", Ah, v)


def _apply_At(Ah, w):
    """Âᵀ w per step: (N,h,m,nu) x (N,h,m) -> (N,h,nu)."""
    return torch.einsum("nkji,nkj->nki", Ah, w)


def fused_qp_solve(P, Ah, q, l, u, x0, z0, y0, *, rho, n_iters,
                             n_phases, ns_iters, sigma, alpha, polish, bf16_iters=0,
                             bf16_matvec=False):
    """The scaled ADMM core of the QP kernel (``csrc/qp_admm.cu``), in f32 but for the
    bf16 operands the two knobs ask for (``ops.qp.mm_bf16``).

    The scaled core of the JAX ``solve_qp`` (``qp.py:547-680``) on per-step
    blocks; the CPU tests hold it against the JAX package and the card
    holds the kernel against it. ``rho``, ``sigma`` and ``alpha`` enter as
    (N,1,1) f32 columns whether given as floats or per env, so a float and
    an (N,) tensor of its value run the same arithmetic (the kernel's: f32
    throughout, ``1 - alpha`` included).
    """
    from benchmark.reference.ops.qp import ns_inverse

    n_env, h, m, nu = Ah.shape
    n = h * nu

    def column(v):
        if isinstance(v, torch.Tensor):
            return v.to(P.dtype).reshape(n_env, 1, 1)
        return torch.full((n_env, 1, 1), float(v), dtype=P.dtype, device=P.device)

    rho_s, sigma, alpha = column(rho), column(sigma), column(alpha)
    is_eq = (u - l) < 1e-6
    qs = q.reshape(n_env, h, nu)
    x = x0.reshape(n_env, h, nu)
    z, y = z0, y0
    eps = 1e-8
    iters_per_phase = max(1, n_iters // n_phases)

    def kinv_apply(Kinv, r):
        return (Kinv @ r.reshape(n_env, n, 1)).reshape(n_env, h, nu)

    def bf16(t):
        return t.to(torch.bfloat16).float() if bf16_matvec else t

    for p in range(n_phases):
        rho_vec = torch.where(is_eq, rho_s * EQ_RHO_BOOST, rho_s)  # (N,h,m)
        Kinv = bf16(ns_inverse(_kkt(P, Ah, rho_vec, sigma), ns_iters, bf16_iters))
        for _ in range(iters_per_phase):
            rhs = sigma * x - qs + _apply_At(Ah, rho_vec * z - y)
            v = kinv_apply(Kinv, bf16(rhs))
            x_new = alpha * v + (1 - alpha) * x
            z_t = alpha * _apply_A(Ah, v) + (1 - alpha) * z
            z_new = torch.clamp(z_t + y / rho_vec, l, u)
            y = y + rho_vec * (z_t - z_new)
            x, z = x_new, z_new
        if p < n_phases - 1:
            Av = _apply_A(Ah, x)
            Px = (P @ x.reshape(n_env, n, 1)).reshape(n_env, h, nu)
            Aty = _apply_At(Ah, y)

            def mx(t):
                return torch.amax(torch.abs(t), dim=(1, 2))

            rp = mx(Av - z) / (torch.maximum(mx(Av), mx(z)) + eps)
            rd = mx(Px + qs + Aty) / (
                torch.maximum(torch.maximum(mx(Px), mx(Aty)), mx(qs)) + eps
            )
            rho_s = torch.clamp(
                rho_s * torch.sqrt(rp / (rd + eps))[:, None, None], 1e-2, 1e2
            )

    if polish:
        tol = 1e-5
        w_act = ((z <= l + tol) | (z >= u - tol)).to(P.dtype)
        b_act = torch.clamp(z, l, u)
        rho_pol = 1e4
        Kinv_pol = ns_inverse(_kkt(P, Ah, rho_pol * w_act, sigma), ns_iters, bf16_iters)
        lam = torch.zeros_like(b_act)
        for _ in range(3):
            rhs = -qs + _apply_At(Ah, w_act * (rho_pol * b_act - lam))
            x_p = kinv_apply(Kinv_pol, rhs)
            lam = lam + rho_pol * ((_apply_A(Ah, x_p) - b_act) * w_act)

        def merit(v):
            Av = _apply_A(Ah, v)
            viol = torch.sum(torch.abs(Av - torch.clamp(Av, l, u)), dim=(1, 2))
            vf = v.reshape(n_env, n)
            Pv = (P @ vf[:, :, None])[..., 0]
            obj = 0.5 * torch.sum(vf * Pv, 1) + torch.sum(q * vf, 1)
            return obj + 1e4 * viol

        accept = (merit(x_p) <= merit(x))[:, None, None]
        x = torch.where(accept, x_p, x)
        z = torch.where(accept, torch.clamp(_apply_A(Ah, x_p), l, u), z)

    return x.reshape(n_env, n), z, y

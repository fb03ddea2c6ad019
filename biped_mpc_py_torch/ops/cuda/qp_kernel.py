"""The fused ADMM QP solve: CUDA kernel wrapper and plain version.

Counterpart of ``biped_mpc_py_tpu/ops/pallas/qp_kernel.py::fused_qp_solve``.
:func:`fused_qp_solve` solves a batch of Ruiz-scaled box QPs

    min ½ xᵀP x + qᵀx   s.t.   l_k <= Â_k x_k <= u_k   (k = 0..h-1)

with the constraint matrix given as its h per-step blocks ``Ah`` (N,h,m,12),
not as the dense block-diagonal the TPU kernel's layout needed. For each rho
phase it forms K = P + σI + blkdiag(Â_kᵀ diag(ρ_k) Â_k) (equality rows
u - l < 1e-6 get ρ ×1e3), inverts K by Jacobi-preconditioned Newton-Schulz,
runs ``n_iters // n_phases`` over-relaxed ADMM steps, and re-picks ρ from the
residual ratio (OSQP rule, clipped to [1e-2, 1e2]). An optional active-set
polish follows (ρ_pol = 1e4, a second inverse, 3 augmented-Lagrangian steps,
accepted by an exact-penalty merit). The ADMM numerics ``rho``, ``sigma``
and ``alpha`` are each one float for the batch or an (N,) tensor, one value
per env (a config sweep's); the kernel reads an env's own values.

Two of the JAX package's bf16 knobs act here, one value per launch:
``bf16_iters`` (``MpcConfig.kinv_bf16_iters``) forms both products of the
first ``bf16_iters`` Newton-Schulz steps of every inverse from bf16
operands with f32 accumulation, and ``bf16_matvec``
(``MpcConfig.admm_bf16_matvec``) rounds K^-1 (once per rho phase) and each
ADMM step's right-hand side to bf16 before the f32-accumulated product; the
polish's K^-1 product stays f32, as in JAX (``qp.py:574-590``, ``:648-657``).

Tensors on the card go to the CUDA kernel in ``csrc/qp_admm.cu``, built with
``nvcc`` into ``build/torch_kernels/`` at first use and loaded with ctypes
(``ops/cuda/build.py``). Tensors on the CPU go to
:func:`fused_qp_solve_reference`, the plain PyTorch version of the same
algorithm (the scaled core of the JAX ``solve_qp``, ``qp.py:547-680``).
Nothing else chooses between the two.
"""

from __future__ import annotations

import ctypes

import torch

from biped_mpc_py_torch.ops.cuda import build

SOURCE = build.CSRC / "qp_admm.cu"
EQ_RHO_BOOST = 1e3
_N_MAX = 120  # variables the kernel's shared-memory tiles hold (h <= 10)
_MS_MAX = 28  # constraint rows per step the kernel holds

_lib = None


def _load():
    global _lib
    if _lib is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _lib = build.load(SOURCE, {
            "qp_admm_solve": (
                [ptr] * 11 + [i32] * 3 + [f32] * 3 + [ptr] * 3 + [i32] * 6 + [i32, ptr],
                i32,
            ),
            "qp_admm_error_string": ([i32], ctypes.c_char_p),
        })
    return _lib


def _check(P, Ah, q, l, u, x0, z0, y0):
    n_env, h, m, nu = Ah.shape
    n = h * nu
    want = {
        "P": (P, (n_env, n, n)), "Ah": (Ah, (n_env, h, m, nu)),
        "q": (q, (n_env, n)), "l": (l, (n_env, h, m)), "u": (u, (n_env, h, m)),
        "x0": (x0, (n_env, n)), "z0": (z0, (n_env, h, m)),
        "y0": (y0, (n_env, h, m)),
    }
    for name, (t, shape) in want.items():
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n_env, h, m, nu


def _check_numerics(P, **values):
    """Each ADMM numeric is a number or a contiguous f32 (N,) tensor on
    P's device."""
    for name, v in values.items():
        if not isinstance(v, torch.Tensor):
            continue
        if v.device != P.device:
            raise ValueError(f"{name} is on {v.device}, P on {P.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
        if tuple(v.shape) != (P.shape[0],):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, want ({P.shape[0]},)")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scalar_and_pointer(v):
    """(the float argument, the per-env pointer or None) of one numeric."""
    if isinstance(v, torch.Tensor):
        return 0.0, v.data_ptr()
    return float(v), None


def fused_qp_solve(P, Ah, q, l, u, x0, z0, y0, *, rho, n_iters, n_phases,
                   ns_iters, sigma, alpha, polish, bf16_iters=0, bf16_matvec=False):
    """Solve a batch of Ruiz-scaled box QPs -> (x (N,n), z (N,h,m),
    y (N,h,m)), all in the scaled space.

    Args:
      P: (N,n,n) scaled Hessian, n = 12h.
      Ah: (N,h,m,12) scaled per-step constraint blocks.
      q: (N,n); l, u: (N,h,m) scaled bounds; x0, z0, y0: warm start.
      rho, sigma, alpha: floats, or (N,) f32 tensors on P's device that
        give each env its own (the rho re-pick starts from the env's rho).
      bf16_iters: Newton-Schulz steps, from the first, whose products take
        bf16 operands (0: none).
      bf16_matvec: the ADMM steps' K^-1 product from bf16 operands.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_qp_solve.launches``; a CUDA-graph replay of a captured launch adds to it too,
    ``utils/graphs.py``); CPU tensors run
    :func:`fused_qp_solve_reference`.
    """
    n_env, h, m, nu = _check(P, Ah, q, l, u, x0, z0, y0)
    _check_numerics(P, rho=rho, sigma=sigma, alpha=alpha)
    if n_phases < 1:
        raise ValueError("n_phases must be >= 1")
    if int(bf16_iters) != bf16_iters or bf16_iters < 0:
        raise ValueError(f"bf16_iters must be an integer >= 0, got {bf16_iters}")
    if P.device.type == "cpu":
        return fused_qp_solve_reference(
            P, Ah, q, l, u, x0, z0, y0, rho=rho, n_iters=n_iters,
            n_phases=n_phases, ns_iters=ns_iters, sigma=sigma, alpha=alpha,
            polish=polish, bf16_iters=bf16_iters, bf16_matvec=bf16_matvec,
        )
    if P.device.type != "cuda":
        raise ValueError(f"fused_qp_solve runs on cuda or cpu, not {P.device}")
    if nu != 12 or h * nu > _N_MAX or m > _MS_MAX:
        raise ValueError(
            f"the CUDA kernel holds h*12 <= {_N_MAX} variables and <= "
            f"{_MS_MAX} rows per step; got h={h}, m={m}, nu={nu}"
        )
    if P.data_ptr() % 16:
        raise ValueError("P must be 16-byte aligned (the kernel reads it as float4)")
    x = torch.empty_like(q)
    z = torch.empty_like(l)
    y = torch.empty_like(l)
    if n_env == 0:
        return x, z, y
    lib = _load()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    (rho_f, rho_p), (sigma_f, sigma_p), (alpha_f, alpha_p) = (
        _scalar_and_pointer(v) for v in (rho, sigma, alpha))
    rc = lib.qp_admm_solve(
        *[t.data_ptr() for t in (P, Ah, q, l, u, x0, z0, y0, x, z, y)],
        n_env, h, m, rho_f, sigma_f, alpha_f, rho_p, sigma_p, alpha_p,
        int(n_iters), int(n_phases), int(ns_iters), int(bool(polish)),
        int(bf16_iters), int(bool(bf16_matvec)),
        P.device.index if P.device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if rc != 0:
        msg = lib.qp_admm_error_string(rc).decode()
        raise RuntimeError(f"qp_admm kernel launch failed: {msg} ({rc})")
    fused_qp_solve.launches += 1
    return x, z, y


fused_qp_solve.launches = 0


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


def fused_qp_solve_reference(P, Ah, q, l, u, x0, z0, y0, *, rho, n_iters,
                             n_phases, ns_iters, sigma, alpha, polish, bf16_iters=0,
                             bf16_matvec=False):
    """Plain PyTorch version of :func:`fused_qp_solve`, in f32 but for the
    bf16 operands the two knobs ask for (``ops.qp.mm_bf16``).

    The scaled core of the JAX ``solve_qp`` (``qp.py:547-680``) on per-step
    blocks; the CPU tests hold it against the JAX package and the card
    holds the kernel against it. ``rho``, ``sigma`` and ``alpha`` enter as
    (N,1,1) f32 columns whether given as floats or per env, so a float and
    an (N,) tensor of its value run the same arithmetic (the kernel's: f32
    throughout, ``1 - alpha`` included).
    """
    from biped_mpc_py_torch.ops.qp import ns_inverse

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

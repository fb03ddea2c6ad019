"""Ruiz equilibration of a batch of MPC QPs on the card: the CUDA kernel's
wrapper.

:func:`fused_ruiz` runs the stage ``qp.ruiz`` of
:func:`biped_mpc_py_torch.ops.qp.solve_qp` for tensors on the card in one
launch: the modified-Ruiz scaling of every env's QP
(``ops/qp.py::ruiz_equilibrate``) and the warm start mapped into the scaled
space (``ops/qp.py::scaled_warm_start``), one CTA per env, each env's P read
once into shared memory and its scaled P written once
(``csrc/ruiz.cu``). It replaces no TPU kernel: the JAX package's Ruiz is
plain jnp. Those two plain functions stay the CPU path and the yardstick the
card tests hold the kernel to: on the card the two agree bit for bit at the
repo's shapes, the kernel adding the n-term mean behind each iteration's
cost scaling in torch.mean's order there (n <= 128; ATen's order as of torch
2.11.0, against which it was matched). The kernel takes any
N, h and m (n = 12 h variables, m rows a step) whose P fits in the shared
memory of one block (on the H100 h <= 19), and raises on a shape that does
not.

Only tensors on the card: a CPU tensor raises (``solve_qp`` sends those to
the plain functions). The library is built with ``nvcc`` at first use
(``ops/cuda/build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from biped_mpc_py_torch.ops.cuda import build

SOURCE = build.CSRC / "ruiz.cu"
NU = 12

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
FUNCTIONS = {
    "ruiz_scale": ([_PTR] * 19 + [_I32] * 6 + [_PTR], _I32),
    "ruiz_smem_bytes": ([_I32] * 3, _I32),
    "ruiz_error_string": ([_I32], ctypes.c_char_p),
}

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = build.load(SOURCE, FUNCTIONS)
    return _lib


def _check(P, q, A_step, l, u, warm):
    """(N, h, m) of the inputs; raise on a device, dtype, shape or layout
    the kernel does not take."""
    if P.device.type != "cuda":
        raise ValueError(f"fused_ruiz runs on the card, not on {P.device}; the plain version "
                         "is ops.qp.ruiz_equilibrate with ops.qp.scaled_warm_start")
    n_env, h, m = l.shape
    n = NU * h
    want = {"P": (P, (n_env, n, n)), "q": (q, (n_env, n)), "A_step": (A_step, (n_env, m, NU)),
            "l": (l, (n_env, h, m)), "u": (u, (n_env, h, m))}
    if warm is not None:
        controls, z, y = warm
        want.update(controls=(controls, (n_env, h, NU)), z=(z, (n_env, h, m)),
                    y=(y, (n_env, h, m)))
    for name, (t, shape) in want.items():
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P.data_ptr() % 16:
        raise ValueError("P must be 16-byte aligned (the kernel reads it by a bulk copy)")
    return n_env, h, m


def fused_ruiz(P, q, A_step, l, u, warm=None, *, n_iters: int, bf16_norms: bool):
    """Ruiz-scale a batch of QPs on the card and map a warm start into the
    scaled space, in one launch.

    Args:
      P: (N,n,n) cost Hessians, n = 12h; q: (N,n).
      A_step: (N,m,12) the constraint rows of every step; l, u: (N,h,m).
      warm: None (a cold start: zeros), or the unscaled (controls (N,h,12),
        z (N,h,m), y (N,h,m)) of the last solve.
      n_iters, bf16_norms: ``MpcConfig.ruiz_iters`` and ``ruiz_bf16_norms``.

    Returns ``(Ph, qh, Ah, lh, uh, D, E, c, x0, z0, y0)`` in the layouts of
    ``ruiz_equilibrate`` and ``scaled_warm_start``. Counts the launch in
    ``fused_ruiz.launches`` (a CUDA-graph replay of a captured launch adds
    to it too, ``utils/graphs.py``).
    """
    n_env, h, m = _check(P, q, A_step, l, u, warm)
    if int(n_iters) != n_iters or n_iters < 0:
        raise ValueError(f"n_iters must be an integer >= 0, got {n_iters}")
    lib = _load()
    smem = lib.ruiz_smem_bytes(h, m, int(bool(bf16_norms)))
    optin = torch.cuda.get_device_properties(P.device).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"P of {NU * h} variables needs {smem} bytes of shared memory a "
                         f"block; the card gives {optin}")
    n = NU * h
    empty = P.new_empty
    out = (empty(n_env, n, n), empty(n_env, n), empty(n_env, h, m, NU), empty(n_env, h, m),
           empty(n_env, h, m), empty(n_env, h, NU), empty(n_env, h, m), empty(n_env),
           empty(n_env, n), empty(n_env, h, m), empty(n_env, h, m))
    if n_env:
        ins = (P, q, A_step, l, u) + (tuple(warm) if warm is not None else (None,) * 3)
        rc = lib.ruiz_scale(
            *[None if t is None else t.data_ptr() for t in ins + out],
            n_env, h, m, int(n_iters), int(bool(bf16_norms)),
            P.device.index if P.device.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(P.device).cuda_stream,
        )
        if rc != 0:
            msg = lib.ruiz_error_string(rc).decode()
            raise RuntimeError(f"ruiz kernel launch failed: {msg} ({rc})")
        fused_ruiz.launches += 1
    return out


fused_ruiz.launches = 0

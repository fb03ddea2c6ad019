"""ctypes binding of the repository's native C++ QP solver
(``runtime/qp_ipm.cpp``): the port's own copy of
``biped_mpc_py_tpu/runtime/native.py``.

A dependency-free dense interior-point solver for one QP on the host: an
oracle for the on-device ADMM solve and a solver for CPU deployments. The
shared library is compiled with ``g++`` at first use into ``build/`` at the
root of the checkout (git-ignored), under a temporary name that is then
renamed into place, so that two processes building at once cannot leave a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "runtime" / "qp_ipm.cpp"
BUILD_DIR = _ROOT / "build" / "native"
LIBRARY = BUILD_DIR / "libqp_ipm.so"

_lib = None


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(SOURCE), "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """Load the native library, building it first where it is missing or
    older than its source; returns the ctypes library."""
    global _lib
    if _lib is not None:
        return _lib
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(LIBRARY))
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.qp_solve_dense.restype = ctypes.c_int
    lib.qp_solve_dense.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_double,
        dp, dp, dp, dp,
    ]
    _lib = lib
    return lib


def _matrix(a, rows: int | None, n: int, name: str) -> np.ndarray:
    a = np.zeros((0, n)) if a is None else np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] != n or (rows is not None and a.shape[0] != rows):
        raise ValueError(f"{name} has shape {a.shape}, want ({'m' if rows is None else rows}, {n})")
    return a


def _vector(v, size: int, name: str) -> np.ndarray:
    v = np.zeros(0) if v is None else np.ascontiguousarray(np.reshape(v, -1), np.float64)
    if v.size != size:
        raise ValueError(f"{name} has {v.size} entries, want {size}")
    return v


def solve_qp_native(P, q, G=None, h=None, A=None, b=None,
                    max_iter: int = 50, tol: float = 1e-9):
    """Solve min 1/2 x'Px + q'x s.t. Gx <= h, Ax = b with the C++ IPM
    (numpy arrays on the host).

    Returns (x, info) with info's ``status`` ("optimal" or "failed"),
    ``iters``, ``residual`` and the multipliers ``y`` (equalities) and
    ``z`` (inequalities).
    """
    lib = load()
    q = np.ascontiguousarray(np.reshape(q, -1), np.float64)
    n = q.size
    P = _matrix(P, n, n, "P")
    G = _matrix(G, None, n, "G")
    A = _matrix(A, None, n, "A")
    m, p = G.shape[0], A.shape[0]
    h = _vector(h, m, "h")
    b = _vector(b, p, "b")
    x = np.zeros(n)
    y = np.zeros(max(p, 1))
    z = np.zeros(max(m, 1))
    info = np.zeros(3)
    status = lib.qp_solve_dense(
        n, m, p, P, q, G, h, A, b, int(max_iter), float(tol), x, y, z, info
    )
    return x, {
        "status": {0: "optimal", 1: "optimal", 2: "failed"}[status],
        "iters": int(info[0]),
        "residual": float(info[1]),
        "y": y[:p],
        "z": z[:m],
    }

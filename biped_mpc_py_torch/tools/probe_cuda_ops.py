"""Probe of the device math that the fused tick kernel uses, on the card.

Counterpart of ``tools/probe_mosaic_ops.py``, which asked the TPU compiler
which ops it lowers (it refused ``atan2``, so the Pallas tick kernel
carries its own polynomial atan2 and asin). On an NVIDIA GPU all of them
are native; this probe runs four as toy CUDA kernels (``csrc/probe_ops.cu``)
on an (8, 128) f32 array from ``RandomState(0)`` and holds each against its
numpy oracle:

- ``asin``: ``arcsin(clip(0.3 a, -1, 1))``;
- ``remainder``: the numpy-style remainder of ``a`` by 0.4 (f32);
- ``nested``: 8 rounds of (5 steps of ``x + 0.01 sin x``) then
  ``x + 0.1 (i + 1)``, in f32;
- ``atan2``: ``arctan2(a, b)``.

Run on a card: ``python -m biped_mpc_py_torch.tools.probe_cuda_ops``. On
CPU tensors :func:`probe_op` returns the numpy oracle (the plain version).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from biped_mpc_py_torch.ops.cuda import build

SOURCE = build.CSRC / "probe_ops.cu"
OPS = ("asin", "remainder", "nested", "atan2")
# Bound on |kernel - oracle| (the oracle in f64 except the f32 loop):
# CUDA's asinf and atan2f are within 2-3 ulp (< 1e-6 on these ranges); the
# remainder is exact; the nested loop compounds 40 sinf roundings on values
# up to ~8 (ulp 1e-6).
TOLERANCE = {"asin": 1e-6, "remainder": 1e-6, "nested": 1e-5, "atan2": 2e-6}
DIVISOR = np.float32(0.4)

_lib = None


def _load():
    global _lib
    if _lib is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _lib = build.load(SOURCE, {
            "probe_launch": ([i32, ptr, ptr, ptr, i32, i32, ptr], i32),
            "probe_error_string": ([i32], ctypes.c_char_p),
        })
    return _lib


def inputs() -> tuple[np.ndarray, np.ndarray]:
    """(a, b): two (8, 128) f32 arrays from ``RandomState(0)``; ``a`` is the
    TPU probe's input."""
    rng = np.random.RandomState(0)
    return rng.randn(8, 128).astype(np.float32), rng.randn(8, 128).astype(np.float32)


def oracle(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The numpy value of ``op`` on f32 ``a`` (and ``b``), as float64."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    if op == "asin":
        return np.arcsin(np.clip(a64 * 0.3, -1.0, 1.0))
    if op == "remainder":
        return np.remainder(a64, np.float64(DIVISOR))
    if op == "nested":
        x = a.astype(np.float32).copy()
        for i in range(8):
            for _ in range(5):
                x = x + np.float32(0.01) * np.sin(x)
            x = x + np.float32(0.1 * (i + 1))
        return x.astype(np.float64)
    if op == "atan2":
        return np.arctan2(a64, b64)
    raise ValueError(f"unknown probe op {op!r}; one of {OPS}")


def probe_op(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op`` on f32 ``a`` and ``b`` of one shape: CUDA tensors launch its
    kernel (counted in ``probe_op.launches``), CPU tensors return the numpy
    oracle as f32."""
    if op not in OPS:
        raise ValueError(f"unknown probe op {op!r}; one of {OPS}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("the probe takes float32 tensors")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must share shape and device")
    if a.device.type == "cpu":
        return torch.from_numpy(oracle(op, a.numpy(), b.numpy()).astype(np.float32))
    if a.device.type != "cuda":
        raise ValueError(f"probe_op runs on cuda or cpu, not {a.device}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    lib = _load()
    rc = lib.probe_launch(
        OPS.index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
        a.device.index if a.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: {lib.probe_error_string(rc).decode()}")
    probe_op.launches += 1
    return out


probe_op.launches = 0


def main(device="cuda") -> dict:
    """Run every op on ``device``, print each one's max |kernel - oracle|,
    and raise if one is past its TOLERANCE. Returns the errors."""
    a, b = inputs()
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    errs = {}
    for op in OPS:
        got = probe_op(op, ta, tb).cpu().numpy().astype(np.float64)
        errs[op] = float(np.abs(got - oracle(op, a, b)).max())
        print(f"{op}: max|err| = {errs[op]:.3e} (tolerance {TOLERANCE[op]:.0e})")
    bad = [op for op in OPS if not errs[op] <= TOLERANCE[op]]
    if bad:
        raise AssertionError(f"probe ops past their tolerance: {bad}")
    return errs


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_cuda_ops: no CUDA device")
    main()

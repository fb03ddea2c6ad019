"""The reference's matmul precision: full f32 (TF32 off in cuBLAS and
cuDNN), or TF32 for the lower-precision control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul(tf32: bool = False):
    """f32 matmuls inside the block (TF32 when ``tf32``); restores the
    caller's settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])

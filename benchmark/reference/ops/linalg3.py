"""3x3 products and inverse, batched over leading axes: the counterpart of
``biped_mpc_py_tpu/ops/linalg3.py`` (same broadcast-multiply-and-sum
forms, so the two agree to f32 roundoff)."""

from __future__ import annotations

import torch


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def mv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def mtv3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3)^T @ (..., 3)."""
    return torch.sum(a * v[..., :, None], dim=-2)


def mtm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3)^T @ (..., 3, 3)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 3, 3) inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    row0 = torch.stack([A, -(b * i - c * h), b * f - c * e], -1)
    row1 = torch.stack([B, a * i - c * g, -(a * f - c * d)], -1)
    row2 = torch.stack([C, -(a * h - b * g), a * e - b * d], -1)
    return torch.stack([row0, row1, row2], -2) * inv_det[..., None, None]

"""6D spatial-vector algebra (Featherstone): the counterpart of
``biped_mpc_py_tpu/sim/spatial.py``.

Spatial transforms stay factored as (R (...,3,3), p (...,3)); motion
vectors are [omega; v], force vectors [n; f], both in the local body
frame. Everything broadcasts over leading axes (envs, legs, levels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops.rotations import skew


class SpatialTransform(NamedTuple):
    """X = (R, p): frame B sits at p (A coordinates) with orientation R
    (rows = B axes in A coordinates, so R maps A-coords to B-coords)."""

    R: torch.Tensor  # (...,3,3)
    p: torch.Tensor  # (...,3)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v over leading axes: (...,3,3) x (...,3) -> (...,3)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mᵀ @ v over leading axes."""
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def xform_identity(dtype=torch.float32, device=None) -> SpatialTransform:
    """The identity transform (``spatial.py:32``)."""
    return SpatialTransform(R=torch.eye(3, dtype=dtype, device=device),
                            p=torch.zeros(3, dtype=dtype, device=device))


def xform_compose(X2: SpatialTransform, X1: SpatialTransform) -> SpatialTransform:
    """X2 ∘ X1 (apply X1 first)."""
    return SpatialTransform(R=X2.R @ X1.R, p=X1.p + _mtv(X1.R, X2.p))


def xform_motion(X: SpatialTransform, v: torch.Tensor) -> torch.Tensor:
    """Motion vector from A to B coordinates: [R w ; R (v - p × w)]."""
    w, vl = v[..., 0:3], v[..., 3:6]
    p = X.p.expand_as(w)
    return torch.cat([_mv(X.R, w), _mv(X.R, vl - torch.cross(p, w, dim=-1))], -1)


def xform_force(X: SpatialTransform, f: torch.Tensor) -> torch.Tensor:
    """Force vector from A to B coordinates: [R (n - p × f) ; R f]."""
    n, fl = f[..., 0:3], f[..., 3:6]
    p = X.p.expand_as(fl)
    return torch.cat([_mv(X.R, n - torch.cross(p, fl, dim=-1)), _mv(X.R, fl)], -1)


def xform_motion_inv(X: SpatialTransform, v: torch.Tensor) -> torch.Tensor:
    """Motion vector from B back to A coordinates."""
    wA = _mtv(X.R, v[..., 0:3])
    vA = _mtv(X.R, v[..., 3:6]) + torch.cross(X.p.expand_as(wA), wA, dim=-1)
    return torch.cat([wA, vA], -1)


def xform_force_inv(X: SpatialTransform, f: torch.Tensor) -> torch.Tensor:
    """Force vector from B back to A coordinates."""
    fA = _mtv(X.R, f[..., 3:6])
    nA = _mtv(X.R, f[..., 0:3]) + torch.cross(X.p.expand_as(fA), fA, dim=-1)
    return torch.cat([nA, fA], -1)


def crm(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v ×m m."""
    w, vl = v[..., 0:3], v[..., 3:6]
    mw, mv = m[..., 0:3], m[..., 3:6]
    return torch.cat(
        [torch.cross(w, mw, dim=-1),
         torch.cross(w, mv, dim=-1) + torch.cross(vl, mw, dim=-1)], -1
    )


def crf(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v ×f f = -(v ×m)ᵀ f."""
    w, vl = v[..., 0:3], v[..., 3:6]
    n, fl = f[..., 0:3], f[..., 3:6]
    return torch.cat(
        [torch.cross(w, n, dim=-1) + torch.cross(vl, fl, dim=-1),
         torch.cross(w, fl, dim=-1)], -1
    )


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    I_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the frame origin,
    [[I_com + m cx cxᵀ, m cx], [m cxᵀ, m 1]] with cx = skew(com)."""
    cx = skew(com)
    m = mass[..., None, None]
    cxT = cx.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([I_com + m * (cx @ cxT), m * cx], -1)
    bottom = torch.cat([m * cxT, m * eye3], -1)
    return torch.cat([top, bottom], -2)


def motion_matrix(X: SpatialTransform) -> torch.Tensor:
    """The 6x6 motion transform (A -> B): [[R, 0], [-R px, R]]."""
    R = X.R
    px = skew(X.p).expand(R.shape)
    zero = torch.zeros_like(R)
    return torch.cat(
        [torch.cat([R, zero], -1), torch.cat([-R @ px, R], -1)], -2
    )


def xform_inertia(X: SpatialTransform, I: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia from B (child) to A (parent) coordinates,
    Xmᵀ I Xm."""
    Xm = motion_matrix(X)
    return Xm.transpose(-1, -2) @ I @ Xm

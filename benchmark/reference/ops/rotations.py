"""Rotation and small-matrix utilities (L1): the counterpart of
``biped_mpc_py_tpu/ops/rotations.py``.

Shape-polymorphic over leading axes. Convention: eul = [roll, pitch, yaw],
R = Rz(yaw) @ Ry(pitch) @ Rx(roll); quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def eul2rotm(eul: torch.Tensor) -> torch.Tensor:
    """Euler angles [roll, pitch, yaw] (..., 3) -> rotation (..., 3, 3)."""
    cr, cp, cy = torch.cos(eul[..., 0]), torch.cos(eul[..., 1]), torch.cos(eul[..., 2])
    sr, sp, sy = torch.sin(eul[..., 0]), torch.sin(eul[..., 1]), torch.sin(eul[..., 2])
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of v (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    row0 = torch.stack([zero, -z, y], -1)
    row1 = torch.stack([z, zero, -x], -1)
    row2 = torch.stack([-y, x, zero], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def euler_rate_matrix_inv(pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the ZYX Euler-rate matrix (..., 3, 3)."""
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    inv_cp = 1.0 / cp
    tp = sp * inv_cp
    zero = torch.zeros_like(cp)
    one = torch.ones_like(cp)
    row0 = torch.stack([cy * inv_cp, sy * inv_cp, zero], -1)
    row1 = torch.stack([-sy, cy, zero], -1)
    row2 = torch.stack([cy * tp, sy * tp, one], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_to_rotm(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by world-frame angular velocity over dt
    (exponential map, renormalized; sinc-stable near zero)."""
    half = 0.5 * dt * omega
    theta2 = torch.sum(half * half, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    sinc = torch.where(theta2 > 1e-12, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    dq = torch.cat([torch.cos(theta), sinc * half], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def rotm_to_eul(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> Euler [roll, pitch, yaw] (ZYX)."""
    pitch = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], -1)


def quat_to_eul(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> Euler [roll, pitch, yaw] (ZYX)."""
    return rotm_to_eul(quat_to_rotm(q))


def eul_to_quat(eul: torch.Tensor) -> torch.Tensor:
    """Euler [roll, pitch, yaw] (ZYX) -> unit quaternion (w, x, y, z)."""
    hr, hp, hy = eul[..., 0] * 0.5, eul[..., 1] * 0.5, eul[..., 2] * 0.5
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        -1,
    )

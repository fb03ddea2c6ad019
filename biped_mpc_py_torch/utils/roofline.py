"""Least device times ("bounds") of the port's kernels on an NVIDIA H100.

A kernel's bound is the larger of two times for the same work: the bytes
that the function must move (each input read once, each output written
once) over the card's memory rate, and the operations it does over the
card's peak rate for their type. The peaks are NVIDIA's H100 SXM data sheet
figures, dense, at the full 700 W power limit; a card set below it runs
slower under load.

Every count here is derived from the shapes of the work, not from running
an implementation. Operations: one per add, subtract, multiply, divide,
min, max, compare and elementary function (sqrt, sin, cos, atan2, asin,
floor); 2mnk for an m x k by k x n product. Where a config flag picks one
of two branches, the shorter one is counted.
"""

from __future__ import annotations

import dataclasses

import torch

H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12   # TF32 on the tensor cores
H100_BF16_FLOPS = 989e12   # bf16 on the tensor cores
H100_BYTES_PER_S = 3.35e12


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """(least time in ms with every operation at the f32 peak outside the
    tensor cores, "operations" or "bytes": which of the two sets it)."""
    t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qp_solve_work(n_env: int, h: int, ms: int, *, n_iters: int, n_phases: int,
                  ns_iters: int, polish: bool, bf16_iters: int = 0, **_) -> dict:
    """Operations and bytes of one ``fused_qp_solve`` of ``n_env`` QPs with
    ``h`` steps of 12 variables and ``ms`` rows per step.

    Each inverse: K = P + sigma I + blkdiag(A_k' W_k A_k), its Jacobi
    scaling, the first Newton-Schulz step (elementwise: X0 is diagonal),
    ``ns_iters - 1`` steps of two n x n products, and K^-1 = S X S. Returns
    ``flops`` (all of it), ``ns_flops`` (the products), ``ns_bf16_flops``
    (those of them in the first ``bf16_iters`` steps, with bf16 operands)
    and ``bytes`` (P, Ah, q, l, u and the warm start read once; x, z, y
    written once; f32).
    """
    n, m = 12 * h, h * ms
    inverses = n_phases + int(bool(polish))
    ns = inverses * max(ns_iters - 1, 0) * 2 * 2 * n ** 3
    ns_bf16 = inverses * max(min(bf16_iters, ns_iters) - 1, 0) * 2 * 2 * n ** 3
    kkt = 12 * m + 2 * 144 * m + 144 * h + n                 # W A, A'(W A), + P, + sigma
    jacobi = 3 * n * n + 2 * n                               # S K S, its |row| sums, S
    first = (n * n + n) if ns_iters > 0 else 0               # X1 = 2 c I - c^2 Khat
    unscale = 2 * n * n                                      # S X S
    per_inverse = kkt + jacobi + first + unscale
    admm_iter = 2 * n * n + 2 * 2 * 12 * m + 12 * m + 5 * n  # K^-1 rhs, A v, A'w, updates
    admm = max(1, n_iters // n_phases) * n_phases * admm_iter
    repick = (n_phases - 1) * (2 * n * n + 4 * 12 * m + 6 * m + 6 * n)
    polish_ops = int(bool(polish)) * (3 * (2 * n * n + 4 * 12 * m + 6 * m + n)
                                      + 2 * (2 * n * n + 2 * 12 * m) + 8 * m + 4 * n)
    per_env = ns + inverses * per_inverse + admm + repick + polish_ops
    floats = n * n + 12 * m + 3 * n + 6 * m
    return {"flops": n_env * per_env, "ns_flops": n_env * ns,
            "ns_bf16_flops": n_env * ns_bf16, "bytes": 4 * n_env * floats}


def qp_solve_bound_ms(work: dict) -> tuple[float, str]:
    """The QP solve's bound: the larger of its bytes' time and its
    tensor-core floor, the least time with the Newton-Schulz products on the
    tensor cores, those of the bf16 steps in one bf16 pass, the others at
    f32 accuracy (three TF32 products each), and the rest in f32 outside
    them."""
    bf16 = work.get("ns_bf16_flops", 0)
    rest = work["flops"] - work["ns_flops"]
    floor = (3 * (work["ns_flops"] - bf16) / H100_TF32_FLOPS + bf16 / H100_BF16_FLOPS
             + rest / H100_F32_FLOPS) * 1e3
    t_bytes = work["bytes"] / H100_BYTES_PER_S * 1e3
    return (floor, "operations") if floor >= t_bytes else (t_bytes, "bytes")


# The articulated kernels' per-env operations (csrc/substep_device.cuh,
# csrc/tick.cu), from the tree's shapes: 2 legs of 5 one-axis joints, a
# 6 x 6 spatial inertia per body, 2 contact points per sole, a 16 x 16 Minv.
_ROT = 6                      # a 3-vector rotated about a coordinate axis
_CROSS = 9
_MV3 = 15                     # 3 x 3 matrix times 3-vector
_I6 = 66                      # 6 x 6 spatial inertia times 6-vector
_CRF = 3 * _CROSS + 3         # spatial force cross product
_TO_CHILD = _CROSS + 3 + 2 * _ROT   # motion vector into the child's frame
_TO_PARENT = 2 * _ROT + _CROSS + 3  # force vector into the parent's frame
_QUAT_TO_R = 39

_JOINT_FORWARD = (2 + _MV3 + 3 + 3 * _ROT     # cos, sin; the joint's pose
                  + 2 * _TO_CHILD + 1 + 8     # v, a, + qd, + v x (qd axis)
                  + 2 * _I6 + _CRF + 6)       # the body's force I a + v x* I v
_CONTACT_POINT = (_CROSS + 3 + 2 * _MV3 + 3   # its position and velocity
                  + 16                        # penetration, normal force, slip speed, friction
                  + 2 + _MV3 + _CROSS + 6)    # the force into the foot's frame, its moment
_JOINT_BACKWARD = _TO_PARENT + 6
_TORSO = 2 * _I6 + _CRF + 12
_JOINT_RHS = 15                               # limit spring-damper, damping, - bias
_MINV_RHS = 16 * 31
_INTEGRATE = 12 + 20 + _MV3 + 21 + 60 + 20    # v_base, qd, omega, pos, quaternion, q

SUBSTEP_OPS = (_QUAT_TO_R + 3 + 10 * _JOINT_FORWARD + 4 * _CONTACT_POINT + 12
               + 10 * _JOINT_BACKWARD - 2 * 6 + 12 + _TORSO + 10 * _JOINT_RHS
               + _MINV_RHS + _INTEGRATE)
"""Operations of one semi-implicit substep of one env: forward pass,
contact, backward pass (the root joint of each leg adds no child force),
torso, the joint-space right-hand side, Minv times it, the Euler step."""

_FEEDBACK = (_QUAT_TO_R + 51                                  # torso CoM, velocity
             + 10 * (2 + _MV3 + 3 + 3 * _ROT + _TO_CHILD + 1  # each body's pose and velocity
                     + _CROSS + 3 + 2 * _MV3 + 15)            # its CoM terms
             + 12 + 2 * _MV3 + 9)                             # soles; Euler angles, CoM means
_LEG_CONTROL = (77            # the leg's foot Jacobian and joint axes
                + 27 + _MV3   # foot velocity in the world
                + 25          # the swing target and PD force
                + 2 * _MV3 + 6 + 13   # the stance wrench in the body frame, pivot, hip yaw
                + 5 * 27 + 2)         # each joint's stance, swing and yaw torques, blended
_CONTROL = 17 + 18 + 48 + 2 * _LEG_CONTROL  # yaw, swing clock, Raibert target, legs
PERIOD_OPS = _FEEDBACK + _CONTROL + 33
"""Operations of one low-level period of one env before its substeps:
feedback, walking control, the energy sum and the period's clock."""


def substep_ops(n_env: int, n_substeps: int) -> int:
    """Operations of one ``fused_substeps`` call."""
    return n_env * n_substeps * SUBSTEP_OPS


def tick_ops(n_env: int, n_lowlevel: int, n_substeps: int) -> int:
    """Operations of one ``fused_tick`` call."""
    return n_env * n_lowlevel * (PERIOD_OPS + n_substeps * SUBSTEP_OPS)


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (tensors, dataclasses of tensors,
    sequences of either)."""
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif dataclasses.is_dataclass(obj):
            total += tensor_bytes(*(getattr(obj, f.name) for f in dataclasses.fields(obj)))
        elif isinstance(obj, (tuple, list)):
            total += tensor_bytes(*obj)
    return total

"""The lane split of the fused tick and substep kernels, in plain torch on
the CPU.

``csrc/substep_device.cuh`` and ``csrc/tick.cu`` give each env to two lanes
of a warp, one per leg. A lane holds its own leg's five joints and a copy
of the base state (``pos``, ``quat``, ``v_base``). The lanes exchange the
leg's root force (6), the leg's joint right-hand sides (5), three base rows
of Minv times the right-hand side (lane 0 the angular, lane 1 the linear),
in the feedback the leg's CoM sums (3 + 3) and in the tick the leg's
positive work (1); both lanes then repeat the same base arithmetic. This
file writes that form out with one Python object per lane. It reads the
same constant buffers as the kernels (``model_constants``,
``tick_constants``), applies the spatial inertias in the packed form the
kernels stage (rotational block, ``h = m c``, ``m``), and forms the sums in
the kernels' order: a cross-lane sum is ``own + other``, then the torso
term. It is held against the plain versions ``fused_substeps_reference`` (5
substeps) and ``fused_tick_reference`` (2 periods), and the two lanes' base
states must stay bit-equal after every substep: the kernels write lane 0's
copy only, so a drift would go unseen on the card.

Tolerances: f32 roundoff of another order of sums. Substeps: the kernel's
own bounds (``tests/test_substep_kernel.py:73-76``: pos 5e-7, quat 1e-6,
v_base 5e-6, q 1e-6, qd 1e-4; measured here pos 1.9e-9, quat 3.7e-9, v_base
4.5e-7, q 1.2e-7, qd 5.7e-6). Two periods: q, pos, quat 2e-6, qd 1e-3,
energy rtol 1e-4 / atol 1e-5 (measured q 8.6e-7, pos and quat 6.0e-8, qd
3.1e-5, energy 1.5e-6 relative), far inside the tick kernel's bounds of
5e-4 and 2e-2.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from biped_mpc_py_torch import GaitConfig
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import substep_kernel as sk
from biped_mpc_py_torch.ops.cuda import tick_kernel as tk
from biped_mpc_py_torch.sim import engine as teng
from tests.test_torch_cuda import _sweep_table_values, _tick_config
from tests.test_torch_sim import TM, _perturbed
from tests.test_torch_tick_kernel import _controls
from torch_threads import one_torch_thread  # noqa: F401

AXES = (2, 0, 1, 1, 1)  # joint axis of each level: hip yaw z, hip roll x, three pitch y
# offsets of the model buffer (csrc/substep_device.cuh)
OFF_JOINT, OFF_CONTACT, OFF_I6, OFF_SCALAR, OFF_LIMITS = 0, 30, 42, 438, 446
# offsets of the tick buffer (csrc/tick.cu)
T_MASS, T_COM, T_TIPZ, T_TOTAL, T_CTRL = 0, 11, 44, 45, 46


def cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def rot_pc(ax, c, s, v):
    if ax == 2:
        return [c * v[0] - s * v[1], s * v[0] + c * v[1], v[2]]
    if ax == 0:
        return [v[0], c * v[1] - s * v[2], s * v[1] + c * v[2]]
    return [c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]]


def rot_cp(ax, c, s, v):
    if ax == 2:
        return [c * v[0] + s * v[1], -s * v[0] + c * v[1], v[2]]
    if ax == 0:
        return [v[0], c * v[1] + s * v[2], -s * v[1] + c * v[2]]
    return [c * v[0] - s * v[2], v[1], s * v[0] + c * v[2]]


def motion_to_child(ax, c, s, off, m):
    t = cross3(off, m[0:3])
    d = [m[3] - t[0], m[4] - t[1], m[5] - t[2]]
    return rot_cp(ax, c, s, m[0:3]) + rot_cp(ax, c, s, d)


def force_to_parent(ax, c, s, off, f):
    fa, na = rot_pc(ax, c, s, f[3:6]), rot_pc(ax, c, s, f[0:3])
    t = cross3(off, fa)
    return [na[0] + t[0], na[1] + t[1], na[2] + t[2]] + fa


def crf(v, f):
    a, b = cross3(v[0:3], f[0:3]), cross3(v[3:6], f[3:6])
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]] + cross3(v[0:3], f[3:6])


def mv3(R, v):
    return [R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2] for i in range(3)]


def mtv3(R, v):
    return [R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2] for i in range(3)]


def quat_to_rotm(q):
    w, x, y, z = q
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def packed_body(C, b):
    """Body b's spatial inertia as the kernels stage it: the rotational
    block (3x3), h = m c read from the m cx block, and m."""
    I6 = C[OFF_I6 + 36 * b:OFF_I6 + 36 * (b + 1)].reshape(6, 6)
    return I6[:3, :3].tolist(), [float(I6[2, 4]), float(I6[0, 5]), float(I6[1, 3])], float(I6[5, 5])


def inertia_apply(body, v):
    """I6 v from the packed form: [I w + h x v ; m v + w x h]."""
    I, h, m = body
    w, vl = v[0:3], v[3:6]
    hv, wh = cross3(h, vl), cross3(w, h)
    return ([I[i][0] * w[0] + I[i][1] * w[1] + I[i][2] * w[2] + hv[i] for i in range(3)]
            + [m * vl[i] + wh[i] for i in range(3)])


def body_force(body, v, a):
    Iv, Ia = inertia_apply(body, v), inertia_apply(body, a)
    cf = crf(v, Iv)
    return [Ia[k] + cf[k] for k in range(6)]


def cols(t):
    return [t[:, i].clone() for i in range(t.shape[1])]


class Lane:
    """One lane's registers: its copy of the base state and its leg."""

    def __init__(self, leg, state, tau=None):
        self.leg = leg
        self.pos, self.quat, self.vb = cols(state.pos), cols(state.quat), cols(state.v_base)
        sl = slice(5 * leg, 5 * leg + 5)
        self.q, self.qd = cols(state.q[:, sl]), cols(state.qd[:, sl])
        self.tau = cols(tau[:, sl]) if tau is not None else None
        self.refresh()

    def refresh(self):
        self.cs, self.sn = [torch.cos(a) for a in self.q], [torch.sin(a) for a in self.q]

    def base(self):
        return torch.stack(self.pos + self.quat + self.vb, 1)


def leg_dynamics(C, lane):
    """The lane's own leg of one substep: forward pass, contact, backward
    pass, joint right-hand sides -> (root force (6), rhs (5))."""
    leg = lane.leg
    stiff, damp, mu, vslip2, jdamp, kls, kld, g = C[OFF_SCALAR:OFF_SCALAR + 8].tolist()
    R0 = quat_to_rotm(lane.quat)
    zero = torch.zeros_like(lane.pos[0])
    Rw, pw = [row[:] for row in R0], lane.pos[:]
    v, a = lane.vb[:], [zero, zero, zero, g * R0[2][0], g * R0[2][1], g * R0[2][2]]
    fs = []
    for l in range(5):
        j, ax = 5 * leg + l, AXES[l]
        c, s = lane.cs[l], lane.sn[l]
        off = C[OFF_JOINT + 3 * j:OFF_JOINT + 3 * j + 3].tolist()
        pw = [pw[i] + (Rw[i][0] * off[0] + Rw[i][1] * off[1] + Rw[i][2] * off[2])
              for i in range(3)]
        Rw = [rot_cp(ax, c, s, Rw[i]) for i in range(3)]
        v = motion_to_child(ax, c, s, off, v)
        v[ax] = v[ax] + lane.qd[l]
        a = motion_to_child(ax, c, s, off, a)
        vJ = [zero, zero, zero]
        vJ[ax] = lane.qd[l]
        t1, t2 = cross3(v[0:3], vJ), cross3(v[3:6], vJ)
        a = [a[0] + t1[0], a[1] + t1[1], a[2] + t1[2], a[3] + t2[0], a[4] + t2[1], a[5] + t2[2]]
        fs.append(body_force(packed_body(C, 1 + j), v, a))
    n_sum, f_sum = [zero] * 3, [zero] * 3
    for k in range(2):
        o = OFF_CONTACT + 3 * (2 * leg + k)
        rr = C[o:o + 3].tolist()
        wr = cross3(v[0:3], rr)
        vpb = [v[3] + wr[0], v[4] + wr[1], v[5] + wr[2]]
        pt = [pw[i] + (Rw[i][0] * rr[0] + Rw[i][1] * rr[1] + Rw[i][2] * rr[2]) for i in range(3)]
        vp = mv3(Rw, vpb)
        pen = torch.clamp(-pt[2], min=0.0)
        in_c = (pen > 0).to(pen.dtype)
        fn = torch.clamp(stiff * pen - damp * vp[2] * in_c, min=0.0) * in_c
        speed = torch.sqrt(vp[0] * vp[0] + vp[1] * vp[1] + vslip2)
        scale = -mu * fn / speed
        fb = mtv3(Rw, [scale * vp[0], scale * vp[1], fn])
        nb = cross3(rr, fb)
        n_sum = [n_sum[i] + nb[i] for i in range(3)]
        f_sum = [f_sum[i] + fb[i] for i in range(3)]
    fs[4] = [fs[4][i] - n_sum[i] for i in range(3)] + [fs[4][3 + i] - f_sum[i] for i in range(3)]
    f, bias = fs[4], [None] * 5
    for l in range(4, -1, -1):
        j, ax = 5 * leg + l, AXES[l]
        bias[l] = f[ax]
        off = C[OFF_JOINT + 3 * j:OFF_JOINT + 3 * j + 3].tolist()
        f = force_to_parent(ax, lane.cs[l], lane.sn[l], off, f)
        if l > 0:
            f = [f[k] + fs[l - 1][k] for k in range(6)]
    rhs = []
    for l in range(5):
        lo, hi = C[OFF_LIMITS + 2 * (5 * leg + l):OFF_LIMITS + 2 * (5 * leg + l) + 2].tolist()
        over = torch.clamp(lane.q[l] - hi, min=0.0)
        under = torch.clamp(lo - lane.q[l], min=0.0)
        viol = ((over > 0) | (under > 0)).to(over.dtype)
        tlim = -kls * (over - under) - kld * lane.qd[l] * viol
        rhs.append(((lane.tau[l] + tlim) - jdamp * lane.qd[l]) - bias[l])
    return f, rhs


def lane_rows(C, lane, own, other, Minv):
    """One lane's 8 rows of Minv times the right-hand side it forms from its
    own and the other lane's (root force, rhs) -> (3 base accelerations:
    angular on lane 0, linear on lane 1; its 5 joint accelerations)."""
    g = float(C[OFF_SCALAR + 7])
    R0 = quat_to_rotm(lane.quat)
    zero = torch.zeros_like(lane.pos[0])
    a_base = [zero, zero, zero, g * R0[2][0], g * R0[2][1], g * R0[2][2]]
    f_legs = [own[0][k] + other[0][k] for k in range(6)]  # own + other: the same on both lanes
    torso = body_force(packed_body(C, 0), lane.vb, a_base)
    rhs = [-(torso[k] + f_legs[k]) for k in range(6)]
    rhs += (own[1] + other[1]) if lane.leg == 0 else (other[1] + own[1])

    def row(i):
        acc = zero
        for k in range(16):
            acc = acc + Minv[:, i, k] * rhs[k]
        return acc

    return ([row(3 * lane.leg + i) for i in range(3)],
            [row(6 + 5 * lane.leg + l) for l in range(5)])


def lane_integrate(lane, mine, theirs, joints, dt):
    """The Euler step of one lane from its own and the other lane's base
    accelerations and its own joint accelerations."""
    base = (mine + theirs) if lane.leg == 0 else (theirs + mine)
    R0 = quat_to_rotm(lane.quat)
    lane.vb = [lane.vb[i] + base[i] * dt for i in range(6)]
    lane.qd = [lane.qd[l] + joints[l] * dt for l in range(5)]
    om = mv3(R0, lane.vb[0:3])
    vl = mv3(R0, lane.vb[3:6])
    lane.pos = [lane.pos[i] + vl[i] * dt for i in range(3)]
    hx, hy, hz = (0.5 * dt * o for o in om)
    th2 = hx * hx + hy * hy + hz * hz
    th = torch.sqrt(th2 + 1e-24)
    sinc = torch.where(th2 > 1e-12, torch.sin(th) / th, 1.0 - th2 / 6.0)
    aw, ax, ay, az = torch.cos(th), sinc * hx, sinc * hy, sinc * hz
    bw, bx, by, bz = lane.quat
    o = [aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
         aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw]
    nrm = torch.sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3])
    lane.quat = [c / nrm for c in o]
    lane.q = [lane.q[l] + lane.qd[l] * dt for l in range(5)]
    lane.refresh()


def lane_substep(C, lanes, Minv, dt):
    """One substep of both lanes, then the bit-equality of their bases."""
    sent = [leg_dynamics(C, lane) for lane in lanes]  # what each lane shuffles out
    rows = [lane_rows(C, lane, sent[lane.leg], sent[1 - lane.leg], Minv) for lane in lanes]
    for lane in lanes:
        lane_integrate(lane, rows[lane.leg][0], rows[1 - lane.leg][0], rows[lane.leg][1], dt)
    assert torch.equal(lanes[0].base(), lanes[1].base()), "the lanes' base states drifted"


def merged(lanes, t):
    """The state the kernel writes: lane 0's base, each lane's joints."""
    a, b = lanes
    return teng.ArtState(
        pos=torch.stack(a.pos, 1), quat=torch.stack(a.quat, 1), v_base=torch.stack(a.vb, 1),
        q=torch.stack(a.q + b.q, 1), qd=torch.stack(a.qd + b.qd, 1), t=t)


PRESETS = ["walk", "loaded", "compat"]
SUBSTEP_BOUNDS = {"pos": 5e-7, "quat": 1e-6, "v_base": 5e-6, "q": 1e-6, "qd": 1e-4}


@pytest.mark.parametrize("preset", PRESETS)
def test_lane_split_substeps(preset):
    """5 substeps of 1 ms on 64 perturbed in-contact envs (a seed per
    preset: the substep reads no config): the two-lane form against
    ``fused_substeps_reference``; base copies bit-equal after each."""
    n = 64
    _, state, tau = _perturbed(n, 21 + PRESETS.index(preset))
    tau = torch.tensor(tau)
    Minv = teng.mass_matrix_inv(TM, state.q)
    C = sk.model_constants(TM, "cpu")
    lanes = [Lane(leg, state, tau) for leg in (0, 1)]
    for _ in range(5):
        lane_substep(C, lanes, Minv, 0.001)
    got = merged(lanes, state.t + 0.005)
    want = sk.fused_substeps_reference(TM, state, tau, Minv, 0.005, 5)
    for name, tol in SUBSTEP_BOUNDS.items():
        err = float((getattr(got, name) - getattr(want, name)).abs().max())
        assert err < tol, (name, err)


def feedback_leg(C, T, lane):
    """The lane's own leg of the feedback: its bodies' CoM sums and its
    sole point -> (p_leg (3), v_leg (3), sole (3))."""
    leg = lane.leg
    R0 = quat_to_rotm(lane.quat)
    Rw, pw, v = [row[:] for row in R0], lane.pos[:], lane.vb[:]
    p_leg = v_leg = None
    for l in range(5):
        j, ax = 5 * leg + l, AXES[l]
        c, s = lane.cs[l], lane.sn[l]
        off = C[OFF_JOINT + 3 * j:OFF_JOINT + 3 * j + 3].tolist()
        ro = mv3(Rw, off)
        pw = [pw[i] + ro[i] for i in range(3)]
        Rw = [rot_cp(ax, c, s, Rw[i]) for i in range(3)]
        v = motion_to_child(ax, c, s, off, v)
        v[ax] = v[ax] + lane.qd[l]
        m = float(T[T_MASS + 1 + j])
        ci = T[T_COM + 3 * (1 + j):T_COM + 3 * (1 + j) + 3].tolist()
        wc = cross3(v[0:3], ci)
        rc, rv = mv3(Rw, ci), mv3(Rw, [v[3] + wc[0], v[4] + wc[1], v[5] + wc[2]])
        dp, dv = [m * (pw[i] + rc[i]) for i in range(3)], [m * rv[i] for i in range(3)]
        p_leg = dp if p_leg is None else [p_leg[i] + dp[i] for i in range(3)]
        v_leg = dv if v_leg is None else [v_leg[i] + dv[i] for i in range(3)]
    sole = [pw[i] + Rw[i][2] * float(T[T_TIPZ]) for i in range(3)]
    return p_leg, v_leg, sole


def feedback_x(T, lane, own, other):
    """x (12) and R0 on one lane from both lanes' CoM sums."""
    R0 = quat_to_rotm(lane.quat)
    m0, c0 = float(T[T_MASS]), T[T_COM:T_COM + 3].tolist()
    wc = cross3(lane.vb[0:3], c0)
    rc = mv3(R0, c0)
    rv = mv3(R0, [lane.vb[3] + wc[0], lane.vb[4] + wc[1], lane.vb[5] + wc[2]])
    total = float(T[T_TOTAL])
    p = [m0 * (lane.pos[i] + rc[i]) + (own[0][i] + other[0][i]) for i in range(3)]
    vv = [m0 * rv[i] + (own[1][i] + other[1][i]) for i in range(3)]
    w_w, v_t = mv3(R0, lane.vb[0:3]), mv3(R0, lane.vb[3:6])
    x = [torch.atan2(R0[2][1], R0[2][2]), -torch.asin(torch.clamp(R0[2][0], -1.0, 1.0)),
         torch.atan2(R0[1][0], R0[0][0]), p[0] / total, p[1] / total, lane.pos[2],
         w_w[0], w_w[1], w_w[2], vv[0] / total, vv[1] / total, v_t[2]]
    return R0, x


def leg_jacobian(K, lane, side):
    c0, s0, c1, s1 = lane.cs[0], lane.sn[0], lane.cs[1], lane.sn[1]
    th = [lane.q[2], lane.q[2] + lane.q[3], lane.q[2] + lane.q[3] + lane.q[4]]
    L = [K["l_thigh"], K["l_shank"], K["l_foot"]]
    lc = [L[0] * lane.cs[2], L[1] * torch.cos(th[1]), L[2] * torch.cos(th[2])]
    ls = [L[0] * lane.sn[2], L[1] * torch.sin(th[1]), L[2] * torch.sin(th[2])]
    u0, u2 = -(ls[0] + ls[1] + ls[2]), -(lc[0] + lc[1] + lc[2])
    u1 = K["abd_y"] * side + K["abd_y_const"]
    w0 = K["hip_x"] + u0
    w1 = K["hip_y"] * side + (c1 * u1 - s1 * u2)
    zero, one = torch.zeros_like(c0), torch.ones_like(c0)
    jf = [[-s0 * w0 - c0 * w1, c0 * w0 - s0 * w1, zero]]
    du1, du2 = -s1 * u1 - c1 * u2, c1 * u1 - s1 * u2
    jf.append([-s0 * du1, c0 * du1, du2])
    for k in range(3):
        ds, dz = sum(lc[k:3], zero), sum(ls[k:3], zero)
        y = -s1 * dz
        jf.append([c0 * -ds - s0 * y, s0 * -ds + c0 * y, c1 * dz])
    ax = [[zero, zero, one], [c0, s0, zero]] + [[-s0 * c1, c0 * c1, s1]] * 3
    return jf, ax


def clip(v, lo, hi):
    return torch.clamp(v, min=lo, max=hi)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def control_tau(T, flags, lane, R0, x, sole, u0, c0, t_ll, cmd_yaw, v_int, table=None):
    """The lane's five joint torques: the shared part (yaw, clock, Raibert
    target), which both lanes repeat, then its own leg. The control
    constants are the tick buffer's, or each env's row of ``table`` (the
    per-env variant's)."""
    if table is None:
        K = dict(zip(tk.CONTROL_NAMES, T[T_CTRL:].tolist()))
    else:
        K = dict(zip(tk.CONTROL_NAMES, table.T))
    leg, side = lane.leg, (1.0 if lane.leg == 0 else -1.0)
    body, compat_frame = bool(flags & tk.FLAG_CMD_BODY_FRAME), bool(flags & tk.FLAG_COMPAT_FRAME)
    yaw = x[2]
    dy_raw = (cmd_yaw if body else K["xc2"]) - yaw
    dyaw = torch.atan2(torch.sin(dy_raw), torch.cos(dy_raw))
    q_yaw_des = clip(dyaw - K["hipyaw_lead"] * (x[8] - K["xc8"]), -K["hipyaw_clip"],
                     K["hipyaw_clip"])
    flight = (1.0 - c0[0]) * (1.0 - c0[1])
    tau_fly = flight * clip(K["flight_yaw_kd"] * (x[8] - K["xc8"]), -K["tau_yaw_clip"],
                            K["tau_yaw_clip"])
    t_p = K["t_p"]
    u = t_ll - t_p * torch.floor(t_ll / t_p)
    frac = u / t_p
    s_ph = torch.sin(math.pi * u / t_p)
    if flags & tk.FLAG_SIN2:
        fz, dfz = K["H"] * s_ph * s_ph, K["H_rate"] * torch.sin(K["two_rate"] * u)
    else:
        fz, dfz = K["H"] * s_ph, K["H_rate"] * torch.cos(K["rate"] * u)
    r = clip((frac - 0.6) / 0.4, 0.0, 1.0)
    ramp = r * r
    cyw, syw = torch.cos(yaw), torch.sin(yaw)
    if body:
        vcx, vcy = cyw * K["xc9"] - syw * K["xc10"], syw * K["xc9"] + cyw * K["xc10"]
        kv_x = kv_y = 0.0
    else:
        vcx, vcy = K["xc9"], K["xc10"]
        kv_x, kv_y = K["kv"] * (x[3] - K["xc3"]), K["kv"] * (x[4] - K["xc4"])
    ex, ey = x[9] - vcx, x[10] - vcy
    gain = torch.clamp(K["capture_gain"] + K["capture_sched"] * torch.sqrt(ex * ex + ey * ey),
                       max=1.0)
    kc = gain * K["kc_base"]
    vx_m, vy_m = x[9] + K["am_y"] * x[7], x[10] - K["am_x"] * x[6]
    pp = K["pitch_place"] * (x[1] - K["pitch_nom"])
    fx = (x[3] + vx_m * K["ff"] + kc * (vx_m - vcx) + kv_x + pp) - K["vint"] * v_int[0]
    fy = (x[4] + vy_m * K["ff"] + kc * (vy_m - vcy) + kv_y) - K["vint"] * v_int[1]
    yaw_td = yaw + K["yaw_lead"]
    sin_td, cos_td = torch.sin(yaw_td), torch.cos(yaw_td)
    retract, damp, over = K["retract"] * ramp, K["td_damp"] * ramp, K["kp_over"] * ramp
    v_des = [K["tff"] * x[9], K["tff"] * x[10], K["tff"] * dfz]

    jf, ax = leg_jacobian(K, lane, side)
    jfqd = [sum((jf[j][i] * lane.qd[j] for j in range(5)), torch.zeros_like(yaw))
            for i in range(3)]
    vf_w = mtv3(R0, jfqd) if compat_frame else mv3(R0, jfqd)
    if flags & tk.FLAG_COMPAT_YAW:
        tx, ty = fx, fy + 0.04 * side
    else:
        tx, ty = fx - sin_td * K["y_offset"] * side, fy + cos_td * K["y_offset"] * side
    foot_des = [tx - retract * cyw, ty - retract * syw, fz]
    f_sw = [K["kp"] * (foot_des[i] - sole[i]) + K["kd"] * (v_des[i] - vf_w[i]) for i in range(3)]
    f_sw = [f_sw[0] - damp * vf_w[0], f_sw[1] - damp * vf_w[1], f_sw[2] - over]
    if not compat_frame:
        f_sw = mtv3(R0, f_sw)
    u_f = [-c for c in mtv3(R0, u0[3 * leg:3 * leg + 3])]
    u_m = [-c for c in mtv3(R0, u0[6 + 3 * leg:9 + 3 * leg])]
    tau_pivot = -K["kp_pivot"] * clip(dyaw, -0.3, 0.3) - K["kd_pivot"] * (lane.qd[0] + K["xc8"])
    m_yaw = K["kp_hipyaw"] * (q_yaw_des - lane.q[0]) - K["kd_hipyaw"] * lane.qd[0]
    vec_z = [R0[2][i] * m_yaw for i in range(3)]
    c = c0[leg]
    tau = []
    for j in range(5):
        t_st = dot3(jf[j], u_f) + dot3(ax[j], u_m)
        t_sw = dot3(jf[j], f_sw)
        if j == 0:
            t_st, t_sw = t_st + tau_pivot, t_sw + tau_fly
        t_yaw = clip(dot3(ax[j], vec_z), -K["tau_yaw_clip"], K["tau_yaw_clip"])
        tau.append(t_st * c + (t_sw + t_yaw) * (1.0 - c))
    return tau


def lane_period(C, T, flags, lanes, args, t_ll, Minv, ll_dt, n_substeps, table=None):
    """One low-level period of both lanes -> the period's energy."""
    u0, c0, _, cmd_yaw, v_int = args
    sent = [feedback_leg(C, T, lane) for lane in lanes]  # CoM sums shuffled out
    work = []
    for lane in lanes:
        R0, x = feedback_x(T, lane, sent[lane.leg], sent[1 - lane.leg])
        lane.tau = control_tau(T, flags, lane, R0, x, sent[lane.leg][2], cols(u0), cols(c0),
                               t_ll, cmd_yaw, cols(v_int), table)
        work.append(sum((torch.clamp(lane.tau[j] * lane.qd[j], min=0.0) for j in range(1, 5)),
                        torch.clamp(lane.tau[0] * lane.qd[0], min=0.0)))
    energy = (work[0] + work[1]) * np.float32(ll_dt)  # own + other on either lane
    for _ in range(n_substeps):
        lane_substep(C, lanes, Minv, ll_dt / n_substeps)
    return energy


@pytest.mark.parametrize("preset", PRESETS)
def test_lane_split_periods(preset):
    """2 low-level periods of 5 substeps on 64 perturbed envs with random
    clocks, flags and controls: the two-lane form against
    ``fused_tick_reference``; base copies bit-equal after every substep."""
    n, n_ll, n_sub = 64, 2, 5
    mpc, gait = _tick_config(preset), GaitConfig(steps_per_phase=5)
    _, state, _ = _perturbed(n, 13)
    args = tuple(map(torch.tensor, _controls(n, 14)))
    state = dataclasses.replace(state, t=args[2].clone())
    Minv = teng.mass_matrix_inv(TM, state.q)
    C = sk.model_constants(TM, "cpu")
    T = tk.tick_constants(TM, BipedParams(), mpc, gait, "cpu")
    ll_dt = mpc.dt / n_ll
    lanes = [Lane(leg, state) for leg in (0, 1)]
    energy = torch.zeros(n)
    for p in range(n_ll):
        t_ll = args[2] + np.float32(p * ll_dt)
        energy = energy + lane_period(C, T, tk._flags(mpc), lanes, args, t_ll, Minv, ll_dt, n_sub)
    got = merged(lanes, state.t + mpc.dt)
    want, e_want = tk.fused_tick_reference(TM, BipedParams(), mpc, gait, state, *args, Minv,
                                           n_lowlevel=n_ll, n_substeps=n_sub)
    for name, tol in {"q": 2e-6, "pos": 2e-6, "quat": 2e-6, "qd": 1e-3}.items():
        err = float((getattr(got, name) - getattr(want, name)).abs().max())
        assert err < tol, (name, err)
    np.testing.assert_allclose(energy.numpy(), e_want.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(got.t, want.t)


@pytest.mark.parametrize("preset", PRESETS)
def test_lane_split_periods_table(preset):
    """The per-env variant's two-lane form, each env's control constants
    from its row of ``tick_table``: against ``fused_tick_reference`` with
    the same per-env values (the plain per-env periods), within the same
    bounds as the shared form; base copies bit-equal after every substep."""
    n, n_ll, n_sub = 64, 2, 5
    mpc, gait = _tick_config(preset), GaitConfig(steps_per_phase=5)
    _, state, _ = _perturbed(n, 15)
    args = tuple(map(torch.tensor, _controls(n, 16)))
    state = dataclasses.replace(state, t=args[2].clone())
    Minv = teng.mass_matrix_inv(TM, state.q)
    C = sk.model_constants(TM, "cpu")
    T = tk.tick_constants(TM, BipedParams(), mpc, gait, "cpu")
    x_cmd, per_env = _sweep_table_values(n, mpc, "cpu")
    table = tk.tick_table(BipedParams().expand(n), mpc, gait, x_cmd, per_env)
    ll_dt = mpc.dt / n_ll
    lanes = [Lane(leg, state) for leg in (0, 1)]
    energy = torch.zeros(n)
    for p in range(n_ll):
        t_ll = args[2] + np.float32(p * ll_dt)
        energy = energy + lane_period(C, T, tk._flags(mpc), lanes, args, t_ll, Minv, ll_dt,
                                      n_sub, table)
    got = merged(lanes, state.t + mpc.dt)
    want, e_want = tk.fused_tick_reference(TM, BipedParams(), mpc, gait, state, *args, Minv,
                                           n_lowlevel=n_ll, n_substeps=n_sub, x_cmd=x_cmd,
                                           per_env=per_env, bipeds=BipedParams().expand(n))
    for name, tol in {"q": 2e-6, "pos": 2e-6, "quat": 2e-6, "qd": 1e-3}.items():
        err = float((getattr(got, name) - getattr(want, name)).abs().max())
        assert err < tol, (name, err)
    np.testing.assert_allclose(energy.numpy(), e_want.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(got.t, want.t)
    # the configs were felt: env i and env i + 1 run apart from the same state
    shared, _ = tk.fused_tick_reference(TM, BipedParams(), mpc, gait, state, *args, Minv,
                                        n_lowlevel=n_ll, n_substeps=n_sub)
    assert float((want.q - shared.q)[1:4].abs().max()) > 1e-4


def test_packed_inertia_matches_dense():
    """The packed form the kernels stage (rotational block, h, m) gives the
    dense 6x6 product for every body of the model."""
    C = sk.model_constants(TM, "cpu")
    v = torch.tensor(np.random.default_rng(3).normal(size=(8, 6)), dtype=torch.float32)
    for b in range(11):
        I6 = C[OFF_I6 + 36 * b:OFF_I6 + 36 * (b + 1)].reshape(6, 6)
        got = torch.stack(inertia_apply(packed_body(C, b), cols(v)), 1)
        torch.testing.assert_close(got, v @ I6.T, rtol=1e-5, atol=1e-6)

"""MuJoCo co-simulation driver: the counterpart of
``biped_mpc_py_tpu/sim/mj_driver.py``.

The same 25 Hz MPC + 200 Hz low-level controller that drives the
articulated engine drives MuJoCo CPU on the exported MJCF
(``sim/mjcf.py``), one robot, and the contact forces and falls are
compared: the strongest physics oracle of the articulated stack. MuJoCo
steps on the host; the controller runs at N = 1 on ``device`` (the card
unless named), so each state read is one host-to-device copy and each
torque apply one copy back. This loop validates; the batched path
(``parallel/rollout_art.py``) is the one for throughput.
"""

from __future__ import annotations

import numpy as np
import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.control.controller import (
    ControllerState,
    advance_cmd_ref,
    advance_pitch_ref,
    advance_v_int,
)
from biped_mpc_py_torch.control.gait import advance_gait_clock_host, contact_sequence
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.control.mpc import solve_mpc
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.rotations import quat_to_rotm
from biped_mpc_py_torch.sim.engine import ArtState, feedback_and_soles
from biped_mpc_py_torch.sim.mjcf import penalty_matched_solref, set_hfield_data, to_mjcf
from biped_mpc_py_torch.sim.model import ArticulatedModel, hector_model
from biped_mpc_py_torch.sim.spatial import _mtv
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device, host_to_device
from biped_mpc_py_torch.utils.precision import f32_precision

MJ_DT = 5e-4
N_LL = 8  # low-level updates per MPC tick (200 Hz)
MJ_PER_LL = 10  # MuJoCo steps per low-level update (2 kHz)


def state_from_mj(d, t: float, device=DEFAULT_DEVICE) -> ArtState:
    """MuJoCo qpos/qvel (free-joint linear velocity in the world frame,
    angular in the body frame) -> an ArtState of one env (N = 1) on
    ``device`` (``mj_driver.py:52``), in one host-to-device copy."""
    device = entry_device(device)
    v = host_to_device(np.concatenate([d.qpos[0:17], d.qvel[0:16], [t]]), device)[None]
    quat = v[:, 3:7]
    v_lin_body = _mtv(quat_to_rotm(quat), v[:, 17:20])
    return ArtState(
        pos=v[:, 0:3], quat=quat, v_base=torch.cat([v[:, 20:23], v_lin_body], -1),
        q=v[:, 7:17], qd=v[:, 23:33], t=v[:, 33],
    )


def mj_foot_forces(m, d) -> np.ndarray:
    """Per-foot normal force (2,) summed over the active floor contacts
    (``mj_driver.py:70``); foot-foot contacts are left out."""
    import mujoco

    f = np.zeros(2)
    buf = np.zeros(6)
    floor_id = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "floor")
    for i in range(d.ncon):
        con = d.contact[i]
        if con.geom1 != floor_id and con.geom2 != floor_id:
            continue
        mujoco.mj_contactForce(m, d, i, buf)  # buf[0] = normal force
        g = con.geom2 if con.geom1 == floor_id else con.geom1
        name = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g)
        if name and name.startswith("l_foot"):
            f[0] += buf[0]
        elif name and name.startswith("r_foot"):
            f[1] += buf[0]
    return f


def _latest(schedule, k):
    """The entry of the latest start <= k of a sorted schedule, or None."""
    now = None
    for start, value in schedule:
        if k >= start:
            now = value
    return now


@f32_precision
@torch.no_grad()
def run_mujoco_closed_loop(
    mpc: MpcConfig,
    gait: GaitConfig,
    n_ticks: int,
    model: ArticulatedModel | None = None,
    biped: BipedParams | None = None,
    dq0: np.ndarray | None = None,
    fall_z: float = 0.25,
    shove: tuple | None = None,
    terrain=None,
    gait_schedule: list | None = None,
    cmd_schedule: list | None = None,
    device=DEFAULT_DEVICE,
):
    """Closed loop of one robot in MuJoCo under the port's controller
    (``mj_driver.py:93``).

    dq0: optional (10,) initial joint-angle perturbation.
    shove: optional ``(tick, dvx, dvy)``: a world-frame base-velocity
      impulse [m/s] at the start of that MPC tick.
    terrain: optional :class:`~biped_mpc_py_torch.sim.contact.Terrain` with
      one (H, W) field: the MuJoCo floor becomes the same height field that
      the controller's references read.
    gait_schedule: optional ``[(start_tick, GaitConfig), ...]`` switches of
      ``gait_mode`` (the latest start <= tick wins); the contact schedule
      follows it, the references keep ``gait``'s cadence, and
      ``steps_per_phase`` must not change (``ValueError``).
    cmd_schedule: optional ``[(start_tick, x_cmd (12,)), ...]`` command
      switches: the command rides the controller as an ``x_cmd`` tensor.
    device: where the controller runs (the card unless named; raises
      without one).

    With ``gait.contact_clock`` the gait clock advances on the host from
    MuJoCo's normal forces (> 5 N per foot) by the rule of
    ``advance_gait_clock``.

    Returns (per-tick per-foot forces (n, 2), per-tick feedback states
    (n, 12), fell), numpy arrays and a bool.
    """
    device = entry_device(device)
    import mujoco

    model = model or hector_model(device=device)
    biped = (biped or BipedParams()).to(device)
    if terrain is not None and terrain.batched:
        raise ValueError("the MuJoCo floor is one height field: terrain.heights must be (H, W)")
    # on height fields the sphere radius must exceed the penalty-matched
    # contact law's max penetration (sim/mjcf.py::to_mjcf)
    sphere_r = 0.02 if terrain is not None else 0.005
    m = mujoco.MjModel.from_xml_string(
        to_mjcf(model, MJ_DT, contact=True, solref=penalty_matched_solref(model),
                terrain=terrain, sphere_r=sphere_r)
    )
    if terrain is not None:
        set_hfield_data(m, terrain)
    d = mujoco.MjData(m)
    s0 = ArtState.standing()
    d.qpos[0:3] = s0.pos[0].numpy()
    d.qpos[3:7] = s0.quat[0].numpy()
    d.qpos[7:17] = s0.q[0].numpy()
    if dq0 is not None:
        d.qpos[7:17] += np.asarray(dq0)

    if gait_schedule:
        if any(g.steps_per_phase != gait.steps_per_phase for _, g in gait_schedule):
            raise ValueError("gait_schedule can only switch gait_mode")
        gait_schedule = sorted(gait_schedule, key=lambda e: e[0])
    if cmd_schedule:
        cmd_schedule = sorted(cmd_schedule, key=lambda e: e[0])
    ctrl = ControllerState.init(mpc, device=device)
    forces, xs = [], []
    t = 0.0
    xc_now, x_cmd = None, None  # the config's command until a schedule entry applies
    t_gait, hold = -mpc.dt, 0
    gait_now = gait
    fell = False
    for k in range(n_ticks):
        if gait_schedule:
            gait_now = _latest(gait_schedule, k) or gait_now
        if cmd_schedule:
            xc = _latest(cmd_schedule, k)
            if xc is not None and xc is not xc_now:
                xc_now, x_cmd = xc, host_to_device(xc, device)
        if shove is not None and k == shove[0]:
            d.qvel[0] += shove[1]
            d.qvel[1] += shove[2]
        if gait_now.contact_clock:
            # contact from MuJoCo's normal forces, the hold rule of the
            # engine's clock (control/gait.py::advance_gait_clock)
            t_gait, hold = advance_gait_clock_host(
                t_gait, hold, mj_foot_forces(m, d) > 5.0, mpc, gait_now
            )
            t_used = t_gait
        else:
            t_used = t
        # one read per tick; its clock is the gait time (feedback_and_soles
        # does not read it)
        s = state_from_mj(d, t_used, device)
        x_fb, pf_w = feedback_and_soles(model, s)
        contact = contact_sequence(s.t, mpc, gait_now)
        foot_yaw = x_fb[:, 2:3] + s.q[:, [0, 5]] if mpc.foot_frame_wrench else None
        sol = solve_mpc(
            x_fb, s.t, pf_w, mpc, biped, contact, warm=ctrl.qp, gait=gait,
            cmd_ref=ctrl.cmd_ref, foot_yaw=foot_yaw, terrain=terrain, v_int=ctrl.v_int,
            pitch_ref=ctrl.pitch_ref, x_cmd=x_cmd,
        )
        # the low-level control uses the pre-advance anchor, as the engine
        # tick does; the anchor advances for the next tick
        cmd_ref_now, v_int_now = ctrl.cmd_ref, ctrl.v_int
        ctrl = ControllerState(
            qp=sol, cmd_ref=advance_cmd_ref(ctrl.cmd_ref, x_fb, mpc, x_cmd),
            v_int=advance_v_int(ctrl.v_int, x_fb, mpc, x_cmd),
            pitch_ref=advance_pitch_ref(ctrl.pitch_ref, x_fb, mpc),
        )
        u0 = sol.controls[:, 0]
        f_acc = np.zeros(2)
        for _ in range(N_LL):
            s = state_from_mj(d, t_used, device)
            x_j, pf_j = feedback_and_soles(model, s)
            tau = low_level_control(
                x_j, s.t, pf_j, s.q, s.qd, mpc, biped, contact, u0, gait=gait,
                cmd_ref=cmd_ref_now, terrain=terrain, v_int=v_int_now, x_cmd=x_cmd,
            )
            d.qfrc_applied[6:16] = tau[0].cpu().numpy()
            for _ in range(MJ_PER_LL):
                mujoco.mj_step(m, d)
            f_acc += mj_foot_forces(m, d)
        forces.append(f_acc / N_LL)
        xs.append(x_fb[0])
        t += mpc.dt
        if d.qpos[2] < fall_z:
            fell = True
            break
    return np.array(forces), torch.stack(xs).cpu().numpy(), fell

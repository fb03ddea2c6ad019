"""MuJoCo co-simulation driver: the counterpart of
``biped_mpc_py_tpu/sim/mj_driver.py``.

The same 25 Hz MPC + 200 Hz low-level controller that drives the
articulated engine drives MuJoCo CPU on the exported MJCF
(``sim/mjcf.py``), one robot, and the contact forces and falls are
compared: the strongest physics oracle of the articulated stack. MuJoCo
steps on the host; the controller runs at N = 1 on ``device`` (the card
unless named). :class:`MjController` holds its three calls, the
counterparts of the JAX loop's jitted ``fb``, ``solve`` and ``lowlvl``: each
a CUDA graph over one set of buffers, replayed on the card (on the CPU the
same buffers step eagerly). Each state read is one host-to-device copy
through a pinned buffer, and each torque apply one copy back through
another. This loop validates; the batched path (``parallel/rollout_art.py``)
is the one for throughput.
"""

from __future__ import annotations

import dataclasses

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
from biped_mpc_py_torch.ops.qp import QpSolution
from biped_mpc_py_torch.ops.rotations import quat_to_rotm
from biped_mpc_py_torch.sim.engine import ArtState, feedback_and_soles
from biped_mpc_py_torch.sim.mjcf import penalty_matched_solref, set_hfield_data, to_mjcf
from biped_mpc_py_torch.sim.model import ArticulatedModel, hector_model
from biped_mpc_py_torch.sim.spatial import _mtv
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device, host_to_device
from biped_mpc_py_torch.utils.graphs import TickGraph
from biped_mpc_py_torch.utils.precision import f32_precision
from biped_mpc_py_torch.utils.struct import TensorStruct

MJ_DT = 5e-4
N_LL = 8  # low-level updates per MPC tick (200 Hz)
MJ_PER_LL = 10  # MuJoCo steps per low-level update (2 kHz)


N_READ = 34  # qpos (17), qvel (16), the clock


def _state_from_read(v: torch.Tensor) -> ArtState:
    """An ArtState of the (N, 34) reads [qpos, qvel, t]."""
    quat = v[:, 3:7]
    v_lin_body = _mtv(quat_to_rotm(quat), v[:, 17:20])
    return ArtState(
        pos=v[:, 0:3], quat=quat, v_base=torch.cat([v[:, 20:23], v_lin_body], -1),
        q=v[:, 7:17], qd=v[:, 23:33], t=v[:, 33],
    )


def state_from_mj(d, t: float, device=DEFAULT_DEVICE) -> ArtState:
    """MuJoCo qpos/qvel (free-joint linear velocity in the world frame,
    angular in the body frame) -> an ArtState of one env (N = 1) on
    ``device`` (``mj_driver.py:52``), in one host-to-device copy."""
    device = entry_device(device)
    v = host_to_device(np.concatenate([d.qpos[0:17], d.qvel[0:16], [t]]), device)[None]
    return _state_from_read(v)


@dataclasses.dataclass(frozen=True)
class _MjState(TensorStruct):
    """The controller's buffers at N = 1, shared by its three graphs."""

    read: torch.Tensor  # (1,34) the last read: qpos, qvel, the gait clock
    x: torch.Tensor  # (1,12) the feedback state of the last read
    pf: torch.Tensor  # (1,6) its world sole positions
    x_cmd: torch.Tensor  # (12,) the command in force
    qp: QpSolution  # the warm start
    cmd_ref: torch.Tensor  # (1,3)
    v_int: torch.Tensor  # (1,2)
    pitch_ref: torch.Tensor  # (1,)
    contact: torch.Tensor  # (1,h,2) the tick's schedule
    u0: torch.Tensor  # (1,12) the tick's first control
    cmd_ref_ll: torch.Tensor  # (1,3) cmd_ref before the tick's advance (the low level's)
    v_int_ll: torch.Tensor  # (1,2) v_int before the tick's advance
    tau: torch.Tensor  # (1,10) the last period's torques


class MjController:
    """The controller of :func:`run_mujoco_closed_loop` at N = 1 on
    ``device`` (the card unless named; raises without one), against any
    plant that gives MuJoCo's ``qpos`` (17,) and ``qvel`` (16,) and takes
    joint torques.

    Three :class:`~biped_mpc_py_torch.utils.graphs.TickGraph` over one set
    of buffers, the counterparts of the JAX loop's jitted calls
    (``mj_driver.py:150-170``): ``feedback_and_soles`` of a read; the solve
    (``solve_mpc``, then the advance of ``cmd_ref``, ``v_int`` and
    ``pitch_ref``), with the command ``x_cmd`` an input, so that a
    schedule swaps commands without a new capture; and ``low_level_control``
    on the pre-advance anchors. On the card each is captured at the first
    read and replayed; on the CPU the same buffers step eagerly. The
    contact schedule is computed between the feedback and the solve, outside
    the graphs, from the gait in force (``gait_now``; the graphs keep
    ``gait``, as the JAX jits do). A read fills one pinned 34-float host
    buffer and copies it in; the torques come back through one pinned
    10-float buffer and one synchronization per period."""

    def __init__(self, mpc: MpcConfig, gait: GaitConfig,
                 model: ArticulatedModel | None = None,
                 biped: BipedParams | None = None, terrain=None, device=DEFAULT_DEVICE):
        self.device = entry_device(device)
        self.mpc, self.gait, self.terrain = mpc, gait, terrain
        self.model = model or hector_model(device=self.device)
        self.biped = (biped or BipedParams()).to(self.device)
        ctrl = ControllerState.init(mpc, device=self.device)

        def zeros(*shape):
            return torch.zeros((1,) + shape, device=self.device)

        self.state = _MjState(
            read=zeros(N_READ), x=zeros(12), pf=zeros(6),
            x_cmd=host_to_device(mpc.x_cmd, self.device), qp=ctrl.qp,
            cmd_ref=ctrl.cmd_ref, v_int=ctrl.v_int, pitch_ref=ctrl.pitch_ref,
            contact=zeros(mpc.h, 2), u0=zeros(12), cmd_ref_ll=zeros(3), v_int_ll=zeros(2),
            tau=zeros(10),
        )
        pinned = self.device.type == "cuda"
        self._read_host = torch.zeros(N_READ, pin_memory=pinned)
        self._tau_host = torch.zeros(10, pin_memory=pinned)
        self._read_done = torch.cuda.Event() if pinned else None
        self.graphs = None

    def _feedback_step(self, s: _MjState) -> _MjState:
        x, pf = feedback_and_soles(self.model, _state_from_read(s.read))
        return dataclasses.replace(s, x=x, pf=pf)

    def _solve_step(self, s: _MjState) -> _MjState:
        mpc = self.mpc
        q, t = s.read[:, 7:17], s.read[:, 33]
        foot_yaw = s.x[:, 2:3] + q[:, 0:6:5] if mpc.foot_frame_wrench else None
        sol = solve_mpc(
            s.x, t, s.pf, mpc, self.biped, s.contact, warm=s.qp, gait=self.gait,
            cmd_ref=s.cmd_ref, foot_yaw=foot_yaw, terrain=self.terrain, v_int=s.v_int,
            pitch_ref=s.pitch_ref, x_cmd=s.x_cmd,
        )
        return dataclasses.replace(
            s, qp=sol, cmd_ref=advance_cmd_ref(s.cmd_ref, s.x, mpc, s.x_cmd),
            v_int=advance_v_int(s.v_int, s.x, mpc, s.x_cmd),
            pitch_ref=advance_pitch_ref(s.pitch_ref, s.x, mpc), u0=sol.controls[:, 0],
            cmd_ref_ll=s.cmd_ref, v_int_ll=s.v_int,
        )

    def _lowlevel_step(self, s: _MjState) -> _MjState:
        r = s.read
        tau = low_level_control(
            s.x, r[:, 33], s.pf, r[:, 7:17], r[:, 23:33], self.mpc, self.biped, s.contact,
            s.u0, gait=self.gait, cmd_ref=s.cmd_ref_ll, terrain=self.terrain,
            v_int=s.v_int_ll, x_cmd=s.x_cmd,
        )
        return dataclasses.replace(s, tau=tau)

    def set_command(self, x_cmd) -> None:
        """Make the (12,) host command ``x_cmd`` the one in force."""
        self.state.x_cmd.copy_(host_to_device(x_cmd, self.device))

    def _read(self, qpos, qvel, t: float) -> None:
        """One read into the graphs' input, in one copy through the pinned
        buffer (the previous copy from it has ended), then the feedback."""
        if self._read_done is not None:
            self._read_done.synchronize()
        host = self._read_host.numpy()
        host[0:17], host[17:33], host[33] = qpos[0:17], qvel[0:16], t
        self.state.read.copy_(self._read_host[None], non_blocking=True)
        if self._read_done is not None:
            self._read_done.record()
        if self.graphs is None:
            self.graphs = tuple(TickGraph(step, self.state) for step in (
                self._feedback_step, self._solve_step, self._lowlevel_step))
        self.graphs[0].replay()

    def _torques(self) -> np.ndarray:
        self._tau_host.copy_(self.state.tau[0], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._tau_host.numpy().copy()

    @f32_precision
    @torch.no_grad()
    def warmup(self, read) -> None:
        """Capture the three graphs off the clock, after one read of
        ``read() -> (qpos, qvel)`` (the first launch on the card loads the
        kernels); the controller's state is left as it was."""
        self._read(*read(), 0.0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @f32_precision
    @torch.no_grad()
    def tick(self, read, apply, t: float, gait_now: GaitConfig | None = None) -> torch.Tensor:
        """One MPC tick: ``read() -> (qpos, qvel)`` of the plant, the
        feedback, the contact schedule of ``gait_now`` (default the
        controller's gait) at the gait time ``t``, the solve; then
        ``N_LL`` periods of a read, the feedback, the low-level
        control and ``apply(tau)`` of the (10,) host torques. Returns the
        tick's feedback state (1, 12), a copy on the device."""
        self._read(*read(), t)
        x_fb = self.state.x.clone()
        contact = contact_sequence(self.state.read[:, 33], self.mpc, gait_now or self.gait)
        self.state.contact.copy_(contact)
        self.graphs[1].replay()
        for _ in range(N_LL):
            self._read(*read(), t)
            self.graphs[2].replay()
            apply(self._torques())
        return x_fb


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
    ctl = MjController(mpc, gait, model, biped, terrain, device)
    forces, xs = [], []
    t = 0.0
    xc_now = None  # the config's command until a schedule entry applies
    t_gait, hold = -mpc.dt, 0
    gait_now = gait
    fell = False
    f_acc = np.zeros(2)

    def read():
        return d.qpos, d.qvel

    def apply(tau):
        nonlocal f_acc
        d.qfrc_applied[6:16] = tau
        for _ in range(MJ_PER_LL):
            mujoco.mj_step(m, d)
        f_acc = f_acc + mj_foot_forces(m, d)

    for k in range(n_ticks):
        if gait_schedule:
            gait_now = _latest(gait_schedule, k) or gait_now
        if cmd_schedule:
            xc = _latest(cmd_schedule, k)
            if xc is not None and xc is not xc_now:
                xc_now = xc
                ctl.set_command(xc)
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
        # every read's clock is the tick's gait time (feedback_and_soles
        # does not read it); the low level uses the pre-advance anchors
        f_acc = np.zeros(2)
        xs.append(ctl.tick(read, apply, t_used, gait_now)[0])
        forces.append(f_acc / N_LL)
        t += mpc.dt
        if d.qpos[2] < fall_z:
            fell = True
            break
    return np.array(forces), torch.stack(xs).cpu().numpy(), fell

"""Wall-clock real-time controller loop: the counterpart of
``biped_mpc_py_tpu/runtime/realtime.py``.

The deployment-shaped runtime: a deadline-scheduled 25 Hz loop that drives
one robot (a real robot's transport or any simulator) through a minimal
read-state / apply-torque interface, warm-started across ticks and
instrumented (per-tick latency percentiles, deadline misses).

- The plant interface is synchronous and on the host. The controller runs
  at N = 1 on the loop's device (the card unless named), as two CUDA graphs
  replayed there (the solve, one low-level period), the counterparts of
  the JAX loop's jitted calls: each read of the plant is one host-to-device
  copy of its 39 floats (state, feet, joints and the clock) through a
  pinned buffer allocated once, and each apply one copy of the 10 torques
  back through another.
- Low-level control runs ``n_lowlevel`` times per MPC tick (25 Hz MPC,
  200 Hz low-level), re-reading the plant each time; the MPC solve is
  shared by them.
- Scheduling: absolute deadlines from ``time.monotonic`` (no drift); a
  missed deadline is counted and the schedule re-anchored, so one slow
  tick cannot cascade.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Protocol

import numpy as np
import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.control.controller import (
    ControllerState,
    advance_cmd_ref,
    advance_v_int,
)
from biped_mpc_py_torch.control.gait import advance_gait_clock_host, contact_sequence
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.control.mpc import solve_mpc
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.qp import QpSolution
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.graphs import TickGraph
from biped_mpc_py_torch.utils.precision import f32_precision
from biped_mpc_py_torch.utils.struct import TensorStruct


class Plant(Protocol):
    """The robot or simulator the loop drives."""

    def read_state(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (x_fb (12,), q (10,), qd (10,)) in the package's conventions
        (state: [roll, pitch, yaw, p, omega_world, v_world])."""
        ...

    def foot_positions(self) -> np.ndarray:
        """-> world sole positions (6,) [left, right]."""
        ...

    def apply(self, tau: np.ndarray, dt: float) -> None:
        """Apply joint torques (10,) for dt seconds (zero-order hold)."""
        ...


@dataclasses.dataclass
class LoopStats:
    """Wall-clock instrumentation of one run."""

    n_ticks: int
    deadline_misses: int
    latency_p50_ms: float
    latency_p99_ms: float
    latency_max_ms: float

    def realtime_ok(self, budget_s: float, miss_budget: float = 0.01) -> bool:
        return (
            self.deadline_misses <= self.n_ticks * miss_budget
            and self.latency_p99_ms * 1e-3 <= budget_s
        )


@dataclasses.dataclass(frozen=True)
class _LoopState(TensorStruct):
    """The controller's buffers at N = 1, shared by the solve and the
    low-level graphs."""

    read: torch.Tensor  # (1,39) the plant's last read: x_fb, pf, q, qd, t
    qp: QpSolution  # the warm start
    cmd_ref: torch.Tensor  # (1,3)
    v_int: torch.Tensor  # (1,2)
    contact: torch.Tensor  # (1,h,2) the tick's schedule
    u0: torch.Tensor  # (1,12) the tick's first control
    v_int_ll: torch.Tensor  # (1,2) v_int before the tick's advance (the low level's)
    tau: torch.Tensor  # (1,10) the last period's torques


class RealtimeLoop:
    """Deadline-scheduled MPC + low-level loop against a :class:`Plant`
    (``realtime.py:83``), on ``device`` (the card unless named; raises
    without one).

    The counterparts of the JAX loop's jitted calls are two
    :class:`~biped_mpc_py_torch.utils.graphs.TickGraph` over one set of
    buffers: the solve (``contact_sequence``, ``solve_mpc``,
    ``advance_cmd_ref``, ``advance_v_int``) and one low-level period
    (``low_level_control``). On the card each is captured once as a CUDA
    graph (by :meth:`warmup`, or at the first tick) and replayed; on the
    CPU the same buffers step eagerly. A read fills one pinned 39-float
    host buffer and copies it into the graphs' input; the torques come
    back through one pinned 10-float buffer and one synchronization per
    period."""

    def __init__(self, mpc: MpcConfig, gait: GaitConfig, biped: BipedParams,
                 n_lowlevel: int = 8, device=DEFAULT_DEVICE):
        self.mpc = mpc
        self.gait = gait
        self.n_lowlevel = n_lowlevel
        self.device = entry_device(device)
        self.biped = biped.to(self.device)
        # contact-sensed gait clock (GaitConfig.contact_clock), advanced on
        # the host from the plant's sole heights (the first step is 0)
        self._t_gait = -float(mpc.dt)
        self._hold = 0
        ctrl = ControllerState.init(mpc, device=self.device)

        def zeros(*shape):
            return torch.zeros((1,) + shape, device=self.device)

        self.state = _LoopState(
            read=zeros(39), qp=ctrl.qp, cmd_ref=ctrl.cmd_ref, v_int=ctrl.v_int,
            contact=zeros(mpc.h, 2), u0=zeros(12), v_int_ll=zeros(2), tau=zeros(10),
        )
        pinned = self.device.type == "cuda"
        self._read_host = torch.zeros(39, pin_memory=pinned)
        self._tau_host = torch.zeros(10, pin_memory=pinned)
        self._read_done = torch.cuda.Event() if pinned else None
        self._graphs = None

    @property
    def ctrl(self) -> ControllerState:
        """The controller state carried across ticks (a view of the
        buffers)."""
        s = self.state
        return ControllerState(qp=s.qp, cmd_ref=s.cmd_ref, v_int=s.v_int)

    def _solve_step(self, s: _LoopState) -> _LoopState:
        mpc = self.mpc
        x, pf, t = s.read[:, 0:12], s.read[:, 12:18], s.read[:, 38]
        contact = contact_sequence(t, mpc, self.gait)
        sol = solve_mpc(x, t, pf, mpc, self.biped, contact, warm=s.qp, gait=self.gait,
                        cmd_ref=s.cmd_ref, v_int=s.v_int)
        return dataclasses.replace(
            s, qp=sol, cmd_ref=advance_cmd_ref(s.cmd_ref, x, mpc),
            v_int=advance_v_int(s.v_int, x, mpc), contact=contact,
            u0=sol.controls[:, 0], v_int_ll=s.v_int,
        )

    def _lowlevel_step(self, s: _LoopState) -> _LoopState:
        r = s.read
        tau = low_level_control(r[:, 0:12], r[:, 38], r[:, 12:18], r[:, 18:28], r[:, 28:38],
                                self.mpc, self.biped, s.contact, s.u0, gait=self.gait,
                                cmd_ref=s.cmd_ref, v_int=s.v_int_ll)
        return dataclasses.replace(s, tau=tau)

    def _read(self, plant: Plant, t: float) -> None:
        """One read of the plant into the graphs' input, in one copy
        through the pinned buffer (the previous copy from it has ended)."""
        x_fb, q, qd = plant.read_state()
        pf = plant.foot_positions()
        if self._read_done is not None:
            self._read_done.synchronize()
        self._read_host.numpy()[:] = np.concatenate([x_fb, pf, q, qd, [t]])
        self.state.read[0].copy_(self._read_host, non_blocking=True)
        if self._read_done is not None:
            self._read_done.record()

    def _torques(self) -> np.ndarray:
        """The last period's torques on the host (the plant needs them)."""
        self._tau_host.copy_(self.state.tau[0], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._tau_host.numpy().copy()

    def _solve_and_lowlevel(self):
        """(solve graph, low-level graph), captured at the first call."""
        if self._graphs is None:
            self._graphs = (TickGraph(self._solve_step, self.state),
                            TickGraph(self._lowlevel_step, self.state))
        return self._graphs

    @f32_precision
    @torch.no_grad()
    def warmup(self, plant: Plant) -> None:
        """Capture the solve and low-level graphs off the deadline path,
        each warmed up on a scratch copy of the buffers after one read of
        the plant (the first launch on the card loads the kernels); the
        loop's state is left as it was."""
        self._read(plant, 0.0)
        self._solve_and_lowlevel()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @f32_precision
    @torch.no_grad()
    def run(self, plant: Plant, n_ticks: int, t0: float = 0.0,
            realtime: bool = True) -> LoopStats:
        """Run ``n_ticks`` MPC periods. ``realtime=False`` does not sleep to
        the deadlines (as fast as possible; the latencies are still
        recorded)."""
        mpc, gait = self.mpc, self.gait
        ll_dt = mpc.dt / self.n_lowlevel
        solve, lowlevel = self._solve_and_lowlevel()
        latencies = []
        misses = 0
        t_sim = t0
        anchor = time.monotonic()
        for k in range(n_ticks):
            deadline = anchor + (k + 1) * mpc.dt
            tick_start = time.monotonic()

            if gait.contact_clock:
                # touchdown-sensed re-anchoring from the measured sole
                # heights (flat ground; a robot wires its foot switches here)
                pf_host = plant.foot_positions()
                down = (pf_host[2] < gait.clock_z_tol, pf_host[5] < gait.clock_z_tol)
                self._t_gait, self._hold = advance_gait_clock_host(
                    self._t_gait, self._hold, down, mpc, gait
                )
                t_used = self._t_gait
            else:
                t_used = t_sim
            self._read(plant, t_used)
            solve.replay()
            for j in range(self.n_lowlevel):
                self._read(plant, t_used + j * ll_dt)
                lowlevel.replay()
                plant.apply(self._torques(), ll_dt)

            latencies.append(time.monotonic() - tick_start)
            t_sim += mpc.dt
            if realtime:
                now = time.monotonic()
                if now > deadline:
                    misses += 1
                    # re-anchor: one overrun must not become a backlog
                    anchor = now - (k + 1) * mpc.dt
                else:
                    time.sleep(deadline - now)

        lat = np.asarray(latencies) * 1e3
        return LoopStats(
            n_ticks=n_ticks,
            deadline_misses=misses,
            latency_p50_ms=float(np.percentile(lat, 50)),
            latency_p99_ms=float(np.percentile(lat, 99)),
            latency_max_ms=float(lat.max()),
        )

"""Wall-clock real-time controller loop: the counterpart of
``biped_mpc_py_tpu/runtime/realtime.py``.

The deployment-shaped runtime: a deadline-scheduled 25 Hz loop that drives
one robot (a real robot's transport or any simulator) through a minimal
read-state / apply-torque interface, warm-started across ticks and
instrumented (per-tick latency percentiles, deadline misses).

- The plant interface is synchronous and on the host. The controller runs
  at N = 1 on the loop's device (the card unless named): each read of the
  plant is one host-to-device copy of its 39 floats (state, feet, joints
  and the clock) through pinned memory, and each apply one copy of the 10
  torques back.
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
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device, host_to_device
from biped_mpc_py_torch.utils.precision import f32_precision


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


class RealtimeLoop:
    """Deadline-scheduled MPC + low-level loop against a :class:`Plant`
    (``realtime.py:83``), on ``device`` (the card unless named; raises
    without one)."""

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
        self.ctrl = ControllerState.init(mpc, device=self.device)

    def _read(self, plant: Plant, t: float):
        """One read of the plant -> (x_fb, pf, q, qd, t) on the device, each
        with the env axis N = 1, in one copy."""
        x_fb, q, qd = plant.read_state()
        pf = plant.foot_positions()
        v = host_to_device(np.concatenate([x_fb, pf, q, qd, [t]]), self.device)[None]
        return v[:, 0:12], v[:, 12:18], v[:, 18:28], v[:, 28:38], v[:, 38]

    def _solve(self, x, t, pf, contact):
        return solve_mpc(x, t, pf, self.mpc, self.biped, contact, warm=self.ctrl.qp,
                         gait=self.gait, cmd_ref=self.ctrl.cmd_ref, v_int=self.ctrl.v_int)

    def _lowlevel(self, x, t, pf, q, qd, contact, u0, cmd_ref, v_int):
        tau = low_level_control(x, t, pf, q, qd, self.mpc, self.biped, contact, u0,
                                gait=self.gait, cmd_ref=cmd_ref, v_int=v_int)
        return tau[0].cpu().numpy()

    @f32_precision
    @torch.no_grad()
    def warmup(self, plant: Plant) -> None:
        """One solve and one low-level call off the deadline path (the
        first launch on the card loads the kernels); the loop's state is
        left as it was."""
        x, pf, q, qd, t = self._read(plant, 0.0)
        contact = contact_sequence(t, self.mpc, self.gait)
        sol = self._solve(x, t, pf, contact)
        self._lowlevel(x, t, pf, q, qd, contact, sol.controls[:, 0], self.ctrl.cmd_ref,
                       self.ctrl.v_int)
        advance_cmd_ref(self.ctrl.cmd_ref, x, self.mpc).cpu()

    @f32_precision
    @torch.no_grad()
    def run(self, plant: Plant, n_ticks: int, t0: float = 0.0,
            realtime: bool = True) -> LoopStats:
        """Run ``n_ticks`` MPC periods. ``realtime=False`` does not sleep to
        the deadlines (as fast as possible; the latencies are still
        recorded)."""
        mpc, gait = self.mpc, self.gait
        ll_dt = mpc.dt / self.n_lowlevel
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
            x, pf, _, _, t = self._read(plant, t_used)
            contact = contact_sequence(t, mpc, gait)
            v_int_now = self.ctrl.v_int
            sol = self._solve(x, t, pf, contact)
            self.ctrl = ControllerState(
                qp=sol, cmd_ref=advance_cmd_ref(self.ctrl.cmd_ref, x, mpc),
                v_int=advance_v_int(self.ctrl.v_int, x, mpc),
            )
            u0 = sol.controls[:, 0]
            for j in range(self.n_lowlevel):
                x, pf, q, qd, t = self._read(plant, t_used + j * ll_dt)
                tau = self._lowlevel(x, t, pf, q, qd, contact, u0, self.ctrl.cmd_ref,
                                     v_int_now)
                plant.apply(tau, ll_dt)

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

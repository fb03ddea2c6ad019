"""The port's articulated engine as a robot behind the real-time loop's
Plant interface: the card tests of ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s real-time phases step it where MuJoCo is not
installed."""

from __future__ import annotations

import time


class EnginePlant:
    """The port's articulated engine as the robot behind the real-time
    loop's Plant interface, where MuJoCo is not installed: one robot on
    ``device``, each 5 ms period 5 substeps of 1 ms through
    ``fused_substeps`` (the kernel on the card, its plain version on the
    CPU), the mass-matrix inverse refreshed every 8 periods (the bench
    physics). One read is one copy to the host; the foot normal forces of
    every period are kept on the device. ``sec`` sums the plant's own time
    (host clock; an apply ends synchronized)."""

    def __init__(self, torch, device):
        from biped_mpc_py_torch.sim.engine import ArtState
        from biped_mpc_py_torch.sim.model import hector_model

        self.torch, self.device = torch, device
        self.model = hector_model(device=device)
        self.s = ArtState.standing(1, device=device)
        self.k, self.host, self.forces, self.sec = 0, None, [], 0.0

    def _host(self):
        from biped_mpc_py_torch.sim.engine import feedback_and_soles

        if self.host is None:
            t0 = time.perf_counter()
            x, pf = feedback_and_soles(self.model, self.s)
            self.host = self.torch.cat([x[0], self.s.q[0], self.s.qd[0], pf[0]]).cpu().numpy()
            self.sec += time.perf_counter() - t0
        return self.host

    def read_state(self):
        v = self._host()
        return v[0:12], v[12:22], v[22:32]

    def qpos_qvel(self):
        """MuJoCo's qpos (17,) and qvel (16,) of the robot (the free joint's
        linear velocity in the world frame, its angular in the body frame),
        in one copy to the host: what ``MjController`` reads."""
        from biped_mpc_py_torch.ops.rotations import quat_to_rotm

        t0 = time.perf_counter()
        s = self.s
        v_world = (quat_to_rotm(s.quat) @ s.v_base[:, 3:6, None])[..., 0]
        v = self.torch.cat([s.pos, s.quat, s.q, v_world, s.v_base[:, 0:3], s.qd], -1)
        v = v[0].cpu().numpy()
        self.sec += time.perf_counter() - t0
        return v[0:17], v[17:33]

    def foot_positions(self):
        return self._host()[32:38]

    def apply(self, tau, dt):
        from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
        from biped_mpc_py_torch.sim.contact import contact_force_world
        from biped_mpc_py_torch.sim.engine import contact_point_states, mass_matrix_inv
        from biped_mpc_py_torch.utils.device import host_to_device

        t0 = time.perf_counter()
        if self.k % 8 == 0:
            self.Minv = mass_matrix_inv(self.model, self.s.q)
        tau = host_to_device(tau, self.device)[None]
        self.s = fused_substeps(self.model, self.s, tau, self.Minv, dt, 5)
        self.k, self.host = self.k + 1, None
        pts, vels, _, _ = contact_point_states(self.model, self.s)
        f = contact_force_world(self.model, pts, vels)[0, :, 2]
        self.forces.append(self.torch.stack([f[0] + f[1], f[2] + f[3]]))
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.sec += time.perf_counter() - t0

    def z(self) -> float:
        return float(self._host()[5])

    def tick_forces(self):
        """Per-foot normal forces (n_ticks, 2), each tick's 8 periods'
        mean."""
        return self.torch.stack(self.forces).reshape(-1, 8, 2).mean(1).cpu().numpy()

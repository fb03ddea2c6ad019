"""One-tick demo: the counterpart of ``biped_mpc_py_tpu/demo.py``.

``python -m biped_mpc_py_torch.demo`` runs the reference's main script as a
module: FK -> contact schedule -> MPC solve -> low-level torques, printing
the state reference, contact sequence, foot reference, predicted states and
controls, the tick's time and the joint torques, then a closed-loop SRB
walking rollout of one robot. Both run compiled, as the JAX demo jits them:
the tick is ``control_tick`` captured once as a CUDA graph
(``utils/graphs.py::TickGraph``) and timed on a replay, the rollout is
``batched_rollout_fn`` at N = 1, timed on its second call (on the CPU the
same buffers step eagerly).

Flags: ``--gait {walking,standing}``, ``--compat`` (the reference's
defects), ``--rollout-steps N``, ``--device`` (default ``cuda``; the run
fails without a card unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compiled_tick(x_fb, q, qd, t, mpc, gait, biped):
    """``control_tick(x_fb, q, qd, t, mpc, gait, biped)`` (a cold
    controller) on a :class:`~biped_mpc_py_torch.utils.graphs.TickGraph`
    over the buffers ``(x_fb, q, qd, t, tau, states, controls)``: the
    counterpart of the JAX demo's ``jax.jit`` of the tick. ``t`` is a (N,)
    tensor (a Python float would be copied from the host inside the
    capture). After each ``replay()`` the graph's ``carry[4:]`` holds the
    torques and the solution's states and controls."""
    from biped_mpc_py_torch.control.controller import control_tick
    from biped_mpc_py_torch.utils.graphs import TickGraph

    def step(c):
        x, q_, qd_, t_ = c[:4]
        tau, _, sol = control_tick(x, q_, qd_, t_, mpc, gait, biped)
        return (x, q_, qd_, t_, tau, sol.states, sol.controls)

    n, device = x_fb.shape[0], x_fb.device
    return TickGraph(step, (x_fb, q, qd, t, torch.zeros(n, 10, device=device),
                            torch.zeros(n, mpc.h, 13, device=device),
                            torch.zeros(n, mpc.h, 12, device=device)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gait", choices=["walking", "standing"], default="walking")
    ap.add_argument("--compat", action="store_true",
                    help="replicate the reference's defects bit-for-bit")
    ap.add_argument("--rollout-steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from biped_mpc_py_torch.config import GaitConfig, MpcConfig
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.control.reference import com_reference, foot_reference
    from biped_mpc_py_torch.models.biped import BipedParams, HECTOR_LEG_FK, HECTOR_LEG_JAC
    from biped_mpc_py_torch.models.kinematics import foot_positions_world
    from biped_mpc_py_torch.utils.device import entry_device

    device = entry_device(args.device)
    np.set_printoptions(suppress=True, precision=2)
    if args.compat:
        mpc = dataclasses.replace(
            MpcConfig(), compat_foot_ref_bug=True, compat_force_box_bug=True,
            compat_swing_yaw_bug=True, compat_ref_col0_bug=True,
        )
        biped = BipedParams(leg=HECTOR_LEG_FK, leg_jac=HECTOR_LEG_JAC)
    else:
        mpc, biped = MpcConfig(), BipedParams()
    biped = biped.to(device)
    gait = GaitConfig(gait_mode=1 if args.gait == "walking" else 0)

    # the reference's initial conditions (bipedalLocomotionMPC.py:13-16)
    x_fb = torch.tensor([[0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0, 0, 0]], device=device)
    q = torch.tensor([[0, 0, -math.pi / 4, math.pi / 2, -math.pi / 4] * 2], device=device)
    qd = torch.zeros(1, 10, device=device)
    t0 = torch.zeros(1, device=device)

    with torch.no_grad():
        pf_w = foot_positions_world(x_fb, q, biped)
        contact = contact_sequence(t0, mpc, gait)
        print("state reference:\n", com_reference(x_fb, mpc)[0].cpu().numpy())
        print("contact sequence:\n", contact[0].cpu().numpy())
        print("foot reference:\n",
              foot_reference(x_fb, t0, pf_w, mpc, contact)[0].cpu().numpy())

        # the first call on the card loads the QP kernel and captures the tick
        tick = compiled_tick(x_fb, q, qd, t0, mpc, gait, biped)
        _sync(device)
        t_start = time.perf_counter()
        tick.replay()
        _sync(device)
        print(f"MPC tick execution time: {time.perf_counter() - t_start:.6f} seconds")
        tau, states, controls = tick.carry[4:]
        print("States:\n", states[0].cpu().numpy())
        print("Controls:\n", controls[0].cpu().numpy())
        print("Torques:\n", tau[0].cpu().numpy())

    if args.rollout_steps:
        from biped_mpc_py_torch.parallel.rollout import batched_rollout_fn, init_world

        roll = batched_rollout_fn(args.rollout_steps, mpc, gait)
        roll(init_world(mpc, 1, device=device), biped)  # capture
        _sync(device)
        t_start = time.perf_counter()
        w = roll(init_world(mpc, 1, device=device), biped)
        _sync(device)
        dts = time.perf_counter() - t_start
        x = w.sim.x_fb[0].cpu().numpy()
        print(
            f"\nclosed-loop rollout ({args.rollout_steps} ticks = "
            f"{args.rollout_steps * mpc.dt:.1f} s sim): wall {dts:.3f} s "
            f"({args.rollout_steps * mpc.dt / dts:.0f}x real-time)\n"
            f"final state: z={x[5]:.3f} attitude=({x[0]:+.3f},{x[1]:+.3f}) "
            f"falls={float(w.metrics.falls[0]):.0f}"
        )


if __name__ == "__main__":
    main()

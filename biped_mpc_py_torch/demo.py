"""One-tick demo: the counterpart of ``biped_mpc_py_tpu/demo.py``.

``python -m biped_mpc_py_torch.demo`` runs the reference's main script as a
module: FK -> contact schedule -> MPC solve -> low-level torques, printing
the state reference, contact sequence, foot reference, predicted states and
controls, the tick's time and the joint torques, then a closed-loop SRB
walking rollout of one robot (``batched_rollout`` at N = 1).

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gait", choices=["walking", "standing"], default="walking")
    ap.add_argument("--compat", action="store_true",
                    help="replicate the reference's defects bit-for-bit")
    ap.add_argument("--rollout-steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from biped_mpc_py_torch.config import GaitConfig, MpcConfig
    from biped_mpc_py_torch.control.controller import control_tick
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.control.reference import com_reference, foot_reference
    from biped_mpc_py_torch.models.biped import BipedParams, HECTOR_LEG_FK, HECTOR_LEG_JAC
    from biped_mpc_py_torch.models.kinematics import foot_positions_world
    from biped_mpc_py_torch.utils.device import entry_device
    from biped_mpc_py_torch.utils.precision import f32_precision

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

        tick = f32_precision(lambda x, q, qd: control_tick(x, q, qd, 0.0, mpc, gait, biped))
        tick(x_fb, q, qd)  # the first call on the card loads the QP kernel
        _sync(device)
        t_start = time.perf_counter()
        tau, _, sol = tick(x_fb, q, qd)
        _sync(device)
        print(f"MPC tick execution time: {time.perf_counter() - t_start:.6f} seconds")
        print("States:\n", sol.states[0].cpu().numpy())
        print("Controls:\n", sol.controls[0].cpu().numpy())
        print("Torques:\n", tau[0].cpu().numpy())

    if args.rollout_steps:
        from biped_mpc_py_torch.parallel.rollout import batched_rollout, init_world

        batched_rollout(init_world(mpc, 1, device=device), biped, 1, mpc, gait)  # warm-up
        _sync(device)
        t_start = time.perf_counter()
        w = batched_rollout(init_world(mpc, 1, device=device), biped, args.rollout_steps,
                            mpc, gait)
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

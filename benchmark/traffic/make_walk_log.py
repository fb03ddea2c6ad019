"""Writes ``walk_log.npy``, the sensor log that the one-robot cells' plant
serves: one HECTOR walking in place at ``art_mpc_config()``'s default
budget, stepped by the benchmark's plain reference on the CPU.

    python -m benchmark.traffic.make_walk_log [ticks] [skip]

Each row is the robot at the start of one 5 ms low-level period, in the
order a read of the plant gives it: x_fb (12), sole positions (6), q (10),
qd (10). ``skip`` ticks from standing are left out, so the log starts
walking."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import loops
from benchmark.reference.config import GaitConfig, MpcConfig, config_value
from benchmark.reference.control.lowlevel import low_level_control
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.ops.physics import fused_substeps
from benchmark.reference.precision import matmul
from benchmark.reference.sim.engine import feedback_and_soles, mass_matrix_inv
from benchmark.reference.sim.model import hector_model

HERE = Path(__file__).resolve().parent
CONFIG = HERE.parent / "configs" / "hector_art.json"


def walk_log(n_ticks: int, skip: int) -> np.ndarray:
    cfg = json.loads(CONFIG.read_text())
    mpc, gait = MpcConfig(**cfg["mpc"]), GaitConfig(**cfg["gait"])
    kw = cfg["entry"]["batched"]["kwargs"]
    n_ll, n_sub = kw["n_lowlevel"], kw["n_substeps"]
    model, biped = hector_model(device="cpu"), BipedParams()
    w = loops.init_art_world(mpc, 1, device="cpu")
    rows = []
    with matmul(), torch.no_grad():
        for k in range(skip + n_ticks):
            x_fb, t_g, hold, contact, sol = loops._art_control_stage(w, biped, mpc, gait, model)
            u0, sim = sol.controls[:, 0], w.sim
            ll_dt = config_value(mpc, "dt", None) / n_ll
            Minv = mass_matrix_inv(model, sim.q)
            energy = torch.zeros_like(sim.t)
            for _ in range(n_ll):
                x, pf = feedback_and_soles(model, sim)
                if k >= skip:
                    rows.append(torch.cat([x[0], pf[0].reshape(-1), sim.q[0], sim.qd[0]]))
                tau = low_level_control(x, sim.t, pf, sim.q, sim.qd, mpc, biped, contact, u0,
                                        gait=gait, cmd_ref=w.ctrl.cmd_ref, v_int=w.ctrl.v_int)
                energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
                sim = fused_substeps(model, sim, tau, Minv, ll_dt, n_sub)
            w = loops._art_post_stage(w, sim, energy, x_fb, sol, t_g, hold, mpc)
            if float(w.metrics.falls[0]) > 0:
                raise RuntimeError(f"the logged robot fell at tick {k}")
    return torch.stack(rows).numpy().astype(np.float32)


if __name__ == "__main__":
    ticks = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    skip = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    log = walk_log(ticks, skip)
    np.save(HERE / "walk_log.npy", log)
    print(f"{log.shape[0]} rows, torso z {log[:, 5].min():.4f}..{log[:, 5].max():.4f} m")

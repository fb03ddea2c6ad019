"""Device time of the articulated tick's stages, each captured ``steps``
times in one CUDA graph: the counterpart of the JAX repo's
``tools/bench_art_stages.py`` (``timed``, scan x25).

At the JAX tool's budget (``_harness.BUDGET``), on ``BENCH_ENVS`` identical
standing HECTORs at t = 0, with each stage's inputs computed once before
the capture:

  com_feedback_state             the controller's whole-body feedback
  sole_positions                 the two soles' world positions
  solve_mpc (25 Hz)              one MPC solve: references, linearization,
                                 condense, Ruiz, the QP kernel, unscaling
  low_level x1 (x8/tick)         one low-level control evaluation
  art_step 5 substeps (x8/tick)  one low-level period of plain physics, its
                                 Minv refreshed every 5 substeps
  art_step 5 sub, held Minv      the same with a Minv held from outside
  mass_matrix_inv (NS12)         CRBA + 12 Newton-Schulz steps

and, beside their plain forms, the two physics kernels, which the JAX tool
predates (the port's only rows of its own):

  fused_substeps 5 sub, held Minv (kernel)   one ``fused_substeps`` launch
  fused_tick (kernel)                        one ``fused_tick`` launch: 8
                                             periods of feedback, control
                                             and 5 substeps

An isolated stage's time is its device work with its inputs in place; the
stalls between stages show only end to end (``bench_tick_stages``).

Usage, on the card: ``BENCH_ENVS=1024 python -m
biped_mpc_py_torch.tools.bench_art_stages [envs] [steps]`` (envs by default
``BENCH_ENVS``, 1024; steps 25: the calls captured per stage);
``BENCH_REPS`` (3) rounds of the stages in turns, each stage's best
reported.
"""

from __future__ import annotations

import os
import sys

import torch

from biped_mpc_py_torch.config import GaitConfig
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.control.mpc import solve_mpc
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick
from biped_mpc_py_torch.sim.engine import (
    art_step,
    com_feedback_state,
    mass_matrix_inv,
    sole_positions,
)
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.precision import f32_matmul

TOOL = "bench_art_stages"
N_ENVS, N_REPEATS = 1024, 25

LABELS = {
    "com_feedback_state": "com_feedback_state",
    "sole_positions": "sole_positions",
    "solve_mpc": "solve_mpc (25 Hz)",
    "low_level": "low_level x1 (x8/tick)",
    "art_step": "art_step 5 substeps (x8/tick)",
    "art_step_held": "art_step 5 sub, held Minv",
    "mass_matrix_inv": "mass_matrix_inv (NS12)",
    "fused_substeps": "fused_substeps 5 sub, held Minv (kernel)",
    "fused_tick": "fused_tick (kernel)",
}
# launches per call on the card
LAUNCHES = {k: h.launches() for k in LABELS} | {
    "solve_mpc": h.launches(qp=1, ruiz=1), "fused_substeps": h.launches(substeps=1),
    "fused_tick": h.launches(tick=1)}


def stages(envs: int, device) -> dict:
    """key -> (f, args): every stage of :data:`LABELS` on ``envs`` standing
    robots at t = 0 and its inputs, made once here."""
    mpc, gait = h.fast_art_mpc(), GaitConfig()
    model, biped = hector_model(device=device), BipedParams().to(device)
    worlds, bipeds = h.art_worlds(mpc, envs, device)
    sims = worlds.sim
    zeros = torch.zeros(envs, device=device)
    x_fb, pf_w = com_feedback_state(model, sims), sole_positions(model, sims)
    contact = contact_sequence(zeros, mpc, gait)
    u0 = torch.zeros((envs, 12), device=device)
    tau = torch.zeros((envs, 10), device=device)
    Minv = mass_matrix_inv(model, sims.q)
    return {
        "com_feedback_state": (lambda s: com_feedback_state(model, s), (sims,)),
        "sole_positions": (lambda s: sole_positions(model, s), (sims,)),
        "solve_mpc": (lambda x, p, t, b, c: solve_mpc(x, t, p, mpc, b, c),
                      (x_fb, pf_w, zeros, bipeds, contact)),
        "low_level": (lambda x, p, s, t, b, c, u: low_level_control(x, t, p, s.q, s.qd, mpc, b,
                                                                    c, u),
                      (x_fb, pf_w, sims, zeros, bipeds, contact, u0)),
        "art_step": (lambda s, t: art_step(model, s, t, 0.005, 5, None, m_refresh=5),
                     (sims, tau)),
        "art_step_held": (lambda s, t, m: art_step(model, s, t, 0.005, 5, None, Minv=m),
                          (sims, tau, Minv)),
        "mass_matrix_inv": (lambda s: mass_matrix_inv(model, s.q), (sims,)),
        "fused_substeps": (lambda s, t, m: fused_substeps(model, s, t, m, 0.005, 5),
                           (sims, tau, Minv)),
        "fused_tick": (lambda s, u, c, t, m, v: fused_tick(model, biped, mpc, gait, s, u, c, t,
                                                           t, v, m),
                       (sims, u0, contact[:, 0].contiguous(), zeros, Minv, worlds.ctrl.v_int)),
    }


def run(envs: int = N_ENVS, steps: int = N_REPEATS, reps: int = h.DEFAULT_REPS,
        device="cuda") -> list[dict]:
    """Every stage at ``envs`` envs, ``steps`` calls captured per stage, in
    turns for ``reps`` rounds -> one record per stage
    (``_harness.stage_record``: ``ms`` a call)."""
    device = entry_device(device)
    where = h.card(device)
    with torch.no_grad(), f32_matmul():
        timed = h.time_stages(stages(envs, device), steps, reps)
    return [h.stage_record(TOOL, k, LABELS[k], timed[k], envs, steps, where) for k in LABELS]


def main(argv=None, device="cuda") -> int:
    """The command (``_harness.main``); envs by default ``BENCH_ENVS``."""
    return h.main(TOOL, run, lambda r, envs: f"{r['label']:42s} {r['ms']:8.3f} ms / {envs} envs",
                  (int(os.environ.get("BENCH_ENVS", str(N_ENVS))), N_REPEATS), argv, device,
                  sizes=("envs", "repeats"))


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end variant deltas of the plain articulated chain's graph tick:
the counterpart of the JAX repo's ``tools/bench_art_probe.py``.

The plain chain (``batched_art_rollout_fn``: 8 low-level periods of 5
plain ``art_step`` substeps, Minv held all tick, the QP kernel the only
hand-written kernel on it) at the JAX tool's budget (``_harness.BUDGET``),
walking in place on identical robots, as CUDA graphs:

  base      the bench's ``BENCH_MODE=art BENCH_ART_BACKEND=xla`` path
  sub1      n_substeps 5 -> 1 (the delta is the substep chain's cost)
  solver1   1 ADMM iteration, 1 Newton-Schulz step, none in bf16 (the
            delta is about the solver's iterations)

each with the three bf16 knobs on and off (``knobs off``:
``kinv_bf16_iters`` 0, no bf16 matvec, f32 Ruiz norms). The JAX tool's
``unroll`` and ``ll_unroll`` variants are left out: they set XLA's scan
unrolling, and a CUDA graph of a Python loop is unrolled already.

In place of XLA's ``cost_analysis`` FLOPs against a TPU peak, each record
carries the QP kernel's time alone on the first tick's QPs at its budget
(``fused_qp_solve`` captured ``steps`` times), its bound from
``utils/roofline.py`` (``qp_solve_work``, ``qp_solve_bound_ms``: H100 peaks)
and the bound's share of the kernel's time. No other hand-written kernel
runs on this path.

Usage, on the card: ``python -m biped_mpc_py_torch.tools.bench_art_probe
[envs] [steps]`` (1024, 20); ``BENCH_REPS`` (3) rounds of the variants in
turns, each variant's best reported. The ablations are timing-only; their
falls are reported, not bounded.
"""

from __future__ import annotations

import sys

import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.ops.cuda.qp_kernel import fused_qp_solve
from biped_mpc_py_torch.ops.qp import m_step, solver_args
from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_fn
from biped_mpc_py_torch.sim.engine import feedback_and_soles
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.precision import f32_matmul
from biped_mpc_py_torch.utils.roofline import qp_solve_bound_ms, qp_solve_work

TOOL = "bench_art_probe"
N_ENVS, N_STEPS = 1024, 20
SOLVER1 = dict(n_admm_iters=1, kinv_ns_iters=1, kinv_bf16_iters=0)

# key: (the JAX tool's label, budget fields replaced, rollout arguments)
VARIANTS = {
    "base": ("base           ", {}, {}),
    "base-knobs-off": ("base knobs off ", h.KNOBS_OFF, {}),
    "sub1": ("sub1 (ablation)", {}, dict(n_substeps=1)),
    "sub1-knobs-off": ("sub1 knobs off ", h.KNOBS_OFF, dict(n_substeps=1)),
    "solver1": ("solver1 (abl.) ", SOLVER1, {}),
    "solver1-knobs-off": ("solver1 knobs off", SOLVER1 | h.KNOBS_OFF, {}),
}
# launches per replay (one tick) on the card
LAUNCHES = {k: h.launches(qp=1) for k in VARIANTS}


def first_qp_core(mpc: MpcConfig, gait: GaitConfig, worlds, bipeds) -> tuple:
    """The QP kernel's eight inputs for the first tick of ``worlds`` at
    ``mpc``: the control stage's QP (feedback, contact schedule,
    ``build_mpc_qp``), Ruiz-scaled, cold."""
    sim = worlds.sim
    x_fb, pf_w = feedback_and_soles(hector_model(device=sim.q.device), sim)
    contact = contact_sequence(sim.t, mpc, gait)
    return h.scaled_core(build_mpc_qp(x_fb, sim.t, pf_w, mpc, bipeds, contact, gait), mpc)


def run(envs: int = N_ENVS, steps: int = N_STEPS, reps: int = h.DEFAULT_REPS,
        device="cuda") -> list[dict]:
    """Every variant at ``envs`` identical standing robots x ``steps``
    ticks, in turns for ``reps`` rounds -> one record per variant
    (``_harness.graph_record``) with ``qp_kernel_ms``, ``qp_bound_ms``,
    ``qp_bound_by`` and ``qp_bound_share`` of its budget."""
    device = entry_device(device)
    gait = GaitConfig()
    where = h.card(device)
    mpcs = {key: h.fast_art_mpc(**budget) for key, (_, budget, _) in VARIANTS.items()}
    with torch.no_grad(), f32_matmul():
        cases = {key: (batched_art_rollout_fn(steps, mpcs[key], gait, minv_ll_hold=8,
                                              n_substeps=kw.get("n_substeps", 5)),
                       h.art_worlds(mpcs[key], envs, device))
                 for key, (_, _, kw) in VARIANTS.items()}
        timed = h.time_graphs(cases, steps, reps)
        qp = h.time_stages({
            key: (lambda *a, m=m: fused_qp_solve(*a, **solver_args(m)),
                  first_qp_core(m, gait, *cases[key][1]))
            for key, m in mpcs.items()}, steps, reps)
    records = []
    for key, (label, _, _) in VARIANTS.items():
        mpc, qp_ms = mpcs[key], qp[key]["ms"]
        bound, by = qp_solve_bound_ms(qp_solve_work(envs, mpc.h, m_step(mpc),
                                                    **solver_args(mpc)))
        records.append(h.graph_record(TOOL, key, label, timed[key], envs, steps, where) | {
            "qp_kernel_ms": qp_ms, "qp_bound_ms": bound, "qp_bound_by": by,
            "qp_bound_share": bound / qp_ms})
    return records


def _line(r: dict, envs: int) -> str:
    return (f"{VARIANTS[r['name']][0]}: {r['env_steps_per_s']:9.0f} env-steps/s  "
            f"{r['ms']:7.3f} ms/tick falls={r['falls']:.0f} (capture {r['capture_s']:.1f}s)"
            f"\n  QP kernel {r['qp_kernel_ms']:.4f} ms, bound {r['qp_bound_ms']:.3g} ms "
            f"({r['qp_bound_by']}) = {100 * r['qp_bound_share']:.2f}% of it")


def main(argv=None, device="cuda") -> int:
    """The command (``_harness.main``)."""
    return h.main(TOOL, run, _line, (N_ENVS, N_STEPS), argv, device)


if __name__ == "__main__":
    sys.exit(main())

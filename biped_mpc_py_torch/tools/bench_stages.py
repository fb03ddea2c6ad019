"""Device time of the SRB batched tick's stages, each captured ``steps``
times in one CUDA graph: the counterpart of the JAX repo's
``tools/bench_stages.py`` (``scan100``).

At ``fast_mpc_config()`` (the bench budget, the three bf16 knobs on), on
``envs`` identical standing SRB envs walking at t = 0, with the stage's
inputs computed once before the capture:

  references          com_reference + foot_reference
  linearize           linearize_horizon
  condense            condense
  ruiz                ruiz_equilibrate, f32 column norms (the JAX tool's)
  ruiz (bf16 norms)   the same with ruiz_bf16_norms, as the bench solves
  ruiz, kernel; ruiz (bf16 norms), kernel
                      the same through scale_qp, the stage qp.ruiz of a
                      cold solve: the Ruiz kernel on the card (one launch,
                      the zero warm start written too), the plain version
                      on the CPU
  ns_inv(14), ns_inv(10), ns_inv(10,bf16=8)
                      ns_inverse of the scaled P + 1e-6 I
  full solve (f32)    solve_qp with kinv_bf16_iters 0 and no bf16 matvec
                      (the Ruiz norms stay bf16, as in the JAX tool)
  full solve (bf16)   solve_qp at fast_mpc_config()
  full tick (f32), full tick (bf16)
                      batched_closed_loop_tick at the two budgets

Each full solve runs twice: ``kernel`` through the QP kernel
(``ops/cuda/qp_kernel.py``, one launch), and ``plain`` through the kernel's
plain PyTorch version on the same device (the JAX tool times only its
``backend="xla"``). An isolated stage's time is its device work with its
inputs in place; a tick's stall between stages shows only end to end
(``bench_tick_stages``).

Usage, on the card: ``python -m biped_mpc_py_torch.tools.bench_stages
[envs] [steps]`` (1024, 100: the calls captured per stage); ``BENCH_REPS``
(3) rounds of the stages in turns, each stage's best reported.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from biped_mpc_py_torch.config import GaitConfig, fast_mpc_config
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.control.reference import com_reference, foot_reference
from biped_mpc_py_torch.models.srb import linearize_horizon
from biped_mpc_py_torch.ops.qp import condense, ns_inverse, ruiz_equilibrate, scale_qp, solve_qp
from biped_mpc_py_torch.parallel.rollout import batched_closed_loop_tick
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.precision import f32_matmul

TOOL = "bench_stages"
N_ENVS, N_REPEATS = 1024, 100

# key -> the JAX tool's label (the solves: ", kernel" or ", plain" added)
LABELS = {
    "references": "references",
    "linearize": "linearize",
    "condense": "condense",
    "ruiz": "ruiz",
    "ruiz_bf16": "ruiz (bf16 norms)",
    "ruiz_kernel": "ruiz, kernel",
    "ruiz_bf16_kernel": "ruiz (bf16 norms), kernel",
    "ns14": "ns_inv(14)",
    "ns10": "ns_inv(10)",
    "ns10_bf16": "ns_inv(10,bf16=8)",
    "solve_f32_kernel": "full solve (f32), kernel",
    "solve_f32_plain": "full solve (f32), plain",
    "solve_bf16_kernel": "full solve (bf16), kernel",
    "solve_bf16_plain": "full solve (bf16), plain",
    "tick_f32": "full tick (f32)",
    "tick_bf16": "full tick (bf16)",
}
# launches per call on the card: the kernel solves and the ticks launch the
# Ruiz and the QP kernels, the Ruiz stages the Ruiz kernel
LAUNCHES = {k: h.launches(qp=int(k.startswith(("solve", "tick")) and not k.endswith("plain")),
                          ruiz=int(k.endswith("kernel") or k.startswith("tick")))
            for k in LABELS}


def stages(envs: int, device) -> dict:
    """key -> (f, args): every stage of :data:`LABELS` on ``envs`` standing
    SRB envs at t = 0 and its inputs, made once here."""
    mpc, gait = fast_mpc_config(), GaitConfig()
    mpc_f32 = dataclasses.replace(mpc, kinv_bf16_iters=0, admm_bf16_matvec=False)
    worlds, bipeds = h.srb_worlds(mpc, envs, device)
    sim = worlds.sim
    contact = contact_sequence(sim.t, mpc, gait)
    qp = build_mpc_qp(sim.x_fb, sim.t, sim.foot, mpc, bipeds, contact, gait)

    def refs(x, t, foot, c):
        return com_reference(x, mpc), foot_reference(x, t, foot, mpc, c, gait)

    x_ref, f_ref = refs(sim.x_fb, sim.t, sim.foot, contact)
    A, B = linearize_horizon(mpc, bipeds, x_ref, f_ref)
    Ph = ruiz_equilibrate(qp)[0]
    K = Ph + 1e-6 * torch.eye(Ph.shape[-1], device=device)
    out = {
        "references": (refs, (sim.x_fb, sim.t, sim.foot, contact)),
        "linearize": (lambda xr, fr, b: linearize_horizon(mpc, b, xr, fr), (x_ref, f_ref, bipeds)),
        "condense": (lambda x, xr, a, b, c, bp: condense(mpc, bp, x, xr, a, b, c),
                     (sim.x_fb, x_ref, A, B, contact, bipeds)),
        "ruiz": (ruiz_equilibrate, (qp,)),
        "ruiz_bf16": (lambda q: ruiz_equilibrate(q, bf16_norms=True), (qp,)),
        "ruiz_kernel": (lambda q: scale_qp(q, dataclasses.replace(mpc, ruiz_bf16_norms=False)),
                        (qp,)),
        "ruiz_bf16_kernel": (lambda q: scale_qp(q, mpc), (qp,)),
        "ns14": (lambda k: ns_inverse(k, 14), (K,)),
        "ns10": (lambda k: ns_inverse(k, 10), (K,)),
        "ns10_bf16": (lambda k: ns_inverse(k, 10, 8), (K,)),
    }
    for name, m in (("f32", mpc_f32), ("bf16", mpc)):
        out[f"solve_{name}_kernel"] = (lambda q, m=m: solve_qp(q, m), (qp,))
        out[f"solve_{name}_plain"] = (lambda q, m=m: h.solve_plain(q, m), (qp,))
        out[f"tick_{name}"] = (lambda w, b, m=m: batched_closed_loop_tick(w, m, gait, b),
                               (worlds, bipeds))
    return out


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
    """The command (``_harness.main``)."""
    return h.main(TOOL, run, lambda r, envs: f"{r['label'] + ':':27s} {r['ms']:8.3f} ms/{envs}",
                  (N_ENVS, N_REPEATS), argv, device, sizes=("envs", "repeats"))


if __name__ == "__main__":
    sys.exit(main())

"""The QP kernel in its cone configuration: the counterpart of the JAX
repo's ``tools/bench_cone_kernel.py``.

With ``MpcConfig.mu_z`` set, the load-dependent torsional cone adds 4 rows
a step (``ops/qp.py::torsional_rows``): 28 rows a step, m = 280 over the
10-step horizon, against 240 without it. The inputs are the JAX tool's,
from the same numpy seed: ``envs`` states 0.01-scale about standing at z =
0.53 (walking states the default budget converges on), both feet at
(-0.02, +-0.09, 0), walking at t = 0 under ``MpcConfig(mu_z=0.06)``.

Each solve runs at the default budget (60 ADMM iterations in 3 rho phases,
polish, 14 Newton-Schulz steps, no bf16 knob) through the QP kernel
(``kernel``) and through its plain PyTorch version on the same device
(``plain``, the JAX tool's ``xla``), captured ``steps`` times in one CUDA
graph: the whole solve (Ruiz, the core, unscaling; what the JAX tool
times) and the core alone (``fused_qp_solve`` or its plain version). Each
prints ``m_tot``, steady ms a solve and us an env, ``res_prim``'s max, the
core's bound (``utils/roofline.py::qp_solve_work`` at 28 rows a step, H100
peaks) and its share of the core's time; then the agreement per env of
the kernel's controls with the plain version's, over every env and over
the converged ones (plain ``res_prim`` < 1e-2), as the JAX tool computes
it. The JAX tool's ``block_envs`` (envs per Pallas block, a TPU VMEM
budget) and ``M_PAD`` (the 128-row padding) have no counterpart here: the
kernel takes one env per CTA, unpadded.

Usage, on the card: ``python -m biped_mpc_py_torch.tools.bench_cone_kernel
[envs] [steps]`` (256, 5); ``BENCH_REPS`` (3) rounds of the solves in turns,
each solve's best reported.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda.qp_kernel import fused_qp_solve, fused_qp_solve_reference
from biped_mpc_py_torch.ops.qp import solve_qp, solver_args
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.precision import f32_matmul
from biped_mpc_py_torch.utils.roofline import qp_solve_bound_ms, qp_solve_work

TOOL = "bench_cone_kernel"
N_ENVS, N_REPEATS = 256, 5
SEED = 0
STANDING = np.array([0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0, 0, 0])
FEET = np.array([-0.02, 0.09, 0, -0.02, -0.09, 0])
CONVERGED = 1e-2  # plain res_prim under which an env counts as converged
PAST = 0.1  # N: an env's controls this far apart count against the floor
# objective slack over twice the floor's excess (|objective| ~ 470 here;
# 1e-3 is about 2e-6 of it, some 30 float32 ulps)
EXCESS_SLACK = 1e-3
# launches per call on the card
LAUNCHES = {"kernel": h.launches(qp=1, ruiz=1), "plain": h.launches(),
            "kernel core": h.launches(qp=1), "plain core": h.launches()}


def mpc_config() -> MpcConfig:
    """The default budget with the torsional cone on."""
    return MpcConfig(mu_z=0.06)


def state_arrays(envs: int) -> tuple[np.ndarray, np.ndarray]:
    """(x (envs,12), feet (envs,6)) float32 from ``default_rng(SEED)``, as
    the JAX tool draws them."""
    rng = np.random.default_rng(SEED)
    x = (rng.normal(size=(envs, 12)) * 0.01 + STANDING).astype(np.float32)
    return x, np.tile(FEET.astype(np.float32), (envs, 1))


def inputs(envs: int, device):
    """``envs`` cone QPs on ``device`` (:func:`state_arrays` at t = 0,
    walking contact, the default robot)."""
    mpc = mpc_config()
    x, feet = (torch.from_numpy(a).to(device) for a in state_arrays(envs))
    t = torch.zeros(envs, device=device)
    contact = contact_sequence(t, mpc, GaitConfig())
    return build_mpc_qp(x, t, feet, mpc, BipedParams().expand(envs).to(device), contact)


def _diff(a, b) -> np.ndarray:
    """Per env, the largest |difference| of two solutions' controls (N)."""
    return (a.controls.double() - b.controls.double()).abs().flatten(1).amax(1).cpu().numpy()


def objective(qp, sol) -> torch.Tensor:
    """Per env, the QP's objective 1/2 u'Pu + q'u at ``sol``'s controls,
    evaluated in float64."""
    u = sol.controls.double().flatten(1)
    return 0.5 * torch.einsum("ni,nij,nj->n", u, qp.P.double(), u) + (qp.q.double() * u).sum(1)


def agreement(qp, sol, ref, ref64) -> dict:
    """The kernel's solution ``sol`` against the plain version's ``ref``
    on the same QPs, beside the floor: ``ref`` against ``ref64``, the plain
    version's solve of the same QPs in float64.

    The per-env |controls| difference's median, p95, max, count past
    :data:`PAST` N and max over the converged envs (plain ``res_prim`` <
    :data:`CONVERGED`, as the JAX tool computes it); the floor's median,
    count and max; ``excess`` and ``floor_excess``, the largest amount by
    which ``sol``'s and ``ref``'s objective exceeds ``ref64``'s on an env;
    ``res_prim`` and ``floor_res_prim``, their largest constraint
    violation."""
    d, floor = _diff(sol, ref), _diff(ref, ref64)
    conv = (ref.res_prim < CONVERGED).cpu().numpy()
    j64 = objective(qp, ref64)
    return {"converged": int(conv.sum()), "median": float(np.median(d)),
            "p95": float(np.percentile(d, 95)), "max": float(d.max()),
            "past": int((d > PAST).sum()),
            "max_converged": float(d[conv].max()) if conv.any() else None,
            "floor_median": float(np.median(floor)), "floor_past": int((floor > PAST).sum()),
            "floor_max": float(floor.max()),
            "excess": float((objective(qp, sol) - j64).max()),
            "floor_excess": float((objective(qp, ref) - j64).max()),
            "res_prim": float(sol.res_prim.max()), "floor_res_prim": float(ref.res_prim.max())}


def agreement_faults(r: dict) -> list[str]:
    """What an :func:`agreement` record breaks of the rule that holds the
    kernel to its plain version as the plain float32 solve is held to the
    float64 one (ROADMAP Queue 3's default-budget rule): the median env
    within 0.01 N or twice the floor's median; the envs past 0.1 N at most
    twice the floor's count plus 5; no env's objective above the float64
    solve's by more than twice the floor's worst excess plus
    :data:`EXCESS_SLACK`; the largest constraint violation at most twice
    the floor's plus 1e-3. The objective clause is the one a few wrong envs
    cannot pass: at these states the default budget leaves the controls
    Newtons apart along directions where the objective is flat, so the
    controls' max alone says little."""
    faults = []
    if r["median"] > max(0.01, 2 * r["floor_median"]):
        faults.append(f"median {r['median']:.4g} N past max(0.01, 2 x {r['floor_median']:.4g})")
    if r["past"] > 2 * r["floor_past"] + 5:
        faults.append(f"{r['past']} envs past {PAST} N, more than 2 x {r['floor_past']} + 5")
    if r["excess"] > 2 * max(r["floor_excess"], 0.0) + EXCESS_SLACK:
        faults.append(f"objective excess {r['excess']:.4g} past 2 x {r['floor_excess']:.4g} "
                      f"+ {EXCESS_SLACK}")
    if r["res_prim"] > 2 * r["floor_res_prim"] + 1e-3:
        faults.append(f"res_prim {r['res_prim']:.4g} past 2 x {r['floor_res_prim']:.4g} + 1e-3")
    return faults


def run(envs: int = N_ENVS, steps: int = N_REPEATS, reps: int = h.DEFAULT_REPS,
        device="cuda") -> list[dict]:
    """The four solves (``kernel``, ``plain``, and each one's core alone)
    at ``envs`` envs, ``steps`` calls captured per solve, in turns for
    ``reps`` rounds -> one record per solve (``_harness.stage_record`` with
    ``m_tot``, ``us_per_env``; ``res_prim_max`` for a whole solve,
    ``bound_ms``, ``bound_by``, ``bound_share`` for a core), then the
    :func:`agreement` record of the kernel's whole solve against the plain
    one's, its floor from the plain solve in float64 (untimed)."""
    device = entry_device(device)
    where = h.card(device)
    mpc = mpc_config()
    with torch.no_grad(), f32_matmul():
        qp = inputs(envs, device)
        core, kw = h.scaled_core(qp, mpc), solver_args(mpc)
        timed = h.time_stages({
            "kernel": (lambda q: solve_qp(q, mpc), (qp,)),
            "plain": (lambda q: h.solve_plain(q, mpc), (qp,)),
            "kernel core": (lambda *a: fused_qp_solve(*a, **kw), core),
            "plain core": (lambda *a: fused_qp_solve_reference(*a, **kw), core),
        }, steps, reps)
        ref64 = h.solve_plain(qp.map(torch.Tensor.double), mpc)
        agree = agreement(qp, timed["kernel"]["out"], timed["plain"]["out"], ref64)
    h_steps, rows = qp.l.shape[1], qp.l.shape[2]
    bound, by = qp_solve_bound_ms(qp_solve_work(envs, h_steps, rows, **kw))
    records = []
    for key, t in timed.items():
        r = h.stage_record(TOOL, key, key, t, envs, steps, where)
        r |= {"m_tot": h_steps * rows, "us_per_env": t["ms"] / envs * 1e3}
        if key.endswith("core"):
            r |= {"bound_ms": bound, "bound_by": by, "bound_share": bound / t["ms"]}
        else:
            r["res_prim_max"] = float(t["out"].res_prim.max())
        records.append(r)
    records.append({"tool": TOOL, "name": "agreement", "envs": envs, **agree, **where})
    return records


def _line(r: dict, envs: int) -> str:
    if r["name"] == "agreement":
        conv = "none" if r["max_converged"] is None else f"{r['max_converged']:.2e}"
        return (f"converged envs (plain res_prim < {CONVERGED:.0e}): {r['converged']}/{envs}"
                f"\nkernel vs plain |controls| diff: median={r['median']:.2e} "
                f"p95={r['p95']:.2e} max={r['max']:.2e} max_converged={conv} "
                f"past {PAST} N: {r['past']}"
                f"\nfloor, plain f32 vs f64: median={r['floor_median']:.2e} "
                f"max={r['floor_max']:.2e} past {PAST} N: {r['floor_past']}"
                f"\nobjective excess over f64: kernel {r['excess']:.2e} "
                f"plain {r['floor_excess']:.2e}; faults: {agreement_faults(r) or 'none'}")
    text = (f"{r['name']}: m_tot={r['m_tot']} capture+first={r['capture_s']:.1f}s "
            f"steady={r['ms']:.3f} ms ({r['us_per_env']:.2f} us/env)")
    if "bound_ms" in r:
        return (text + f" bound={r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {100 * r['bound_share']:.2f}% of it)")
    return text + f" res_prim_max={r['res_prim_max']:.2e}"


def main(argv=None, device="cuda") -> int:
    """The command (``_harness.main``)."""
    return h.main(TOOL, run, _line, (N_ENVS, N_REPEATS), argv, device,
                  sizes=("envs", "repeats"))


if __name__ == "__main__":
    sys.exit(main())

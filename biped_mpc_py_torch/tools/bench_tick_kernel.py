"""The tick-kernel path against the substep-kernel path, and the tick
path's solver and kernel-shape ablations: the counterpart of the JAX repo's
``tools/bench_tick_kernel.py``.

The full articulated closed loop on the card at the bench's operating point
(``_harness.BUDGET``, 1 kHz physics, Minv held all tick, walking in place,
identical robots), as CUDA graphs:

  tick-kernel     batched_art_rollout_tick_kernel_fn: low-level control and
                  physics in one fused_tick launch a tick
  substep-kernel  batched_art_rollout_kernel_fn(minv_ll_hold=8): one
                  fused_substeps launch per 5 ms low-level period, the
                  control between them as PyTorch ops
  speedup         the first's env-steps/s over the second's

then end-to-end deltas on the tick path: ``admm1`` (1 ADMM iteration:
bounds the ADMM loop), ``ns1`` (1 Newton-Schulz step, none in bf16: bounds
the K inverse), ``admm1+ns1``, ``sub1`` (8 periods of 1 substep: bounds the
kernel's substep arithmetic) and ``ll4`` (4 periods of 10 substeps: the
same 40 substeps with half the in-kernel control). The ablations are
timing-only; their falls are reported, not bounded.

Usage, on the card: ``python -m biped_mpc_py_torch.tools.bench_tick_kernel
[envs] [steps]`` (1024, 50); ``BENCH_REPS`` (3) rounds of the variants in
turns, each variant's best reported.
"""

from __future__ import annotations

import sys

import torch

from biped_mpc_py_torch.config import GaitConfig
from biped_mpc_py_torch.parallel.rollout_art import (
    batched_art_rollout_kernel_fn,
    batched_art_rollout_tick_kernel_fn,
)
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.precision import f32_matmul

TOOL = "bench_tick_kernel"
N_ENVS, N_STEPS = 1024, 50


def _tick(**kw):
    return lambda n, mpc, gait: batched_art_rollout_tick_kernel_fn(n, mpc, gait, **kw)


# key: (the JAX tool's label, budget fields replaced, the factory)
VARIANTS = {
    "tick": ("tick-kernel   ", {}, _tick()),
    "substep": ("substep-kernel", {}, lambda n, mpc, gait: batched_art_rollout_kernel_fn(
        n, mpc, gait, minv_ll_hold=8)),
    "admm1": ("tick admm1 abl", dict(n_admm_iters=1), _tick()),
    "ns1": ("tick ns1 abl  ", dict(kinv_ns_iters=1, kinv_bf16_iters=0), _tick()),
    "admm1+ns1": ("tick admm1+ns1", dict(n_admm_iters=1, kinv_ns_iters=1, kinv_bf16_iters=0),
                  _tick()),
    "sub1": ("tick sub1 abl ", {}, _tick(n_substeps=1)),
    "ll4": ("tick ll4 abl  ", {}, _tick(n_lowlevel=4, n_substeps=10)),
}
# launches per replay (one tick) on the card
LAUNCHES = {k: h.launches(qp=1, tick=1) for k in VARIANTS} | {
    "substep": h.launches(qp=1, substeps=8)}


def run(envs: int = N_ENVS, steps: int = N_STEPS, reps: int = h.DEFAULT_REPS,
        device="cuda") -> list[dict]:
    """Every variant at ``envs`` identical standing robots x ``steps``
    ticks, in turns for ``reps`` rounds -> one record per variant
    (``_harness.graph_record``), the JAX tool's order: the two paths, then
    ``{"name": "speedup", "speedup": ...}`` (the tick path's env-steps/s
    over the substep path's), then the ablations."""
    device = entry_device(device)
    gait = GaitConfig()
    where = h.card(device)
    with torch.no_grad(), f32_matmul():
        cases = {}
        for key, (_, budget, factory) in VARIANTS.items():
            mpc = h.fast_art_mpc(**budget)
            cases[key] = (factory(steps, mpc, gait), h.art_worlds(mpc, envs, device))
        timed = h.time_graphs(cases, steps, reps)
    records = [h.graph_record(TOOL, k, VARIANTS[k][0], timed[k], envs, steps, where)
               for k in VARIANTS]
    speedup = {"tool": TOOL, "name": "speedup", "envs": envs, "steps": steps,
               "speedup": timed["substep"]["ms"] / timed["tick"]["ms"], **where}
    return records[:2] + [speedup] + records[2:]


def _line(r: dict, envs: int) -> str:
    if r["name"] == "speedup":
        return f"speedup: {r['speedup']:.2f}x"
    return (f"{VARIANTS[r['name']][0]}: {r['env_steps_per_s']:9.0f} env-steps/s  "
            f"{r['ms']:7.3f} ms/tick  falls={r['falls']:.0f}  z_mean={r['z_mean']:.3f}"
            f"  (capture {r['capture_s']:.1f}s)")


def main(argv=None, device="cuda") -> int:
    """The command (``_harness.main``)."""
    return h.main(TOOL, run, _line, (N_ENVS, N_STEPS), argv, device)


if __name__ == "__main__":
    sys.exit(main())

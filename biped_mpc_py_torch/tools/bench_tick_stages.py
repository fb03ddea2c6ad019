"""Stage bounds of the tick-kernel rollout's graph tick, by end-to-end
variant deltas: the counterpart of the JAX repo's
``tools/bench_tick_stages.py``.

Under a CUDA graph a tick is one replay and profiler ranges do not exist,
so, as the JAX tool does for its compiled scan, this one removes the stages
outside the fused tick kernel one after another and reads each stage's cost
as the difference between neighbouring variants:

  base      = batched_art_rollout_tick_kernel_fn (the bench's tick path)
  mpc-off   = skip _art_control_stage (references, linearization,
              condense, Ruiz, the QP kernel, the gait clock): hold the
              previous QP solution, contact flags pinned to stance -> the
              whole MPC layer
  +fb-off   = also skip feedback_and_soles' whole-body FK (the kernel
              recomputes the feedback inside anyway)
  +minv-off = also hold the standing pose's Minv for every tick -> the
              per-tick mass_matrix_inv (CRBA + 12 Newton-Schulz steps)
  +post-off = also skip _art_post_stage (fall reset, controller state,
              metrics) -> what is left is one fused_tick launch and the
              graph's glue: the floor of this architecture.

Each variant composes the port's stages as ``_tick_kernel_tick``
(``parallel/rollout_art.py``) does. Timing-only ablations: the robots'
dynamics do not matter (falls are expected and reported, not bounded; they
reset, and the tick's work does not depend on the state).

Usage, on the card: ``python -m biped_mpc_py_torch.tools.bench_tick_stages
[envs] [steps]`` (1024, 50). ``BENCH_REPS`` (3): rounds of the variants in
turns, each variant's best reported. ``BENCH_VARIANTS``
(``base,mpc,fb,minv,post``): which to run. One line per variant, the JAX
tool's, with the record as JSON after it; with all five, the attribution.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from biped_mpc_py_torch.config import GaitConfig, MpcConfig
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick
from biped_mpc_py_torch.parallel.rollout_art import (
    _art_control_stage,
    _art_post_stage,
    batched_art_rollout_tick_kernel_fn,
)
from biped_mpc_py_torch.sim.engine import ArtState, feedback_and_soles, mass_matrix_inv
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.tools import _harness as h
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.graphs import graphed
from biped_mpc_py_torch.utils.precision import f32_matmul

TOOL = "bench_tick_stages"
N_ENVS, N_STEPS = 1024, 50


def variant_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig, device, *,
               mpc_off: bool = False, fb_off: bool = False, minv_off: bool = False,
               post_off: bool = False):
    """``fn(worlds, bipeds) -> worlds``: ``n_steps`` ticks of the tick-kernel
    path on ``device`` with the named stages removed (a timing probe), as
    a ``graphed`` rollout. With every flag off it is the bench's tick."""
    model, biped = hector_model(device=device), BipedParams().to(device)
    minv0 = mass_matrix_inv(model, ArtState.standing(1, device=device).q) if minv_off else None

    def tick(w, bipeds):
        sim = w.sim
        n = sim.q.shape[0]
        if mpc_off:
            sol = w.ctrl.qp  # hold the previous solution
            t_g, hold = sim.t, w.ctrl.hold_count
            if fb_off:
                x_fb = torch.zeros((n, 12), dtype=sim.q.dtype, device=sim.q.device)
            else:
                x_fb, _ = feedback_and_soles(model, sim)
            c0 = torch.ones((n, 2), dtype=sim.q.dtype, device=sim.q.device)
        else:
            x_fb, t_g, hold, contact, sol = _art_control_stage(w, bipeds, mpc, gait, model)
            c0 = contact[:, 0, 0:2]
        t0 = t_g if gait.contact_clock else sim.t
        Minv = minv0.expand(n, 16, 16) if minv_off else mass_matrix_inv(model, sim.q)
        sim_new, energy = fused_tick(model, biped, mpc, gait, sim, sol.controls[:, 0], c0, t0,
                                     w.ctrl.cmd_ref[:, 2], w.ctrl.v_int, Minv)
        if post_off:
            return dataclasses.replace(w, sim=sim_new)
        return _art_post_stage(w, sim_new, energy, x_fb, sol, t_g, hold, mpc)

    return graphed(tick, n_steps)


# key: (the JAX tool's label, its flags); None is the bench path itself
VARIANTS = {
    "base": ("base (bench path)     ", None),
    "mpc": ("mpc-off               ", dict(mpc_off=True)),
    "fb": ("mpc-off fb-off        ", dict(mpc_off=True, fb_off=True)),
    "minv": ("mpc/fb/minv-off       ", dict(mpc_off=True, fb_off=True, minv_off=True)),
    "post": ("mpc/fb/minv/post-off  ", dict(mpc_off=True, fb_off=True, minv_off=True,
                                           post_off=True)),
}
# launches per replay (one tick) on the card
LAUNCHES = {k: h.launches(qp=int(k == "base"), tick=1) for k in VARIANTS}
# (the attribution's line, the variant whose ms it starts from, the one it
# subtracts; None: the variant's own ms)
ATTRIBUTION = (
    ("MPC layer (ref+lin+condense+solve)", "base", "mpc"),
    ("FK feedback_and_soles", "mpc", "fb"),
    ("per-tick NS(16) mass-matrix inv", "fb", "minv"),
    ("post stage (reset/refs/metrics)", "minv", "post"),
    ("kernel launch + glue floor", "post", None),
)


def make(key: str, n_steps: int, mpc: MpcConfig, gait: GaitConfig, device):
    """The ``graphed`` function of variant ``key``."""
    flags = VARIANTS[key][1]
    if flags is None:
        return batched_art_rollout_tick_kernel_fn(n_steps, mpc, gait)
    return variant_fn(n_steps, mpc, gait, device, **flags)


def attribution(ms: dict) -> dict:
    """ms a tick of each stage from the five variants' ms a tick: the
    deltas, which sum to ``base``'s."""
    return {line: ms[a] - (ms[b] if b else 0.0) for line, a, b in ATTRIBUTION}


def run(envs: int = N_ENVS, steps: int = N_STEPS, reps: int = h.DEFAULT_REPS,
        variants=tuple(VARIANTS), device="cuda") -> list[dict]:
    """Each variant of ``variants`` at ``envs`` identical standing robots x
    ``steps`` ticks, in turns for ``reps`` rounds -> one record per variant
    (``_harness.graph_record``), then, with all five, the attribution's
    record (``ms``: stage -> ms a tick)."""
    device = entry_device(device)
    mpc, gait = h.fast_art_mpc(), GaitConfig()
    worlds, bipeds = h.art_worlds(mpc, envs, device)
    where = h.card(device)
    with torch.no_grad(), f32_matmul():
        cases = {k: (make(k, steps, mpc, gait, device), (worlds, bipeds)) for k in variants}
        timed = h.time_graphs(cases, steps, reps)
    records = [h.graph_record(TOOL, k, VARIANTS[k][0], timed[k], envs, steps, where)
               for k in variants]
    if set(variants) == set(VARIANTS):
        ms = attribution({k: timed[k]["ms"] for k in variants})
        records.append({"tool": TOOL, "name": "attribution", "envs": envs, "steps": steps,
                        "ms": ms, **where})
    return records


def _line(r: dict, envs: int) -> str:
    if r["name"] == "attribution":
        return f"\nattribution @ {envs} envs:" + "".join(
            f"\n  {line + ':':36s}{ms:7.3f} ms" for line, ms in r["ms"].items())
    return f"{VARIANTS[r['name']][0]}: {r['ms']:7.3f} ms/tick  (capture {r['capture_s']:.1f}s)"


def main(argv=None, device="cuda") -> int:
    """The command (``_harness.main``) and ``BENCH_VARIANTS``."""
    return h.main(TOOL, run, _line, (N_ENVS, N_STEPS), argv, device,
                  variants=os.environ.get("BENCH_VARIANTS", ",".join(VARIANTS)).split(","))


if __name__ == "__main__":
    sys.exit(main())

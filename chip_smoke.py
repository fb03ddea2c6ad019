#!/usr/bin/env python3
"""Smoke run of the torch port (biped_mpc_py_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles ``biped_mpc_py_torch/csrc/qp_admm.cu``,
   ``csrc/substep.cu``, ``csrc/tick.cu``, ``csrc/ruiz.cu`` and
   ``csrc/probe_ops.cu`` for sm_90a from the checkout's sources, in
   parallel, and prints the QP, substep, tick and Ruiz kernels' ``-Xptxas
   -v`` registers, spills and stack;
3. QP kernel vs plain: the fused ADMM QP-solve kernel and its plain PyTorch
   version on the same 1024 real MPC QPs (perturbed standing states at
   every gait phase, domain-randomized robots, cold and warm starts), at
   the bench budget as the JAX bench runs it (``fast_mpc_config()``: the
   three bf16 knobs on; held to the plain version's CPU-vs-card noise floor
   and to the knobs' own effect), then with the knobs off and with the bf16
   NS steps alone (each within 0.05 N on every env), and at the default
   budget; the knobs' effect (kernel at knobs-on against plain at
   knobs-off) reported;
4. SRB slice: 1024 envs x 50 ticks (2 s) of walking through
   ``batched_rollout`` at the bench budget (the bf16 knobs on), with the
   kernel, then with the plain core on the card; launch count, finiteness,
   falls, height, and the walking statistics of the two runs (on the
   population's means: the walks decohere env by env at the knobs); then
   both with the knobs off, the statistics on every env;
5. substep kernel vs plain: the fused articulated-substep kernel and its
   plain version on 1024 and 1000 perturbed in-contact states, 5 substeps
   of 1 ms;
6. articulated slice, substep-kernel path: 1024 envs x 250 ticks (10 s)
   walking at 0.3 m/s through ``batched_art_rollout_kernel`` at the bench
   budget as the JAX bench's ``BENCH_MODE=art`` runs it (the bf16 knobs
   on; 8 low-level periods of 5 substeps per tick, the mass-matrix
   inverse held all tick); launch counts, finiteness, falls and the walking
   bounds (``art_walk_ok``), then the same 250 ticks with the knobs off
   (the bounds on every env); then 3 ticks of the plain substep chain
   (``batched_art_rollout``) from the same worlds against the kernel
   path's first 3, bounded with the knobs off;
7. probe: the four toy CUDA kernels of ``tools/probe_cuda_ops.py`` (asin,
   remainder, nested loop, atan2) against numpy;
8. tick kernel vs plain: the fused tick kernel (low-level control and
   physics of one tick, 8 periods of 5 substeps) and its plain version on
   1024 and 1000 perturbed in-contact envs (1000 leaves lane pairs of the
   last warp without an env) with random clocks, flags and controls; the
   plain version on the CPU against itself on the card as the noise floor;
9. articulated slice, tick-kernel path: the same 1024 envs x 250 ticks
   through ``batched_art_rollout_tick_kernel`` (one tick launch per tick);
   launch counts (250 tick, 250 QP, 0 substep), the walking bounds, the
   same 250 ticks with the knobs off, and the walking statistics after 25
   ticks against the substep-kernel path's;
10. terrain slice: 1024 domain-randomized robots on per-env rough height
   fields (``Terrain.rough_batch``, amplitude 0.03 m, 64 x 64 cells) x 50
   ticks (2 s) through ``batched_art_rollout_terrain`` at the bench budget
   (5 substeps, the mass-matrix inverse held all tick): each tick's
   low-level loop one launch of the tick kernel's field variant.
   Finite states, launch counts (50 QP, 50 tick, 0 substep), the stance
   soles' mean gap to their ground, and falls, distance, attitude and
   residual as reported figures; then on flat per-env fields against no
   terrain: one launch of the field kernel against one of the flat kernel
   within ``SUBSTEP_BOUNDS``, and 3 ticks of the terrain path against
   ``batched_art_rollout`` (the plain chain), the bf16 knobs off, within
   ``CHAIN_BOUNDS``; then on rough per-env fields (the slice's at 1024 envs,
   drawn alike at 4096) one launch of the field kernel against
   ``sim.engine.art_step(..., terrain, Minv=)`` from perturbed in-contact
   states, within ``SUBSTEP_BOUNDS``, ``t`` bit-equal, the ground count
   within 1 of the plain chain's in at most 4 entries; its device time at
   4096 envs beside the plain chain's and its bound -> the kernels line's
   ``fused_substeps_field`` entry; then the tick kernel's field variant
   (``tick_field_check``) at 1024 and 4096 envs on such fields, one tick
   from ``tick_inputs``' states and controls against its plain version
   (the terrain periods of ``_art_tick``), within ``TICK_BOUNDS``, ``t``
   bit-equal, the ground count as above; its device time at 4096 envs
   beside the plain version's and its bound (``bound_tick_field``) -> the
   kernels line's ``fused_tick_field`` entry;
11. per-env commands: 1024 envs x 50 ticks of ``batched_cmd_rollout`` (SRB)
   with each env's forward command spread over 0-0.4 m/s: zero falls, and
   the distance covered ordered with the command;
12. times: the QP solve at the bench budget with the bf16 knobs on and off
   in turns, and at the default budget (also with ``ns_iters=0`` and
   ``n_iters=0``, for the split between the inverse and the ADMM loop,
   with its achieved TFLOP/s, its share of the bound, the TF32 mma.sync
   rate and the bf16 one; CUDA events), the substep, tick and probe kernels (device time from
   ``torch.profiler``: they are shorter than their wrappers' host work, so
   events around wrapper calls would time the host; that figure is printed
   beside it), the physics kernels' device time, bound and share at 1024,
   4096, 16,384 and 65,536 envs, the rollouts' env-steps/s with kernel and
   plain version, and a per-stage split of one SRB tick and of one
   articulated tick on each path, the terrain path's (field kernel) beside
   the flat plain chain's; and the bounds of the JAX package's
   ``tests/test_rollout.py::test_bench_budget_accuracy`` on phase 4's walk
   (bf16 knobs on) against the same worlds at the default budget, on the
   population's means (each env's largest differences reported);
13. profile: one ``torch.profiler`` window of 5 steady tick-path ticks:
   device kernels and device busy per tick, the QP kernel's share of it,
   the tick kernel's time, and the card's idle share of the unprofiled tick
   of phase 9;
14. bounds: each kernel's least time on the card for the same work
   (``utils/roofline.py``), from the shapes of this run's inputs: the QP
   solve's from its budget (its Newton-Schulz products at the 3xTF32
   tensor-core rate, those of the bf16 steps at the bf16 rate), the
   physics kernels' from the tree's per-substep and per-period operation
   counts.
15. sweep: the tick kernel's per-env variant (``tick_table_check``) at
   1024 and 4096 envs, four configs of command, swing, Raibert and heading
   gains among them, one tick from ``tick_inputs``' states and controls
   against its plain version (``fused_tick_reference`` with the same
   ``x_cmd`` and ``per_env``) within ``TICK_BOUNDS``, ``t`` bit-equal; its
   device time at 4096 envs beside the plain version's and its bound
   (``bound_tick_table``) -> the kernels line's ``fused_tick_table``
   entry; then 16 configs (a 4 x 4 grid of ``kp_hipyaw`` x ``kd_hipyaw``
   around the articulated config's, the last cell a repeat of the base
   config) x 64 ``perturbed_worlds`` (seed 0, scale 2e-3) = 1024 envs x 25
   ticks of ``art_sweep`` (one ``dt``, 5 substeps, Minv held all tick: the
   tick path with the per-env variant) at the bench budget with the bf16
   knobs off (its card-vs-CPU check is pointwise): finite states, 25 QP
   and 25 tick launches, the repeated config bit-equal to the base on the
   nominal world, the zero-gain config apart, falls per config and
   env-steps/s reported; 8 of its envs x 2 ticks on the card against the
   same path's plain version on the CPU within ``CHAIN_BOUNDS``;
16. sweep numerics: every dynamic config field per env. 16 configs
   (``raibert_pitch_place`` in 0, 0.1, 0.2, 0.25 with ``raibert_pitch_nom``
   0.12, x ``admm_rho`` in 0.1, 0.3, 1, 3; the last cell a repeat of the
   base cell) x 64 ``perturbed_worlds`` = 1024 envs x 25 ticks of
   ``art_sweep`` at ``art_mpc_config()``'s bench budget: 25 QP launches
   (each env's rho in the kernel) and 25 of the tick kernel's per-env
   variant (each env's Raibert gains), finite, the
   repeated cell bit-equal to its twin, falls per config and env-steps/s
   reported, 8 envs x 2 ticks card vs CPU within ``CHAIN_BOUNDS``; the QP
   kernel on 1024 real QPs (the bench budget, bf16 knobs off) with per-env
   (rho, sigma, alpha) in four groups of 256: within 0.05 N per env of the
   plain version, bit-equal to one scalar launch per group and, with the
   config's values per env, to the scalar launch, timed beside it; per-env ``dt`` (0.03-0.045 s, 4 configs
   x 8 worlds x 10 ticks, the plain chain: no physics launch): finite,
   card vs CPU within ``CHAIN_BOUNDS``, each env's clock bit-equal to its
   config run alone;
17. one robot (N = 1) walking in place for 100 ticks under the controller
   on the card at ``tests/test_mj_contact.py``'s ``ORACLE_MPC``: through
   ``run_mujoco_closed_loop`` where MuJoCo is installed, else through its
   controller, ``sim/mj_driver.py::MjController`` (the loop's feedback,
   solve and low-level calls on three CUDA graphs), against ``EnginePlant``
   (the port's engine on the card as the plant). No fall, the mean total
   stance force after tick 10 within 10% of m g, duty factors 0.5 +- 0.1,
   100 QP launches, ms per tick; 5 ticks with the controller on the card
   against the CPU within ``MJ_BOUNDS``;
18. real-time loop: ``RealtimeLoop`` on the card, 50 ticks as fast as
   possible, then 25 against the 40 ms deadlines: the plant stays up, the
   statistics are coherent, the latencies, misses and ``realtime_ok``
   reported; the same loop on the CPU for 25 ticks as a figure;
19. replay and checkpoint: ``export_rollout`` of 25 ticks (the plain
   chain's graph replayed at N = 1; torso at walking height; its frames
   against an eager loop of ``art_closed_loop_tick`` within
   ``CHAIN_BOUNDS``; reloaded in MuJoCo where it is installed), and 1024
   envs on the tick-kernel path saved at tick 10 and resumed, bit-equal at
   tick 20 to the run straight through;
20. demo: ``python -m biped_mpc_py_torch.demo --compat --rollout-steps 50
   --device cuda`` in a subprocess: exit code 0, the tick's torques against
   the golden tick, the graphed tick's ms and the graphed rollout's
   real-time factor;
21. sharded (``parallel/sharding.py``): (a) one rank over NCCL on the
   card, ``sharded_rollout`` of 1024 envs x 50 SRB ticks and
   ``sharded_art_rollout`` of the articulated worlds x 10 ticks, each
   bit-equal to its unsharded loop, with its launches, step count and zero
   falls, ms per tick beside the unsharded loop's in turns, then
   ``sharded_rollout_fn`` and ``sharded_art_rollout_fn`` (one graph on the
   rank) bit-equal to the eager sharded loops and to the unsharded
   ``*_fn``; (b) two ranks
   sharing the card over gloo, 512 of the same worlds each: the all-reduced
   summary equal to (a)'s and x_fb within 1.5e-3; (c) their DCP shards at
   tick 25 loaded into the one-rank mesh (a reshard), bit-equal to the world
   they gathered, and resumed bit-equal to a one-rank save's resume; save
   and load ms;
22. graphs: the compiled entry points (``batched_rollout_fn``,
   ``batched_art_rollout_tick_kernel_fn``, ``batched_art_rollout_kernel_fn``,
   ``batched_art_rollout_terrain_fn`` (the tick kernel's field variant),
   and on the plain chain ``batched_art_rollout_fn`` and ``art_sweep_fn``:
   one tick captured
   as a CUDA graph and replayed) at 1024 envs and the bench budget (the
   bf16 knobs on, the sweep's off), SRB x 50
   ticks, the tick path x 50, the substep path x 25, the flat plain chain,
   the terrain walk and the 4 x 4 x 64 sweep x 10 each (phases 4, 9, 6, 10
   and 15's configurations): first one eager tick of each path
   under ``torch.cuda.set_sync_debug_mode("error")``; then each replay
   against the eager loop from the same worlds (bit-equal, or within
   ``CHAIN_BOUNDS`` / ``SRB_GRAPH_BOUND`` with the differing leaves named),
   the launch counts of a graph call (counts set to 0 just before it), ms
   per tick in turns (eager, graph, graph, eager), the capture's seconds and
   the graph pool's MB; and one ``torch.profiler`` window of 5 graph ticks
   of the tick path (device kernels, busy ms and the idle share, beside
   phase 13's eager figures) and of 2 graph ticks of the plain chain, the
   terrain walk and the sweep.
23. bench: ``python -m biped_mpc_py_torch.bench``'s ``run`` in process, one
   run each of SRB, SRB with randomized robots, the tick path, the substep
   path, the plain chain and randomized robots on 0.03 m rough terrain at
   1024 envs x 50 ticks, and SRB and the tick path again at 256, 4096 and
   16,384 envs; then the command itself with no variables in a subprocess
   (exactly one stdout line, the SRB headline); the three articulated flat
   paths also with the bf16 knobs off. One ``{"bench": ...}`` line per run;
   each run's launches (per tick: 1 QP solve; the tick path 1 tick, the
   substep and terrain paths 8 substep launches) checked and its states finite; no fall
   on the SRB runs and on the knobs-off articulated ones; the falls of the
   knobs-on articulated runs (identical robots: one trajectory, and a draw,
   ``BENCH_RUNS``' note) and on terrain reported. (b) the three knobs-on
   articulated paths from 1024 starts 1e-6 rad apart: the envs that fell,
   at most twice the JAX package's count on the same starts plus 10. (c)
   the knobs-on substep-path run eagerly, each of its substep launches
   against the plain version on the same inputs.
24. tools: the stage-timing tools of ``biped_mpc_py_torch/tools/``
   (``bench_tick_stages``, ``bench_tick_kernel``, ``bench_stages``,
   ``bench_art_stages``, ``bench_art_probe``, ``bench_cone_kernel``), each
   one's ``run`` in process at 1024 envs, 25 ticks (or 25 calls captured
   per stage) and 2 rounds in turns: one ``{"tools": ...}`` line per
   variant or stage, the tick path's five-line attribution, the time of the
   phase. Gates: finite states on each base variant, each record's kernel
   launches per replay (or per stage call) as its tool's ``LAUNCHES``
   says (``mpc-off``: 0 QP, 1 tick; ``sub1``: 1 tick; the substep path: 1
   QP, 8 substep), the attribution summing to ``base``, and the cone
   solve (m = 280) held to its plain version against the floor measured in
   the same run, the plain solve of the same QPs in float64
   (``bench_cone_kernel.agreement_faults``: the median env, the envs past
   0.1 N, the worst objective excess and the worst constraint violation,
   each within twice the floor's plus a slack). The ablations are
   timing-only: their falls are reported, not bounded.

25. Ruiz kernel vs plain (run after phase 3): the Ruiz kernel
   (``csrc/ruiz.cu``, the stage ``qp.ruiz``) on real MPC QPs at 4096 envs
   and at 1, m = 24 and 28, bf16 and f32 norms, cold and warm, all eleven
   outputs bit-equal to ``ruiz_equilibrate`` + ``scaled_warm_start``; ms a
   call at 4096, 1024 and 1 env beside the plain stage and the bytes bound;
   the tick path (1024 x 50, bf16 norms) and SRB (1024 x 25, the default
   budget, f32 norms) with the stage on the kernel and on the plain
   version, bit-equal, with equal counts of non-finite resets.

Phase 18 runs ``RealtimeLoop``, whose solve and low-level period are two
CUDA graphs replayed at N = 1 (captured by its ``warmup``); phase 17 the
MuJoCo loop's controller on its three graphs, phase 19 the plain chain's
graph at N = 1, phase 20 the demo's graphed tick and rollout.

The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script then exits non-zero without printing a result. It needs one card;
without one it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# EnginePlant lives beside the card tests that step it. Imported by its own
# name: a machine may have another project's ``tests`` package on its path.
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from torch_plants import EnginePlant  # noqa: E402

N_ENVS = 1024
N_TICKS = 50
N_ART_TICKS = 250
SEED = 0
# Kernel vs plain bounds on unscaled controls [N] (see phase_kernel).
BOUND_BENCH = 0.05
BOUND_DEFAULT = 0.1
# The JAX package's three bf16 solver knobs, off.
KNOBS_OFF = dict(kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False)
# Substep kernel vs plain, per field: tests/test_substep_kernel.py:73-76.
SUBSTEP_BOUNDS = {"pos": 5e-7, "quat": 1e-6, "v_base": 5e-6, "q": 1e-6, "qd": 1e-4}
# Tick kernel vs plain, per field (energy: rtol 2e-3, atol 1e-3):
# tests/test_tick_kernel.py:257-261.
TICK_BOUNDS = {"q": 5e-4, "pos": 5e-4, "quat": 5e-4, "qd": 2e-2}
# Ticks after which the tick-kernel and substep-kernel paths are compared
# (tests/test_tick_kernel.py::test_tick_kernel_closed_loop).
N_COMPARE_TICKS = 25
# The terrain slice: 2 s of walking on fields of this amplitude [m] and
# resolution (what the JAX bench's BENCH_TERRAIN path draws).
N_TERRAIN_TICKS = 50
TERRAIN_AMPLITUDE = 0.03
TERRAIN_RES = 64
# Stance soles against their ground [m]: a sole centre rests ~8 mm deep on
# the toe/heel springs (8 kN/m each) and up to twice that under load; a foot
# scheduled down may still be a few mm up.
STANCE_GAP_RANGE = (-0.03, 0.01)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | count {torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def phase_build():
    from biped_mpc_py_torch.ops.cuda import (
        build, qp_kernel, ruiz_kernel, substep_kernel, tick_kernel,
    )
    from biped_mpc_py_torch.tools import probe_cuda_ops

    t0 = time.time()
    paths = build.build(qp_kernel.SOURCE, substep_kernel.SOURCE, tick_kernel.SOURCE,
                        ruiz_kernel.SOURCE, probe_cuda_ops.SOURCE, verbose=True)
    log(f"[build] {', '.join(p.name for p in paths)} in {time.time() - t0:.1f} s")
    for source in (qp_kernel.SOURCE, substep_kernel.SOURCE, tick_kernel.SOURCE,
                   ruiz_kernel.SOURCE):
        for line in build.ptxas_report(source):
            log(f"[build] {source.name} -Xptxas -v: {line}")


def mpc_qps(torch, mpc, n, device, seed):
    """n real MPC QPs: perturbed standing states at every gait phase,
    randomized robots, walking gait."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.control.mpc import build_mpc_qp
    from biped_mpc_py_torch.parallel.rollout import randomize_params

    gen = torch.Generator().manual_seed(seed)
    x = torch.zeros(n, 12)
    x[:, 5] = 0.53
    x += 0.05 * torch.randn(n, 12, generator=gen)
    foot = torch.tensor([-0.02, 0.09, 0.0, -0.02, -0.09, 0.0]).repeat(n, 1)
    foot += 0.01 * torch.randn(n, 6, generator=gen)
    t = (torch.arange(n) % 10).to(torch.float32) * mpc.dt
    biped = randomize_params(gen, n, device=device)
    x, foot, t = x.to(device), foot.to(device), t.to(device)
    gait = GaitConfig()
    return build_mpc_qp(x, t, foot, mpc, biped, contact_sequence(t, mpc, gait), gait)


def solve_both(torch, qp, mpc, warm):
    """Kernel and plain core on the same scaled inputs -> (sol_kernel,
    sol_plain, scaled inputs)."""
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda.qp_kernel import (
        fused_qp_solve, fused_qp_solve_reference,
    )

    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    x0, z0, y0 = tqp.scaled_warm_start(warm, D, E, c, Ph.shape[-1])
    args = (Ph, Ah, qh, lh, uh, x0, z0, y0)
    kw = tqp.solver_args(mpc)
    out_k = fused_qp_solve(*args, **kw)
    torch.cuda.synchronize()
    out_p = fused_qp_solve_reference(*args, **kw)
    return (tqp.recover_solution(qp, *out_k, D, E, c),
            tqp.recover_solution(qp, *out_p, D, E, c), args, kw, (D, E, c))


def bench_budgets():
    """The bench budget (40 ADMM steps, 1 rho phase, no polish, NS 10) in
    three forms: ``bench`` as the JAX bench runs it (``fast_mpc_config()``:
    the 8 bf16 NS steps, the bf16 K^-1 product and the bf16 Ruiz norms),
    ``bench-ns`` with the bf16 NS steps and Ruiz norms only, ``bench-f32``
    with the three knobs off."""
    import dataclasses

    from biped_mpc_py_torch import fast_mpc_config

    on = fast_mpc_config()
    return {"bench": on,
            "bench-ns": dataclasses.replace(on, admm_bf16_matvec=False),
            "bench-f32": dataclasses.replace(on, **KNOBS_OFF)}


def phase_kernel(torch, device):
    """Kernel vs plain on 1024 real QPs, each budget, cold and warm, the
    knobs-on bench budget and the f32 one in turns.

    Bounds on the unscaled controls. ``bench-f32`` and ``bench-ns`` (1
    phase, no polish; f32, or the bf16 NS steps): 0.05 N on every env and
    5e-3 on res_prim. Default budget (3 phases + polish) and ``bench`` (the
    bf16 K^-1 product): the solve is discontinuous in roundoff there. At the
    default budget the polish's active set (|z - bound| < 1e-5) and its
    merit accept/reject flip on last-bit differences; at ``bench`` every
    ADMM step rounds its right-hand side to bf16, and a last-bit difference
    that flips one rounding moves the next iterate by a bf16 step (2^-8 of
    an entry), which the 40 steps carry on. ANY two implementations then
    land apart: about one env in a hundred by tens of N at the default
    budget, half the envs past 0.05 N at ``bench``. This run measures that
    noise floor: the plain version on the CPU against the same plain
    version on the card. The kernel passes if it puts no more envs past the
    bound than twice the noise floor does, plus five, and its median env
    agrees within 0.01 N at the default budget (a wrong phase, re-pick or
    polish moves most envs, and both checks). At ``bench`` the knobs' own
    effect (the plain version at ``bench`` against ``bench-f32``) is tens
    of N an env: the kernel's median env agrees within a twentieth of the
    effect's median, and all but 1% of the envs lie nearer to the plain
    knobs-on solve than half their effect (a misplaced rounding moves most
    envs by the effect). Returns {budget: max |du| over both starts}."""
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda.qp_kernel import fused_qp_solve_reference

    budgets = bench_budgets()
    results = {}
    for budget in ("bench", "bench-f32", "bench-ns", "default"):
        mpc = MpcConfig() if budget == "default" else budgets[budget]
        qp = mpc_qps(torch, mpc, N_ENVS, device, SEED)
        prev = mpc_qps(torch, mpc, N_ENVS, device, SEED + 1)
        warm_start = tqp.solve_qp(prev, mpc)  # the kernel's own previous solve
        for start, warm in (("cold", None), ("warm", warm_start)):
            sol_k, sol_p, args, kw, scaling = solve_both(torch, qp, mpc, warm)
            du = (sol_k.controls - sol_p.controls).abs().flatten(1).amax(1)
            dr = (sol_k.res_prim - sol_p.res_prim).abs()
            bound = BOUND_DEFAULT if budget == "default" else BOUND_BENCH
            row = dict(
                max_du=float(du.max()), p99_du=float(du.quantile(0.99)),
                n_over=int((du > bound).sum()), max_dres=float(dr.max()),
                finite=bool(torch.isfinite(sol_k.controls).all()),
            )
            if budget in ("bench", "default"):
                out_c = fused_qp_solve_reference(*[a.cpu() for a in args], **kw)
                sol_c = tqp.recover_solution(qp, *[o.to(device) for o in out_c], *scaling)
                dn = (sol_c.controls - sol_p.controls).abs().flatten(1).amax(1)
                row.update(
                    median_du=float(du.median()), noise_max=float(dn.max()),
                    noise_p99=float(dn.quantile(0.99)), noise_n_over=int((dn > bound).sum()),
                    noise_median=float(dn.median()),
                )
            if budget == "bench":
                with plain_core():
                    sol_f = tqp.solve_qp(qp, budgets["bench-f32"], warm)
                effect = (sol_f.controls - sol_p.controls).abs().flatten(1).amax(1)
                row.update(effect_median=float(effect.median()),
                           effect_min=float(effect.min()),
                           n_nearer=int((du < 0.5 * effect).sum()))
            results[(budget, start)] = row
            log(f"[kernel] {budget:9s} {start}: " + json.dumps(row))
    for (budget, start), r in results.items():
        if budget in ("bench-f32", "bench-ns"):
            ok = r["finite"] and r["max_du"] < BOUND_BENCH and r["max_dres"] < 5e-3
        else:
            median_bound = 0.05 * r["effect_median"] if budget == "bench" else 0.01
            ok = (r["finite"] and r["median_du"] < median_bound
                  and r["n_over"] <= 2 * r["noise_n_over"] + 5)
        if budget == "bench":
            ok = ok and r["n_nearer"] >= 0.99 * N_ENVS
        if not ok:
            raise AssertionError(f"kernel vs plain past the bound ({budget}, {start}): {r}")
    # the size of the knobs' effect: the kernel's knobs-on solve against the
    # plain version's f32 one (reported, not bounded)
    qp = mpc_qps(torch, budgets["bench"], N_ENVS, device, SEED)
    sol_on = tqp.solve_qp(qp, budgets["bench"])
    with plain_core():
        sol_off = tqp.solve_qp(qp, budgets["bench-f32"])
    d = (sol_on.controls - sol_off.controls).abs().flatten(1).amax(1)
    log(f"[kernel] bf16 knobs' effect, cold, kernel at bench vs plain at bench-f32: max|du| "
        f"{float(d.max()):.3f} N, median {float(d.median()):.3f} N, min {float(d.min()):.3f} N")
    return {b: max(results[(b, s)]["max_du"] for s in ("cold", "warm"))
            for b in ("bench", "bench-f32", "bench-ns", "default")}


# The Ruiz kernel's checks: the envs (the batched cells' 4096 and the
# N = 1 solve graph's 1) by the rows a step (24, or 28 with the torsional
# cone), at the real horizon, both norm precisions, cold and warm.
RUIZ_ENVS = (4096, 1)
RUIZ_TIMED_ENVS = (4096, 1024, 1)
RUIZ_OUTPUTS = ("Ph", "qh", "Ah", "lh", "uh", "D", "E", "c", "x0", "z0", "y0")


def _ruiz_inputs(torch, device, n, m, bf16):
    """(mpc, qp, warm start): n real MPC QPs at the bench budget with the
    norm precision ``bf16`` and m rows a step, and the kernel's own solve of
    other QPs as the warm start."""
    import dataclasses

    from biped_mpc_py_torch import fast_mpc_config
    from biped_mpc_py_torch.ops import qp as tqp

    mpc = dataclasses.replace(fast_mpc_config(mu_z=0.03 if m == 28 else None),
                              ruiz_bf16_norms=bf16)
    qp = mpc_qps(torch, mpc, n, device, SEED + m)
    if qp.l.shape[2] != m:
        raise AssertionError(f"QPs of {qp.l.shape[2]} rows a step, want {m}")
    return mpc, qp, tqp.solve_qp(mpc_qps(torch, mpc, n, device, SEED + m + 1), mpc)


def _fused_ruiz(qp, mpc, warm):
    from biped_mpc_py_torch.ops.cuda.ruiz_kernel import fused_ruiz

    return fused_ruiz(qp.P, qp.q, qp.A_step, qp.l, qp.u,
                      None if warm is None else (warm.controls, warm.z, warm.y),
                      n_iters=mpc.ruiz_iters, bf16_norms=mpc.ruiz_bf16_norms)


def bound_ruiz(qp, mpc, warm, out):
    """(bound ms, what sets it) of one Ruiz launch: bytes of the QP and the
    warm start read and of the eleven outputs written; operations of the
    ``ruiz_iters`` + 1 column passes over |P| D (a product and a maximum an
    element), the A-side norms alike and the three products an element of
    Ph."""
    from biped_mpc_py_torch.utils import roofline

    n_env, h, m = qp.l.shape
    n = 12 * h
    ops = n_env * ((mpc.ruiz_iters + 1) * 2 * (n * n + 2 * h * m * 12) + 3 * n * n)
    warm_in = () if warm is None else (warm.controls, warm.z, warm.y)
    return roofline.bound_ms(ops, roofline.tensor_bytes(qp.P, qp.q, qp.A_step, qp.l, qp.u,
                                                        warm_in, out))


def _nonfinite_run(torch, device, run, plain):
    """``run()`` with the stage qp.ruiz on the Ruiz kernel, or on its plain
    version (``plain``) -> (result, Ruiz launches, non-finite resets)."""
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda import ruiz_kernel
    from biped_mpc_py_torch.utils import profiling

    saved = tqp.scale_qp
    if plain:
        tqp.scale_qp = tqp.scale_qp_reference
    try:
        launches, resets = ruiz_kernel.fused_ruiz.launches, profiling.nonfinite_resets(device)
        out = run()
        torch.cuda.synchronize()
        return (out, ruiz_kernel.fused_ruiz.launches - launches,
                profiling.nonfinite_resets(device) - resets)
    finally:
        tqp.scale_qp = saved


def phase_ruiz(torch, device):
    """Phase 25: the Ruiz kernel (``ops/cuda/ruiz_kernel.py::fused_ruiz``)
    against its plain version (``ops/qp.py::scale_qp_reference``:
    ``ruiz_equilibrate``, then ``scaled_warm_start``) on the card.

    (a) Real MPC QPs at 4096 envs and at 1, h = 10, m = 24 and 28, bf16
    and f32 norms, cold and warm (the kernel's own solve of other QPs):
    one launch a call, and all eleven outputs bit-equal to the plain
    version's (0 ulps; the kernel adds the one sum, gamma's mean, in the
    order of torch.mean on the card, ``csrc/ruiz.cu``). (b) ms a call at
    4096, 1024 and 1 env (warm, m = 24; CUDA events), the plain stage's
    beside it, and the bound from the launch's bytes. (c) Rollouts with the
    stage on the kernel and on the plain version from the same worlds: the
    tick-kernel path (1024 envs x 50 ticks, the bench budget, bf16 norms)
    and SRB (1024 envs x 25 ticks, the default budget, f32 norms), each
    bit-equal leaf by leaf, one Ruiz launch a tick against none, and the
    same count of envs reset for a non-finite state
    (``utils/profiling.py::nonfinite_resets``). -> the kernels line's
    figures."""
    import dataclasses

    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda import ruiz_kernel
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_tick_kernel
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils.graphs import leaves

    worst = {"max_abs_err": 0.0, "max_ulps": 0}
    for n in RUIZ_ENVS:
        for m in (24, 28):
            for bf16 in (True, False):
                mpc, qp, warm_sol = _ruiz_inputs(torch, device, n, m, bf16)
                for start, warm in (("cold", None), ("warm", warm_sol)):
                    want = tqp.scale_qp_reference(qp, mpc, warm)
                    before = ruiz_kernel.fused_ruiz.launches
                    got = _fused_ruiz(qp, mpc, warm)
                    torch.cuda.synchronize()
                    if ruiz_kernel.fused_ruiz.launches != before + 1:
                        raise AssertionError("fused_ruiz did not count its one launch")
                    row = {}
                    for name, a, b in zip(RUIZ_OUTPUTS, got, want, strict=True):
                        if a.shape != b.shape:
                            raise AssertionError(f"Ruiz {name}: {tuple(a.shape)} vs "
                                                 f"{tuple(b.shape)}")
                        ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
                        row[name] = (float((a - b).abs().max()), int(ulps.max()))
                    err = max(v[0] for v in row.values())
                    ulp = max(v[1] for v in row.values())
                    finite = all(bool(torch.isfinite(t).all()) for t in got)
                    norms = "bf16" if bf16 else "f32"
                    log(f"[ruiz] {n} envs, m {m}, {norms} norms, {start}: max|diff| {err:.3e}, "
                        f"max ulps {ulp}, finite {finite}")
                    if ulp or not finite:
                        raise AssertionError(f"Ruiz kernel vs plain ({n} envs, m {m}, {norms} "
                                             f"norms, {start}): (max|diff|, ulps) {row}")
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    worst["max_ulps"] = max(worst["max_ulps"], ulp)

    times = {}
    for n in RUIZ_TIMED_ENVS:
        for bf16 in (True, False):
            mpc, qp, warm = _ruiz_inputs(torch, device, n, 24, bf16)
            ms = _timed(torch, lambda: _fused_ruiz(qp, mpc, warm), 20)
            plain_ms = _timed(torch, lambda: tqp.scale_qp_reference(qp, mpc, warm), 5)
            bound, by = bound_ruiz(qp, mpc, warm, _fused_ruiz(qp, mpc, warm))
            times[(n, bf16)] = (ms, plain_ms, bound, by)
            log(f"[ruiz] {n} envs, {'bf16' if bf16 else 'f32'} norms, warm: kernel {ms:.4f} ms, "
                f"plain stage {plain_ms:.4f} ms ({plain_ms / ms:.1f}x); bound {bound:.4f} ms "
                f"({by}, share {bound / ms:.3f})")

    mpc, gait = _art_config()
    model = hector_model(device=device)
    w0, bipeds = art_worlds(torch, device)
    default = dataclasses.replace(MpcConfig(), x_cmd=WALK_CMD)
    runs = {
        "tick path": (N_TICKS, lambda: batched_art_rollout_tick_kernel(
            w0, bipeds, N_TICKS, mpc, gait, model=model)),
        "srb default": (N_COMPARE_TICKS, lambda: run_rollout(
            torch, device, N_COMPARE_TICKS, default)[0]),
    }
    launches = {}
    for label, (ticks, run) in runs.items():
        w_k, launches_k, resets_k = _nonfinite_run(torch, device, run, plain=False)
        launches[label] = launches_k
        w_p, launches_p, resets_p = _nonfinite_run(torch, device, run, plain=True)
        same = [torch.equal(a, b) for a, b in zip(leaves(w_k), leaves(w_p), strict=True)]
        log(f"[ruiz] {label}, {N_ENVS} envs x {ticks} ticks, Ruiz kernel vs plain: "
            f"{sum(same)} of {len(same)} leaves bit-equal, Ruiz launches {launches_k} vs "
            f"{launches_p}, non-finite resets {resets_k} vs {resets_p}, falls "
            f"{float(w_k.metrics.falls.sum())} vs {float(w_p.metrics.falls.sum())}")
        if not all(same) or (launches_k, launches_p) != (ticks, 0) or resets_k != resets_p:
            raise AssertionError(f"{label}: the Ruiz kernel's rollout differs from the plain "
                                 "version's")
    ms, plain_ms, bound, by = times[(RUIZ_TIMED_ENVS[0], True)]
    ms_f32, plain_ms_f32, bound_f32, _ = times[(RUIZ_TIMED_ENVS[0], False)]
    return worst | {"launches": launches["tick path"], "ms": ms, "plain_ms": plain_ms,
                    "bound": (bound, by), "ms_f32": ms_f32, "plain_ms_f32": plain_ms_f32,
                    "bound_ms_f32": bound_f32}


WALK_CMD = (0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0)  # 0.3 m/s forward


def _walk_config():
    from biped_mpc_py_torch import fast_mpc_config

    return fast_mpc_config(x_cmd=WALK_CMD)


def run_rollout(torch, device, n_ticks, mpc=None):
    """1024 randomized robots walking at 0.3 m/s from standing (bench
    budget unless ``mpc`` says otherwise) -> (final worlds, seconds)."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.parallel.rollout import (
        batch_worlds, batched_rollout, randomize_params,
    )

    mpc = mpc or _walk_config()
    worlds = batch_worlds(mpc, N_ENVS, device=device)
    bipeds = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = batched_rollout(worlds, bipeds, n_ticks, mpc, GaitConfig())
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def plain_core():
    """Inside the block, the rollouts' QP solve runs through the plain
    version on the card (for the comparison runs only)."""
    from biped_mpc_py_torch.tools import _harness

    return _harness.plain_core()


def walk_stats(w):
    m = w.metrics
    n = m.n_steps
    return dict(
        x=w.sim.x_fb[:, 3], y=w.sim.x_fb[:, 4], z=w.sim.x_fb[:, 5],
        att_rms=(m.attitude_err_sq / n).sqrt(), vel_rms=(m.vel_err_sq / n).sqrt(),
    )


def _walk_against_plain(torch, device, w_k, mpc, per_env):
    """The plain core's walk at ``mpc`` from phase 4's worlds against the
    kernel's ``w_k``, with the bounds of tests/test_rollout.py::
    test_bench_budget_accuracy: on every env (``per_env``: |d distance| <
    0.15 m, |d height| < 0.02 m) or on the population's means (the walks
    decohere env by env at the bf16 knobs, see phase_kernel); the mean
    attitude RMS within 1.2x + 1e-3 and velocity RMS within 1.2x + 5e-3,
    no lateral drift past 0.3 m. -> the plain core's seconds."""
    from biped_mpc_py_torch.ops.cuda import qp_kernel

    before = qp_kernel.fused_qp_solve.launches
    with plain_core():
        run_rollout(torch, device, 2, mpc)
        w_p, sec_p = run_rollout(torch, device, N_TICKS, mpc)
    if qp_kernel.fused_qp_solve.launches != before:
        raise AssertionError("the plain-core run launched the kernel")
    sk, sp = walk_stats(w_k), walk_stats(w_p)
    dx = float((sk["x"] - sp["x"]).abs().max())
    dz = float((sk["z"] - sp["z"]).abs().max())
    dx_mean = abs(float(sk["x"].mean()) - float(sp["x"].mean()))
    dz_mean = abs(float(sk["z"].mean()) - float(sp["z"].mean()))
    att_k, att_p = float(sk["att_rms"].mean()), float(sp["att_rms"].mean())
    vel_k, vel_p = float(sk["vel_rms"].mean()), float(sp["vel_rms"].mean())
    knobs = "bf16 knobs on" if mpc.admm_bf16_matvec else "bf16 knobs off"
    log(f"[slice] plain core ({knobs}): {sec_p:.3f} s, falls {float(w_p.metrics.falls.sum())}; "
        f"kernel vs plain: max|dx| {dx:.2e} m, max|dz| {dz:.2e} m, "
        f"distance {float(sk['x'].mean()):.4f} vs {float(sp['x'].mean()):.4f} m, "
        f"height {float(sk['z'].mean()):.4f} vs {float(sp['z'].mean()):.4f} m, "
        f"att RMS {att_k:.5f} vs {att_p:.5f}, vel RMS {vel_k:.5f} vs {vel_p:.5f}, "
        f"max|y| {float(sk['y'].abs().max()):.4f}")
    dx, dz = (dx, dz) if per_env else (dx_mean, dz_mean)
    if not (dx < 0.15 and dz < 0.02 and att_k < 1.2 * att_p + 1e-3
            and vel_k < 1.2 * vel_p + 5e-3 and float(sk["y"].abs().max()) < 0.3):
        raise AssertionError(f"kernel and plain-core walks differ ({knobs})")
    return sec_p


def phase_slice(torch, device):
    """Phase 4: the SRB walk at the bench budget as the JAX bench runs it
    (the bf16 knobs on), then its plain-core walk (population bounds), then
    both with the knobs off (bounds on every env). -> (launches, kernel s,
    plain-core s, the kernel's knobs-on worlds)."""
    import dataclasses

    from biped_mpc_py_torch.ops.cuda import qp_kernel

    run_rollout(torch, device, 2)  # warm-up
    qp_kernel.fused_qp_solve.launches = 0
    w_k, sec_k = run_rollout(torch, device, N_TICKS)
    launches = qp_kernel.fused_qp_solve.launches
    x = w_k.sim.x_fb
    falls = float(w_k.metrics.falls.sum())
    finite = bool(torch.isfinite(x).all() and torch.isfinite(w_k.sim.foot).all())
    z_lo, z_hi = float(x[:, 5].min()), float(x[:, 5].max())
    log(f"[slice] kernel: {N_ENVS} envs x {N_TICKS} ticks in {sec_k:.3f} s, "
        f"launches {launches}, falls {falls}, finite {finite}, "
        f"height [{z_lo:.4f}, {z_hi:.4f}], res_prim max {float(w_k.metrics.res_prim_max.max()):.3e}")
    if launches != N_TICKS:
        raise AssertionError(f"kernel launched {launches} times in {N_TICKS} ticks")
    if not finite or falls != 0 or not (0.4 < z_lo and z_hi < 0.65):
        raise AssertionError("slice run failed its checks")
    sec_p = _walk_against_plain(torch, device, w_k, _walk_config(), per_env=False)

    f32 = dataclasses.replace(_walk_config(), **KNOBS_OFF)
    w_f, sec_f = run_rollout(torch, device, N_TICKS, f32)
    log(f"[slice] kernel (bf16 knobs off): {sec_f:.3f} s, falls {float(w_f.metrics.falls.sum())}, "
        f"res_prim max {float(w_f.metrics.res_prim_max.max()):.3e}")
    _walk_against_plain(torch, device, w_f, f32, per_env=True)
    return launches, sec_k, sec_p, w_k


def time_default_rollouts(torch, device):
    """The rollout's rate at the default budget (3 phases + polish, NS
    14), kernel and plain core, each after a warm-up."""
    import contextlib

    from biped_mpc_py_torch import MpcConfig

    mpc = MpcConfig(x_cmd=WALK_CMD)
    worlds = {}
    for label, route in (("kernel", contextlib.nullcontext), ("plain core", plain_core)):
        with route():
            run_rollout(torch, device, 2, mpc)
            w, sec = run_rollout(torch, device, N_TICKS, mpc)
        if not bool(torch.isfinite(w.sim.x_fb).all()):
            raise AssertionError("default-budget rollout produced non-finite states")
        log(f"[times] rollout default budget, {label}: "
            f"{N_ENVS * N_TICKS / sec:.1f} env-steps/s ({sec * 1e3 / N_TICKS:.3f} ms/tick), "
            f"falls {float(w.metrics.falls.sum())}")
        worlds[label] = w
    return worlds["kernel"]


def phase_bench_accuracy(w_bench, w_default):
    """The bounds of the JAX package's tests/test_rollout.py::
    test_bench_budget_accuracy (:109-127) on the card: phase 4's SRB walk
    at the bench budget as the JAX bench runs it (``fast_mpc_config()``,
    the bf16 knobs on) against the same worlds at the default budget
    (``time_default_rollouts``' kernel run), 1024 envs x 50 ticks. The test
    bounds one nominal robot's walk; here they bound the population of 1024
    randomized robots: zero falls, the mean distance within 0.15 m and the
    mean height within 0.02 m, the mean attitude RMS within 1.2x + 1e-3 and
    velocity RMS within 1.2x + 5e-3, no lateral drift past 0.3 m, the mean
    res_prim max under 1.0. Each env's largest differences are reported:
    the JAX package's own bench budget puts some envs past the per-env
    reading at this size (``python -m tests.jax_bench_accuracy``)."""
    sb, sd = walk_stats(w_bench), walk_stats(w_default)
    dx_env, dz_env = (sb["x"] - sd["x"]).abs(), (sb["z"] - sd["z"]).abs()
    dx = abs(float(sb["x"].mean()) - float(sd["x"].mean()))
    dz = abs(float(sb["z"].mean()) - float(sd["z"].mean()))
    att_b, att_d = float(sb["att_rms"].mean()), float(sd["att_rms"].mean())
    vel_b, vel_d = float(sb["vel_rms"].mean()), float(sd["vel_rms"].mean())
    falls = float(w_bench.metrics.falls.sum())
    y_max = max(float(sb["y"].abs().max()), float(sd["y"].abs().max()))
    res = w_bench.metrics.res_prim_max
    log(f"[accuracy] bench (bf16 knobs on) vs default budget, {N_ENVS} envs x {N_TICKS} ticks: "
        f"falls {falls}; means: |d distance| {dx:.4f} m (< 0.15), |d height| {dz:.4f} m "
        f"(< 0.02), att RMS {att_b:.5f} vs {att_d:.5f}, vel RMS {vel_b:.5f} vs {vel_d:.5f}, "
        f"res_prim max {float(res.mean()):.4f} (< 1.0); max|y| {y_max:.4f} m; per env "
        f"(reported): max|d distance| {float(dx_env.max()):.4f} m ({int((dx_env > 0.15).sum())} "
        f"past 0.15), max|d height| {float(dz_env.max()):.4f} m ({int((dz_env > 0.02).sum())} "
        f"past 0.02), res_prim max {float(res.max()):.4f} ({int((res >= 1.0).sum())} at 1.0 "
        f"or more)")
    if not (falls == 0 and dx < 0.15 and dz < 0.02 and att_b < 1.2 * att_d + 1e-3
            and vel_b < 1.2 * vel_d + 5e-3 and y_max < 0.3 and float(res.mean()) < 1.0):
        raise AssertionError("the bench budget misses test_bench_budget_accuracy's bounds")


def _timed(torch, fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, kernels, reps):
    """Mean device ms per launch of the kernels whose names contain each
    entry of ``kernels`` -> one figure per entry, over a window of ``reps``
    calls of ``fn`` after one warm-up: the device's own record
    (``torch.profiler``), so the host's time to check, allocate and launch
    is not in it. ``fn`` launches each named kernel once per call. The
    trace can lose launches at the window's edges (49 of 50 seen, once
    none), so the mean is over the launches it holds, at least half of
    ``reps``; a window with fewer is run again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [[e.time_range.end - e.time_range.start for e in dev if k in e.name]
                 for k in kernels]
        if all(reps <= 2 * len(s) <= 2 * reps for s in spans):
            return [sum(s) / 1e3 / len(s) for s in spans]
    raise AssertionError(f"the profiler saw {[len(s) for s in spans]} launches of {kernels} "
                         f"in {reps} calls")


def qp_mma_flops(n_env, h, ns_iters, inverses, bf16_iters=0):
    """(TF32, bf16) operations the QP kernel issues on the tensor cores
    (csrc/qp_admm.cu::matmul): each NS step after the first is two
    products; the first ``bf16_iters`` steps one bf16 mma.sync m16n8k16 per
    tile over k-steps of 16, the others 3 TF32 mma.sync m16n8k8 passes (4
    in the last 2 steps) over k-steps of 8; 16-row tiles padded to 128
    rows."""
    n = 12 * h
    m_tiles, n_tiles = -(-n // 16), -(-n // 8)
    tf32 = bf16 = 0
    for it in range(1, ns_iters):
        if it < bf16_iters:
            bf16 += 2 * m_tiles * n_tiles * -(-n // 16) * 2 * 16 * 8 * 16
        else:
            passes = 4 if it >= ns_iters - 2 else 3
            tf32 += 2 * passes * m_tiles * n_tiles * n_tiles * 2 * 16 * 8 * 8
    return n_env * inverses * tf32, n_env * inverses * bf16


def time_solves(torch, device):
    """Per-tick solve time at the main path's shapes: 1024 envs, the bench
    budget with the bf16 knobs on (as the JAX bench runs it) and off, in
    turns (on, off, off, on), and the default budget; CUDA events over
    repeated launches; the kernel also with no Newton-Schulz steps
    (``ns_iters=0``) and with one ADMM step per phase (``n_iters=0``), for
    the split between the inverse and the ADMM loop, and at the bench
    budget with every NS step in bf16 (``bf16_iters=ns_iters``). Prints each
    full-budget solve's achieved TFLOP/s, its share of its bound (the
    tensor-core floor, ``utils/roofline.py``) and of the f32 bound outside
    the tensor cores, and the rates of the kernel's TF32 mma.sync (the f32
    bench's NS time) and bf16 mma.sync (the all-bf16 NS time) over the time
    their NS products add (full - ``ns_iters=0``). Returns {budget: (kernel
    ms, plain ms, bound ms, what sets it)}, the knobs-on bench as "bench",
    the knobs-off one as "bench-f32"."""
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda.qp_kernel import (
        fused_qp_solve, fused_qp_solve_reference,
    )
    from biped_mpc_py_torch.utils import roofline

    def timed(fn, args, kw, reps):
        return _timed(torch, lambda: fn(*args, **kw), reps)

    budgets = bench_budgets()
    inputs = {}
    for budget in ("bench", "bench-f32", "default"):
        mpc = MpcConfig() if budget == "default" else budgets[budget]
        qp = mpc_qps(torch, mpc, N_ENVS, device, SEED)
        Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
        inputs[budget] = ((Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1])),
                          tqp.solver_args(mpc))
    ms = {b: {"full": [], "ns0": [], "it0": []} for b in inputs}
    for budget in ("bench", "bench-f32", "bench-f32", "bench", "default"):
        args, kw = inputs[budget]
        ms[budget]["full"].append(timed(fused_qp_solve, args, kw, 20))
        ms[budget]["ns0"].append(timed(fused_qp_solve, args, {**kw, "ns_iters": 0}, 20))
        ms[budget]["it0"].append(timed(fused_qp_solve, args, {**kw, "n_iters": 0}, 20))
    args, kw = inputs["bench"]
    ms_all_bf16 = timed(fused_qp_solve, args, {**kw, "bf16_iters": kw["ns_iters"]}, 20)
    out = {}
    for budget, (args, kw) in inputs.items():
        ms_k, ms_ns0, ms_it0 = (sum(v) / len(v) for v in ms[budget].values())
        ms_p = timed(fused_qp_solve_reference, args, kw, 5)
        h, m = args[1].shape[1:3]
        work = roofline.qp_solve_work(N_ENVS, h, m, **kw)
        bound, by = roofline.qp_solve_bound_ms(work)
        f32_bound, _ = roofline.bound_ms(work["flops"], work["bytes"])
        inverses = kw["n_phases"] + int(bool(kw["polish"]))
        tf32, bf16 = qp_mma_flops(N_ENVS, h, kw["ns_iters"], inverses, kw["bf16_iters"])
        out[budget] = (ms_k, ms_p, bound, by)
        turns = ", ".join(f"{t:.4f}" for t in ms[budget]["full"])
        log(f"[times] solve {budget:9s} ({N_ENVS} envs): kernel {ms_k:.4f} ms ({turns}), plain "
            f"{ms_p:.3f} ms; kernel with ns_iters=0 {ms_ns0:.4f} ms (NS {ms_k - ms_ns0:.4f} ms), "
            f"with n_iters=0 {ms_it0:.4f} ms; {work['flops'] / ms_k / 1e9:.2f} TFLOP/s; bound "
            f"(tensor-core floor) {bound:.4f} ms ({by}, share {bound / ms_k:.3f}), f32 bound "
            f"{f32_bound:.4f} ms (share {f32_bound / ms_k:.3f}); mma.sync issued: TF32 "
            f"{tf32 / 1e9:.1f} GFLOP, bf16 {bf16 / 1e9:.1f} GFLOP")
        if budget == "bench-f32":
            log(f"[times] TF32 mma.sync rate (bench-f32 NS products): {tf32 / 1e9:.1f} GFLOP in "
                f"{ms_k - ms_ns0:.4f} ms: {tf32 / (ms_k - ms_ns0) / 1e9:.1f} TFLOP/s")
    args, kw = inputs["bench"]
    h = args[1].shape[1]
    _, bf16_all = qp_mma_flops(N_ENVS, h, kw["ns_iters"], 1, kw["ns_iters"])
    ns0 = sum(ms["bench"]["ns0"]) / len(ms["bench"]["ns0"])
    log(f"[times] bf16 mma.sync rate (bench with every NS step in bf16: {ms_all_bf16:.4f} ms): "
        f"{bf16_all / 1e9:.1f} GFLOP in {ms_all_bf16 - ns0:.4f} ms: "
        f"{bf16_all / (ms_all_bf16 - ns0) / 1e9:.1f} TFLOP/s")
    return out


def bound_substep(torch, device, n=N_ENVS):
    """(bound ms, what sets it) of one 5-substep call at ``n`` envs: the
    operations derived from the tree's shapes (``utils/roofline.py``); bytes
    of the state, torques, Minv and model read and the state written."""
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils import roofline

    state, tau = perturbed_art_states(torch, n, SEED)
    model = hector_model(device=device)
    sc, tc = state.to(device), tau.to(device)
    Minv = mass_matrix_inv(model, sc.q)
    return roofline.bound_ms(roofline.substep_ops(n, 5),
                             roofline.tensor_bytes(sc, tc, Minv, model, sc))


def bound_tick(torch, device, n=N_ENVS):
    """(bound ms, what sets it) of one tick call at ``n`` envs (8 periods of
    5 substeps), counted as for the substep call on the tick kernel's inputs
    and outputs (the state and the energy)."""
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils import roofline

    model = hector_model(device=device)
    state, args = tick_inputs(torch, n, SEED)
    sc, ac = state.to(device), [a.to(device) for a in args]
    Minv = mass_matrix_inv(model, sc.q)
    return roofline.bound_ms(roofline.tick_ops(n, 8, 5),
                             roofline.tensor_bytes(sc, ac, Minv, model, sc, sc.t))  # energy: (N,) as t


def bound_probe(torch, device):
    """(bound ms, what sets it) of the probe's four launches: per element,
    asin 4 operations (scale, clip, asin), remainder 1, the nested loop 8 x
    (5 x 3 + 1), atan2 1; bytes of the inputs each op reads and the output
    it writes."""
    from biped_mpc_py_torch.tools import probe_cuda_ops as probe
    from biped_mpc_py_torch.utils import roofline

    n = probe.inputs()[0].size
    return roofline.bound_ms(n * (4 + 1 + 8 * (5 * 3 + 1) + 1), 4 * n * (2 + 2 + 2 + 3))


def time_stages(torch, device):
    """One tick split into its stages (host clock, synchronized), mean of
    10 ticks along a walking rollout at the bench budget."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.control.controller import advance_cmd_ref, advance_v_int
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.control.mpc import build_mpc_qp
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.parallel.rollout import (
        _finish_tick, batch_worlds, randomize_params,
    )
    from biped_mpc_py_torch.sim.srb_sim import srb_step
    from biped_mpc_py_torch.utils.precision import f32_matmul

    mpc, gait = _walk_config(), GaitConfig()
    w = batch_worlds(mpc, N_ENVS, device=device)
    biped = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
    names = ("references+linearize+condense", "ruiz", "solve (kernel)", "unscale",
             "srb step+reset+metrics")
    acc = dict.fromkeys(names, 0.0)
    with torch.no_grad(), f32_matmul():
        for tick in range(12):
            marks = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            sim = w.sim
            contact = contact_sequence(sim.t, mpc, gait)
            qp = build_mpc_qp(sim.x_fb, sim.t, sim.foot, mpc, biped, contact, gait,
                              w.ctrl.cmd_ref, v_int=w.ctrl.v_int)
            mark()
            Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters,
                                                               mpc.ruiz_bf16_norms)
            x0, z0, y0 = tqp.scaled_warm_start(w.ctrl.qp, D, E, c, Ph.shape[-1])
            mark()
            x, z, y = tqp.fused_qp_solve(Ph, Ah, qh, lh, uh, x0, z0, y0, **tqp.solver_args(mpc))
            mark()
            sol = tqp.recover_solution(qp, x, z, y, D, E, c)
            mark()
            sim_new = srb_step(sim, sol.controls[:, 0], mpc, gait, biped)
            w = _finish_tick(sim_new, sol, advance_cmd_ref(w.ctrl.cmd_ref, sim.x_fb, mpc),
                             w.metrics, mpc, advance_v_int(w.ctrl.v_int, sim.x_fb, mpc))
            mark()
            if tick >= 2:
                for name, a, b in zip(names, marks, marks[1:]):
                    acc[name] += (b - a) * 1e3 / 10
    total = sum(acc.values())
    log("[times] tick stages (ms, mean of 10): " + ", ".join(
        f"{k} {v:.3f}" for k, v in acc.items()) + f", total {total:.3f}")


def perturbed_art_states(torch, n, seed):
    """n near-standing articulated states with the soles pushed into the
    plane, and random torques, from a numpy seed (as
    tests/test_substep_kernel.py::_perturbed_states builds them)."""
    import numpy as np

    from biped_mpc_py_torch.sim.engine import ArtState

    rng = np.random.default_rng(seed)
    base = ArtState.standing()
    pos = base.pos.numpy() + 0.02 * rng.normal(size=(n, 3))
    pos[:, 2] -= 0.03
    quat = base.quat.numpy() + 0.02 * rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    state = ArtState(
        pos=f32(pos), quat=f32(quat), v_base=f32(0.3 * rng.normal(size=(n, 6))),
        q=f32(base.q.numpy() + 0.05 * rng.normal(size=(n, 10))),
        qd=f32(0.5 * rng.normal(size=(n, 10))), t=torch.zeros(n),
    )
    return state, f32(5.0 * rng.normal(size=(n, 10)))


def phase_substep_kernel(torch, device):
    """The substep kernel vs its plain version on the card, 1024 and 1000
    perturbed in-contact envs (1000 leaves lane pairs of the last warp
    without an env), dt 5 ms in 5 substeps, held to SUBSTEP_BOUNDS. The
    plain version on the CPU against itself on the card is printed as the
    noise floor between two f32 implementations. Returns the largest field
    error."""
    from biped_mpc_py_torch.ops.cuda.substep_kernel import (
        fused_substeps, fused_substeps_reference,
    )
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    model = hector_model(device=device)
    worst = 0.0
    for n in (N_ENVS, 1000):
        state, tau = perturbed_art_states(torch, n, SEED)
        sc, tc = state.to(device), tau.to(device)
        Minv = mass_matrix_inv(model, sc.q)
        out_k = fused_substeps(model, sc, tc, Minv, 0.005, 5)
        torch.cuda.synchronize()
        out_p = fused_substeps_reference(model, sc, tc, Minv, 0.005, 5)
        errs = {k: float((getattr(out_k, k) - getattr(out_p, k)).abs().max())
                for k in SUBSTEP_BOUNDS}
        finite = all(bool(torch.isfinite(getattr(out_k, k)).all()) for k in SUBSTEP_BOUNDS)
        line = f"[substep] {n} envs: kernel vs plain max|err| {json.dumps(errs)}"
        if n == N_ENVS:
            out_c = fused_substeps_reference(hector_model(device="cpu"), state, tau, Minv.cpu(),
                                             0.005, 5)
            noise = {k: float((getattr(out_c, k).to(device) - getattr(out_p, k)).abs().max())
                     for k in SUBSTEP_BOUNDS}
            line += f"; plain CPU vs plain card {json.dumps(noise)}"
        log(line + f"; bounds {json.dumps(SUBSTEP_BOUNDS)}; finite {finite}")
        bad = [k for k, e in errs.items() if not e < SUBSTEP_BOUNDS[k]]
        if bad or not finite or not torch.equal(out_k.t, out_p.t):
            raise AssertionError(f"substep kernel vs plain past the bounds at {n} envs: {bad}")
        worst = max(worst, *errs.values())
    return worst


def _art_config():
    """The articulated bench budget as the JAX bench's ``BENCH_MODE=art``
    runs it (``bench.py:131-157``): 40 ADMM steps, 1 rho phase, no polish,
    NS 10, and the three bf16 knobs on."""
    from biped_mpc_py_torch.parallel.rollout_art import art_config_for_speed

    return art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                admm_polish=False, kinv_ns_iters=10, kinv_bf16_iters=8,
                                admm_bf16_matvec=True, ruiz_bf16_norms=True)


def art_worlds(torch, device):
    """1024 standing worlds, each env's joint velocities desynced by
    0.01 rad/s from a seeded generator, and their robots."""
    import dataclasses

    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.parallel.rollout_art import init_art_world

    mpc, _ = _art_config()
    w = init_art_world(mpc, N_ENVS, device=device)
    gen = torch.Generator().manual_seed(SEED)
    qd = w.sim.qd + (0.01 * torch.randn(N_ENVS, 10, generator=gen)).to(device)
    w = dataclasses.replace(w, sim=dataclasses.replace(w.sim, qd=qd))
    return w, BipedParams().expand(N_ENVS).to(device)


def art_walk_ok(torch, w, knobs_on):
    """The walking bounds of tests/test_rollout_art.py::
    test_articulated_bench_budget_accuracy on every env of ``w``: finite,
    no fall, past 1.5 m, attitude RMS under 0.08, res_prim max under 1.0.
    That test runs the bench budget with the bf16 knobs off; with them on
    (``knobs_on``) the bf16 K^-1 product lifts a few envs' residual past
    1.0 (the JAX package's SRB bench budget too:
    ``python -m tests.jax_bench_accuracy``), and the residual bound applies
    to the population's mean of res_prim max. -> (ok, summary line)."""
    s, m = w.sim, w.metrics
    finite = all(bool(torch.isfinite(t).all()) for t in (s.pos, s.quat, s.v_base, s.q, s.qd))
    falls = float(m.falls.sum())
    att = (m.attitude_err_sq / m.n_steps).sqrt()
    x_min, att_max = float(s.pos[:, 0].min()), float(att.max())
    res_max, res_mean = float(m.res_prim_max.max()), float(m.res_prim_max.mean())
    ok = finite and falls == 0 and x_min > 1.5 and att_max < 0.08 and (
        res_mean < 1.0 if knobs_on else res_max < 1.0)
    line = (f"falls {falls}, finite {finite}, x min {x_min:.4f} mean "
            f"{float(s.pos[:, 0].mean()):.4f} m, att RMS max {att_max:.5f} mean "
            f"{float(att.mean()):.5f}, res_prim max {res_max:.3e} (mean {res_mean:.3e}, "
            f"{int((m.res_prim_max >= 1.0).sum())} envs at 1.0 or more), height "
            f"[{float(s.pos[:, 2].min()):.4f}, {float(s.pos[:, 2].max()):.4f}]")
    return ok, line


def art_walk_knobs_off(torch, device, entry, w0, bipeds, label):
    """``entry`` (an articulated kernel path) at ``_art_config()`` with the
    bf16 knobs off, 250 ticks from ``w0``: the walking bounds on every env,
    as tests/test_rollout_art.py::test_articulated_bench_budget_accuracy
    holds that budget."""
    import dataclasses

    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    mpc = dataclasses.replace(mpc, **KNOBS_OFF)
    t0 = time.perf_counter()
    w = entry(w0, bipeds, N_ART_TICKS, mpc, gait, model=hector_model(device=device))
    torch.cuda.synchronize()
    ok, line = art_walk_ok(torch, w, knobs_on=False)
    log(f"[art] {label}, bf16 knobs off: {N_ENVS} envs x {N_ART_TICKS} ticks in "
        f"{time.perf_counter() - t0:.3f} s, {line}")
    if not ok:
        raise AssertionError(f"{label} failed its walking checks with the bf16 knobs off")


def phase_art_slice(torch, device):
    """The articulated main path (the bf16 knobs on), then with the knobs
    off, then the plain chain's 3-tick check."""
    import dataclasses

    from biped_mpc_py_torch.ops.cuda import qp_kernel, substep_kernel
    from biped_mpc_py_torch.parallel.rollout_art import (
        batched_art_rollout, batched_art_rollout_kernel,
    )
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model = hector_model(device=device)
    w0, bipeds = art_worlds(torch, device)
    batched_art_rollout_kernel(w0, bipeds, 2, mpc, gait, model=model)  # warm-up
    torch.cuda.synchronize()
    substep_kernel.fused_substeps.launches = 0
    qp_kernel.fused_qp_solve.launches = 0
    t0 = time.perf_counter()
    w3 = batched_art_rollout_kernel(w0, bipeds, 3, mpc, gait, model=model)
    w25 = batched_art_rollout_kernel(w3, bipeds, N_COMPARE_TICKS - 3, mpc, gait, model=model)
    w = batched_art_rollout_kernel(w25, bipeds, N_ART_TICKS - N_COMPARE_TICKS, mpc, gait,
                                   model=model)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"fused_substeps": substep_kernel.fused_substeps.launches,
                "fused_qp_solve": qp_kernel.fused_qp_solve.launches}
    ok, line = art_walk_ok(torch, w, knobs_on=True)
    log(f"[art] substep-kernel path: {N_ENVS} envs x {N_ART_TICKS} ticks in {sec:.3f} s, launches "
        f"{json.dumps(launches)}, {line}")
    if launches != {"fused_substeps": 8 * N_ART_TICKS, "fused_qp_solve": N_ART_TICKS}:
        raise AssertionError(f"launch counts {launches} in {N_ART_TICKS} ticks")
    if not ok:
        raise AssertionError("articulated slice failed its checks")
    art_walk_knobs_off(torch, device, batched_art_rollout_kernel, w0, bipeds,
                       "substep-kernel path")

    # the plain substeps against the kernel's, 3 ticks: with the bf16 knobs
    # on (reported: the solves land apart env by env, see phase_kernel) and
    # off (the bounds of tests/test_substep_kernel.py::test_kernel_rollout_matches_xla)
    mpc_f32 = dataclasses.replace(mpc, **KNOBS_OFF)
    for knobs, cfg, wk in (("on", mpc, w3), ("off", mpc_f32, None)):
        if wk is None:
            wk = batched_art_rollout_kernel(w0, bipeds, 3, cfg, gait, model=model)
        wc = batched_art_rollout(w0, bipeds, 3, cfg, gait, model=model, n_substeps=5,
                                 minv_ll_hold=8)
        d_pos = float((wc.sim.pos - wk.sim.pos).abs().max())
        d_qd = float((wc.sim.qd - wk.sim.qd).abs().max())
        d_tg = float((wc.ctrl.t_gait - wk.ctrl.t_gait).abs().max())
        falls3 = (float(wc.metrics.falls.sum()), float(wk.metrics.falls.sum()))
        log(f"[art] plain chain vs kernel path, 3 ticks, bf16 knobs {knobs}: max|dpos| "
            f"{d_pos:.3e} m, max|dqd| {d_qd:.3e} rad/s, max|dt_gait| {d_tg:.3e} s, falls {falls3}")
    if not (d_pos < 2e-2 and d_qd < 2.0 and d_tg < 1e-5 and falls3 == (0.0, 0.0)):
        raise AssertionError("the plain chain and the kernel path differ")
    return launches, sec, w25


def _stage_split(torch, names, w, tick, n=10):
    """Mean ms per stage of ``tick(w, mark) -> w`` over ``n`` ticks after 2
    (host clock, synchronized at each ``mark(name)``, which closes a stage;
    a stage marked several times in a tick sums)."""
    acc = dict.fromkeys(names, 0.0)
    for i in range(n + 2):
        torch.cuda.synchronize()
        t_prev = time.perf_counter()

        def mark(name):
            nonlocal t_prev
            torch.cuda.synchronize()
            now = time.perf_counter()
            if i >= 2:
                acc[name] += (now - t_prev) * 1e3 / n
            t_prev = now

        w = tick(w, mark)
    return acc


def time_art(torch, device):
    """The substep kernel (device time from ``torch.profiler``; the wrapper's
    call by CUDA events beside it, which at this size is the host's launch
    rate), the plain chain's rollout rate, and one articulated tick split
    into its stages (host clock, synchronized after each stage, mean of 10
    ticks after 2)."""
    from biped_mpc_py_torch.ops.cuda.substep_kernel import (
        fused_substeps, fused_substeps_reference,
    )
    from biped_mpc_py_torch.parallel import rollout_art as ra
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    model = hector_model(device=device)
    state, tau = perturbed_art_states(torch, N_ENVS, SEED)
    sc, tc = state.to(device), tau.to(device)
    Minv = mass_matrix_inv(model, sc.q)
    ms_k, = _device_ms(torch, lambda: fused_substeps(model, sc, tc, Minv, 0.005, 5),
                       ("substep_kernel",), 50)
    ms_call = _timed(torch, lambda: fused_substeps(model, sc, tc, Minv, 0.005, 5), 50)
    ms_p = _timed(torch, lambda: fused_substeps_reference(model, sc, tc, Minv, 0.005, 5), 5)
    log(f"[times] fused_substeps ({N_ENVS} envs, 5 substeps): kernel {ms_k:.4f} ms of device "
        f"time (torch.profiler), {ms_call:.4f} ms per wrapper call (CUDA events), "
        f"plain {ms_p:.3f} ms")

    mpc, gait = _art_config()
    w, bipeds = art_worlds(torch, device)
    w = ra.batched_art_rollout(w, bipeds, 1, mpc, gait, model=model, n_substeps=5,
                               minv_ll_hold=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ra.batched_art_rollout(w, bipeds, 5, mpc, gait, model=model, n_substeps=5, minv_ll_hold=8)
    torch.cuda.synchronize()
    sec_chain = (time.perf_counter() - t0) / 5
    log(f"[times] art rollout, plain chain: {N_ENVS / sec_chain:.1f} env-steps/s "
        f"({sec_chain * 1e3:.3f} ms/tick)")

    names = ("control stage (MPC)", "Minv", "low-level x 8", "substeps x 8 (kernel)", "post")
    ll_dt = mpc.dt / 8

    def substep_tick(w, mark):
        x_fb, t_g, hold, contact, sol = ra._art_control_stage(w, bipeds, mpc, gait, model)
        u0 = sol.controls[:, 0]
        mark(names[0])
        sim = w.sim
        Minv = mass_matrix_inv(model, sim.q)
        mark(names[1])
        energy = torch.zeros_like(sim.t)
        for _ in range(8):
            tau = ra._lowlevel_stage(model, sim, sim.t, contact, u0, w, bipeds, mpc, gait)
            energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
            mark(names[2])
            sim = fused_substeps(model, sim, tau, Minv, ll_dt, 5)
            mark(names[3])
        w = ra._art_post_stage(w, sim, energy, x_fb, sol, t_g, hold, mpc)
        mark(names[4])
        return w

    w, bipeds = art_worlds(torch, device)
    acc = _stage_split(torch, names, w, substep_tick)
    total = sum(acc.values())
    log("[times] art tick stages, substep-kernel path (ms, mean of 10): " + ", ".join(
        f"{k} {v:.3f}" for k, v in acc.items()) + f", total {total:.3f}")
    return ms_k, ms_p, sec_chain


def phase_probe(torch, device):
    """The probe's four toy kernels against numpy (fails on any error past
    its tolerance) -> (launches, max error, device ms of the four kernels
    (``torch.profiler``), numpy ms for the four)."""
    from biped_mpc_py_torch.tools import probe_cuda_ops as probe

    probe.probe_op.launches = 0
    errs = probe.main(device)
    launches = probe.probe_op.launches
    a, b = probe.inputs()
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    ms = sum(_device_ms(torch, lambda: [probe.probe_op(op, ta, tb) for op in probe.OPS],
                        ("k_asin", "k_rem", "k_nested", "k_atan2"), 20))
    t0 = time.perf_counter()
    for _ in range(20):
        for op in probe.OPS:
            probe.oracle(op, a, b)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 20
    log(f"[probe] {launches} launches, max|err| {json.dumps(errs)}; the four ops: "
        f"kernels {ms:.4f} ms of device time (torch.profiler), numpy {plain_ms:.4f} ms")
    return launches, max(errs.values()), ms, plain_ms


def tick_inputs(torch, n, seed):
    """n perturbed in-contact states whose clocks are the tick's start
    times, and the tick's controls (u0, c0 flags, t0, cmd_yaw, v_int), from
    a numpy seed (as tests/test_torch_tick_kernel.py makes them)."""
    import dataclasses

    import numpy as np

    state, _ = perturbed_art_states(torch, n, seed)
    rng = np.random.default_rng(seed + 1)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32))

    args = [f32(30.0 * rng.normal(size=(n, 12))), f32(rng.random((n, 2)) < 0.5),
            f32(0.4 * rng.random(n)), f32(0.3 * rng.normal(size=n)),
            f32(0.1 * rng.normal(size=(n, 2)))]
    return dataclasses.replace(state, t=args[2].clone()), args


def phase_tick_kernel(torch, device):
    """The tick kernel vs its plain version on the card, at the main path's
    config, 1024 and 1000 perturbed envs, held to TICK_BOUNDS; the plain
    version on the CPU against itself on the card is printed as the noise
    floor. Returns the largest field error."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_reference
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model, biped = hector_model(device=device), BipedParams().to(device)
    worst = 0.0
    for n in (N_ENVS, 1000):
        state, args = tick_inputs(torch, n, SEED)
        sc, ac = state.to(device), [a.to(device) for a in args]
        Minv = mass_matrix_inv(model, sc.q)
        out_k, e_k = fused_tick(model, biped, mpc, gait, sc, *ac, Minv)
        torch.cuda.synchronize()
        out_p, e_p = fused_tick_reference(model, biped, mpc, gait, sc, *ac, Minv)
        errs = {k: float((getattr(out_k, k) - getattr(out_p, k)).abs().max()) for k in TICK_BOUNDS}
        errs["energy"] = float((e_k - e_p).abs().max())
        energy_ok = bool(torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3))
        finite = all(bool(torch.isfinite(getattr(out_k, k)).all()) for k in TICK_BOUNDS)
        line = f"[tick] {n} envs: kernel vs plain max|err| {json.dumps(errs)}"
        if n == N_ENVS:
            out_c, e_c = fused_tick_reference(hector_model(device="cpu"), BipedParams(), mpc,
                                              gait, state, *args, Minv.cpu())
            noise = {k: float((getattr(out_c, k).to(device) - getattr(out_p, k)).abs().max())
                     for k in TICK_BOUNDS}
            noise["energy"] = float((e_c.to(device) - e_p).abs().max())
            line += f"; plain CPU vs plain card {json.dumps(noise)}"
        log(line + f"; bounds {json.dumps(TICK_BOUNDS)}, energy rtol 2e-3; finite {finite}")
        bad = [k for k in TICK_BOUNDS if not errs[k] < TICK_BOUNDS[k]]
        if bad or not energy_ok or not finite or not torch.equal(out_k.t, out_p.t):
            raise AssertionError(f"tick kernel vs plain past the bounds at {n} envs: {bad}")
        worst = max(worst, *(errs[k] for k in TICK_BOUNDS))
    return worst


def phase_tick_path(torch, device, w25_substep):
    """This slice's main path: 1024 envs x 250 ticks through
    ``batched_art_rollout_tick_kernel`` from the substep path's worlds;
    launch counts, the walking bounds, and the population statistics after
    25 ticks against the substep-kernel path's (the bounds of
    tests/test_tick_kernel.py::test_tick_kernel_closed_loop)."""
    from biped_mpc_py_torch.ops.cuda import qp_kernel, substep_kernel, tick_kernel
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_tick_kernel
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model = hector_model(device=device)
    w0, bipeds = art_worlds(torch, device)
    batched_art_rollout_tick_kernel(w0, bipeds, 2, mpc, gait, model=model)  # warm-up
    torch.cuda.synchronize()
    tick_kernel.fused_tick.launches = 0
    qp_kernel.fused_qp_solve.launches = 0
    substep_kernel.fused_substeps.launches = 0
    t0 = time.perf_counter()
    w25 = batched_art_rollout_tick_kernel(w0, bipeds, N_COMPARE_TICKS, mpc, gait, model=model)
    w = batched_art_rollout_tick_kernel(w25, bipeds, N_ART_TICKS - N_COMPARE_TICKS, mpc, gait,
                                        model=model)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"fused_tick": tick_kernel.fused_tick.launches,
                "fused_qp_solve": qp_kernel.fused_qp_solve.launches,
                "fused_substeps": substep_kernel.fused_substeps.launches}
    ok, line = art_walk_ok(torch, w, knobs_on=True)
    log(f"[art] tick-kernel path: {N_ENVS} envs x {N_ART_TICKS} ticks in {sec:.3f} s, launches "
        f"{json.dumps(launches)}, {line}")
    if launches != {"fused_tick": N_ART_TICKS, "fused_qp_solve": N_ART_TICKS, "fused_substeps": 0}:
        raise AssertionError(f"launch counts {launches} in {N_ART_TICKS} ticks")
    if not ok:
        raise AssertionError("tick-kernel path failed its walking checks")
    art_walk_knobs_off(torch, device, batched_art_rollout_tick_kernel, w0, bipeds,
                       "tick-kernel path")

    ref, new = w25_substep, w25
    stats = {
        "falls": (float(ref.metrics.falls.sum()), float(new.metrics.falls.sum())),
        "z_mean": (float(ref.sim.pos[:, 2].mean()), float(new.sim.pos[:, 2].mean())),
        "x_mean": (float(ref.sim.pos[:, 0].mean()), float(new.sim.pos[:, 0].mean())),
        "att_err_sq_mean": (float(ref.metrics.attitude_err_sq.mean()),
                            float(new.metrics.attitude_err_sq.mean())),
    }
    log(f"[art] {N_COMPARE_TICKS} ticks, substep-kernel path vs tick-kernel path: "
        + json.dumps(stats))
    (zr, zn), (xr, xn), (ar, an) = stats["z_mean"], stats["x_mean"], stats["att_err_sq_mean"]
    if not (stats["falls"] == (0.0, 0.0) and abs(zr - zn) < 0.01 and abs(xr - xn) < 0.03
            and abs(ar - an) < 0.3 * max(ar, 1e-3)):
        raise AssertionError("the tick-kernel and substep-kernel paths walk differently")
    return launches, sec


def terrain_setup(torch, device):
    """The terrain slice's inputs: the articulated slice's 1024 desynced
    worlds, domain-randomized robots (seed 0) and one rough field per env
    from a seeded generator on the card."""
    from biped_mpc_py_torch.parallel.rollout import randomize_params
    from biped_mpc_py_torch.sim.contact import Terrain

    w0, _ = art_worlds(torch, device)
    bipeds = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
    terrains = Terrain.rough_batch(
        torch.Generator(device=device).manual_seed(SEED + 1), N_ENVS,
        amplitude=TERRAIN_AMPLITUDE, res=TERRAIN_RES, device=device,
    )
    return w0, bipeds, terrains


def stance_gap(model, sim, terrains, mpc, gait):
    """Sole-centre height above the env's own ground for the feet the
    schedule has down at ``sim.t`` -> (mean, min, max) [m]."""
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.sim.engine import sole_positions

    pf = sole_positions(model, sim)
    gap = pf[:, [2, 5]] - terrains.height(pf[:, [0, 3]], pf[:, [1, 4]])
    down = contact_sequence(sim.t, mpc, gait)[:, 0] > 0.5
    g = gap[down]
    return float(g.mean()), float(g.min()), float(g.max())


# The field kernel's operations beyond the plane's, per sole point and
# substep: five bilinear samples (two grid coordinates of 6 operations and 15
# for the weights and sum each), the gradient 4, the normal 12, phi and
# phi_dot 7, the tangent velocity, friction and force 26.
FIELD_CONTACT_OPS = 5 * (2 * 6 + 15) + 4 + 12 + 7 + 26


def bound_substep_field(torch, device, n, fields):
    """(bound ms, what sets it) of one 5-substep field-kernel call at ``n``
    envs: the flat call's operations plus ``FIELD_CONTACT_OPS`` per sole
    point and substep; bytes of the state (``t`` included), torques, Minv
    and model read, the state written, the ground count read and written,
    and every height-corner load as issued (20 a point and substep, 4 points,
    5 substeps), as though none hit a cache."""
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils import roofline

    state, tau = perturbed_art_states(torch, n, SEED)
    model = hector_model(device=device)
    sc, tc = state.to(device), tau.to(device)
    Minv = mass_matrix_inv(model, sc.q)
    count = torch.zeros(n, 2, 2, dtype=torch.int32)
    corners = n * 4 * 5 * 20 * fields.heights.element_size()
    return roofline.bound_ms(roofline.substep_ops(n, 5) + n * 4 * 5 * FIELD_CONTACT_OPS,
                             roofline.tensor_bytes(sc, tc, Minv, model, sc, count, count)
                             + corners)


def field_kernel_check(torch, device, model, n, dt):
    """The substep kernel's field variant against ``sim.engine.art_step(...,
    terrain, Minv=)`` on the card: ``n`` perturbed in-contact envs, each on
    its own rough field as the terrain slice draws them (at 1024 envs the
    slice's fields), one period of 5 substeps of ``dt / 5``. Raises unless
    every state field is within ``SUBSTEP_BOUNDS``, ``t`` is bit-equal and
    the count of sole points below the ground is within 1 of the plain
    chain's in each entry and in at most 4 entries (a point flips only where
    its gap to the ground lies within the two sides' rounding). -> (max |err|
    per field, the fields, the state, torques and Minv)."""
    from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
    from biped_mpc_py_torch.sim import engine
    from biped_mpc_py_torch.sim.contact import Terrain
    from biped_mpc_py_torch.utils import profiling

    fields = Terrain.rough_batch(
        torch.Generator(device=device).manual_seed(SEED + 1), n,
        amplitude=TERRAIN_AMPLITUDE, res=TERRAIN_RES, device=device,
    )
    state, tau = perturbed_art_states(torch, n, SEED)
    sc, tc = state.to(device), tau.to(device)
    Minv = engine.mass_matrix_inv(model, sc.q)

    def counted(fn):
        profiling.start_ground_count(device)
        out = fn()
        return out, profiling._ground[profiling._indexed(device)].below.clone()

    out_p, count_p = counted(lambda: engine.art_step(model, sc, tc, dt, 5, fields, Minv=Minv))
    out_k, count_k = counted(lambda: fused_substeps(model, sc, tc, Minv, dt, 5, terrain=fields))
    errs = _max_diff(out_k, out_p, SUBSTEP_BOUNDS)
    t_equal = bool(torch.equal(out_k.t, out_p.t))
    diff = (count_k - count_p).abs()
    flips, worst = int((diff > 0).sum()), int(diff.max())
    log(f"[terrain] field kernel vs art_step on rough per-env fields, {n} envs, 5 substeps of "
        f"{dt / 5 * 1e3:.4f} ms: max|err| {json.dumps(errs)} "
        f"(bounds {json.dumps(SUBSTEP_BOUNDS)}), "
        f"t bit-equal {t_equal}; sole-point substeps below the ground {int(count_k.sum())} "
        f"(plain {int(count_p.sum())} of {4 * 5 * n}), entries that differ {flips}, by at most "
        f"{worst}")
    if any(not errs[k] < b for k, b in SUBSTEP_BOUNDS.items()) or not t_equal:
        raise AssertionError(f"the field kernel left its bounds at {n} envs")
    if int(count_p.sum()) == 0 or worst > 1 or flips > 4:
        raise AssertionError(f"the field kernel's ground count departs from the plain chain's at "
                             f"{n} envs")
    return errs, fields, (sc, tc, Minv)


# The tick kernel's field variant beyond the flat tick's operations: the
# substeps' contact on the field (FIELD_CONTACT_OPS a sole point and
# substep) and one bilinear sample and add a leg and period for the swing
# target's height.
SWING_SAMPLE_OPS = 2 * 6 + 15 + 1


def _tick_field_inputs(torch, device, model, n):
    """``n`` envs of ``tick_inputs`` on the card (the state's t the tick's
    start), each on its own rough field as the terrain slice draws them, the
    nominal robot per env and Minv -> (state, args, fields, bipeds, Minv)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.sim.contact import Terrain
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv

    fields = Terrain.rough_batch(
        torch.Generator(device=device).manual_seed(SEED + 1), n,
        amplitude=TERRAIN_AMPLITUDE, res=TERRAIN_RES, device=device,
    )
    state, args = tick_inputs(torch, n, SEED)
    sc, ac = state.to(device), [a.to(device) for a in args]
    return sc, ac, fields, BipedParams().expand(n).to(device), mass_matrix_inv(model, sc.q)


def bound_tick_field(torch, device, n):
    """(bound ms, what sets it) of one field-variant tick call at ``n`` envs
    (8 periods of 5 substeps): the flat tick's operations, plus
    ``FIELD_CONTACT_OPS`` a sole point and substep and ``SWING_SAMPLE_OPS``
    a leg and period; bytes of the flat tick's inputs and outputs, the
    leg geometry, ``t`` written, the ground count read and written, and
    every height-corner load as issued (20 a sole point and substep, 4 a
    swing target), as though none hit a cache."""
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils import roofline

    model = hector_model(device=device)
    sc, ac, fields, _, Minv = _tick_field_inputs(torch, device, model, n)
    count = torch.zeros(n, 2, 2, dtype=torch.int32)
    geom = torch.zeros(n, 8)
    corners = n * 8 * (4 * 5 * 20 + 2 * 4) * fields.heights.element_size()
    return roofline.bound_ms(
        roofline.tick_ops(n, 8, 5) + n * 8 * (4 * 5 * FIELD_CONTACT_OPS + 2 * SWING_SAMPLE_OPS),
        roofline.tensor_bytes(sc, ac, Minv, model, sc, sc.t, sc.t, count, count, geom) + corners)


def tick_field_check(torch, device, model, n):
    """The tick kernel's field variant against its plain version
    (``fused_tick_field_reference``: the terrain periods of ``_art_tick``) on
    the card: ``n`` perturbed in-contact envs with random clocks, flags and
    controls (``tick_inputs``), each on its own rough field, one tick of 8
    periods of 5 substeps at the bench config, the low-level control on each
    env's robot. Raises unless every state field is within ``TICK_BOUNDS``,
    the energy within rtol 2e-3 / atol 1e-3, ``t`` bit-equal and the count
    of sole points below the ground within 1 of the plain chain's in at most
    4 entries. -> (max |err| per field, the inputs)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_field_reference
    from biped_mpc_py_torch.utils import profiling

    mpc, gait = _art_config()
    inputs = _tick_field_inputs(torch, device, model, n)
    sc, ac, fields, bipeds, Minv = inputs
    u0, c0, _, cmd_yaw, v_int = ac

    def counted(fn):
        profiling.start_ground_count(device)
        out = fn()
        return out, profiling._ground[profiling._indexed(device)].below.clone()

    (out_p, e_p), count_p = counted(lambda: fused_tick_field_reference(
        model, bipeds, mpc, gait, sc, u0, c0, sc.t, cmd_yaw, v_int, Minv, fields))
    (out_k, e_k), count_k = counted(lambda: fused_tick(
        model, BipedParams().to(device), mpc, gait, sc, u0, c0, sc.t, cmd_yaw, v_int, Minv,
        terrain=fields, bipeds=bipeds))
    errs = _max_diff(out_k, out_p, TICK_BOUNDS)
    errs["energy"] = float((e_k - e_p).abs().max())
    energy_ok = bool(torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3))
    finite = all(bool(torch.isfinite(getattr(out_k, k)).all()) for k in TICK_BOUNDS)
    t_equal = bool(torch.equal(out_k.t, out_p.t))
    diff = (count_k - count_p).abs()
    flips, worst = int((diff > 0).sum()), int(diff.max())
    log(f"[terrain] tick field kernel vs its plain version on rough per-env fields, {n} envs, "
        f"8 periods of 5 substeps: max|err| {json.dumps(errs)} (bounds "
        f"{json.dumps(TICK_BOUNDS)}, energy rtol 2e-3), finite {finite}, t bit-equal {t_equal}; "
        f"sole-point substeps below the ground {int(count_k.sum())} (plain "
        f"{int(count_p.sum())} of {4 * 40 * n}), entries that differ {flips}, by at most {worst}")
    if (any(not errs[k] < b for k, b in TICK_BOUNDS.items()) or not energy_ok or not finite
            or not t_equal):
        raise AssertionError(f"the tick field kernel left its bounds at {n} envs")
    if int(count_p.sum()) == 0 or worst > 1 or flips > 4:
        raise AssertionError(f"the tick field kernel's ground count departs from the plain "
                             f"chain's at {n} envs")
    return errs, inputs


def phase_terrain(torch, device):
    """The rough-terrain articulated path at full width, flat per-env fields
    against no terrain, then the substep kernel's field variant against the
    plain chain on rough fields (``field_kernel_check``) and the tick
    kernel's against its plain version (``tick_field_check``), each at 1024
    and 4096 envs, timed at 4096. Returns (launch counts, seconds, the field
    substep kernel's figures, the field tick kernel's figures: each for the
    kernels line)."""
    import dataclasses

    from biped_mpc_py_torch.ops.cuda import qp_kernel, substep_kernel, tick_kernel
    from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
    from biped_mpc_py_torch.parallel.rollout_art import (
        batched_art_rollout, batched_art_rollout_terrain,
    )
    from biped_mpc_py_torch.sim.contact import Terrain
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model = hector_model(device=device)
    w0, bipeds, terrains = terrain_setup(torch, device)
    h = terrains.heights
    log(f"[terrain] fields {tuple(h.shape)} {h.dtype} on {h.device}, {h.numel() * 4 / 1e6:.1f} MB, "
        f"std {float(h.std()):.5f} m, range [{float(h.min()):.4f}, {float(h.max()):.4f}] m, "
        f"cell {terrains.extent / (TERRAIN_RES - 1):.4f} m")
    kw = dict(model=model, n_substeps=5, minv_ll_hold=8)
    batched_art_rollout_terrain(w0, bipeds, terrains, 1, mpc, gait, **kw)  # warm-up
    torch.cuda.synchronize()
    counters = {"fused_qp_solve": qp_kernel.fused_qp_solve,
                "fused_tick": tick_kernel.fused_tick,
                "fused_substeps": substep_kernel.fused_substeps}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    w = batched_art_rollout_terrain(w0, bipeds, terrains, N_TERRAIN_TICKS, mpc, gait, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    s, m = w.sim, w.metrics
    finite = all(bool(torch.isfinite(t).all()) for t in (s.pos, s.quat, s.v_base, s.q, s.qd))
    att = (m.attitude_err_sq / m.n_steps).sqrt()
    gap = stance_gap(model, s, terrains, mpc, gait)
    log(f"[terrain] {N_ENVS} envs x {N_TERRAIN_TICKS} ticks in {sec:.3f} s, launches "
        f"{json.dumps(launches)}, finite {finite}; reported, not bounded: falls "
        f"{float(m.falls.sum())} in {int((m.falls > 0).sum())} envs, x min "
        f"{float(s.pos[:, 0].min()):.4f} mean {float(s.pos[:, 0].mean()):.4f} m, att RMS max "
        f"{float(att.max()):.5f} mean {float(att.mean()):.5f}, res_prim max "
        f"{float(m.res_prim_max.max()):.3e}, height [{float(s.pos[:, 2].min()):.4f}, "
        f"{float(s.pos[:, 2].max()):.4f}]; stance sole gap mean {gap[0]:.5f} m "
        f"[{gap[1]:.5f}, {gap[2]:.5f}] (bound on the mean {STANCE_GAP_RANGE})")
    if launches != {"fused_qp_solve": N_TERRAIN_TICKS, "fused_tick": N_TERRAIN_TICKS,
                    "fused_substeps": 0}:
        raise AssertionError(f"terrain path launch counts {launches} in {N_TERRAIN_TICKS} ticks")
    if not finite:
        raise AssertionError("the terrain path produced non-finite states")
    if not STANCE_GAP_RANGE[0] < gap[0] < STANCE_GAP_RANGE[1]:
        raise AssertionError(f"stance soles sit {gap[0]:.4f} m from their ground on average")

    # flat fields against no terrain: one launch of the field kernel against
    # one of the flat kernel from the slice's states, within SUBSTEP_BOUNDS
    # (the two grounds' contact agrees on flat ground up to rounding); then
    # 3 ticks of the
    # terrain path on flat fields against the plain chain on no terrain,
    # which steps t alike, pointwise, so with the bf16 knobs off (their
    # rounding flips would carry last-bit differences on, see phase_kernel),
    # within CHAIN_BOUNDS (the kernel's rounding against the plain chain's)
    flat = Terrain.flat(n=N_ENVS, device=device)
    s0 = w0.sim
    gen = torch.Generator().manual_seed(SEED)
    tau = (5.0 * torch.randn(N_ENVS, 10, generator=gen)).to(device)
    Minv = mass_matrix_inv(model, s0.q)
    one_f = fused_substeps(model, s0, tau, Minv, 0.005, 5, terrain=flat)
    one_n = fused_substeps(model, s0, tau, Minv, 0.005, 5)
    one = _max_diff(one_f, one_n, SUBSTEP_BOUNDS)
    mpc_f32 = dataclasses.replace(mpc, **KNOBS_OFF)
    w_f = batched_art_rollout_terrain(w0, bipeds, flat, 3, mpc_f32, gait, **kw)
    w_n = batched_art_rollout(w0, bipeds, 3, mpc_f32, gait, **kw)
    diffs = _max_diff(w_f.sim, w_n.sim, CHAIN_BOUNDS)
    log(f"[terrain] flat per-env fields vs no terrain: one launch of each kernel "
        f"{json.dumps(one)} (bounds {json.dumps(SUBSTEP_BOUNDS)}); 3 ticks, the terrain path "
        f"vs the plain chain {json.dumps(diffs)} (bounds {json.dumps(CHAIN_BOUNDS)})")
    if (any(one[k] >= b for k, b in SUBSTEP_BOUNDS.items())
            or any(diffs[k] >= b for k, b in CHAIN_BOUNDS.items())):
        raise AssertionError("flat height fields and terrain=None walk differently")

    # the field kernel on rough fields against the plain chain, at the
    # slice's width and the benchmark cell's; timed at the cell's
    from biped_mpc_py_torch.sim.engine import art_step

    ll_dt = mpc.dt / 8
    errs = {}
    for n in (N_ENVS, 4096):
        errs[n], fields, (sc, tc, Mv) = field_kernel_check(torch, device, model, n, ll_dt)
    ms_k, = _device_ms(torch, lambda: fused_substeps(model, sc, tc, Mv, ll_dt, 5, terrain=fields),
                       ("substep_kernel",), 50)
    ms_p = _timed(torch, lambda: art_step(model, sc, tc, ll_dt, 5, fields, Minv=Mv), 5)
    bound, by = bound_substep_field(torch, device, 4096, fields)
    log(f"[times] field kernel (4096 envs, 5 substeps): {ms_k:.4f} ms of device time "
        f"(torch.profiler), plain chain {ms_p:.3f} ms (CUDA events, eager), bound {bound:.4f} ms "
        f"({by}, share {bound / ms_k:.3f})")
    field = {"launches": launches["fused_substeps"],
             "max_abs_err": max(max(e.values()) for e in errs.values()),
             "ms": ms_k, "plain_ms": ms_p, "bound": (bound, by)}

    # the tick kernel's field variant against its plain version, at the
    # slice's width and the cell's; timed at the cell's
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_field_reference

    errs = {n: tick_field_check(torch, device, model, n) for n in (N_ENVS, 4096)}
    sc, ac, fields, bipeds, Mv = errs[4096][1]
    u0, c0, _, cmd_yaw, v_int = ac
    biped = BipedParams().to(device)
    ms_k, = _device_ms(torch, lambda: fused_tick(model, biped, mpc, gait, sc, u0, c0, sc.t,
                                                 cmd_yaw, v_int, Mv, terrain=fields,
                                                 bipeds=bipeds), ("tick_kernel",), 50)
    ms_p = _timed(torch, lambda: fused_tick_field_reference(model, bipeds, mpc, gait, sc, u0, c0,
                                                            sc.t, cmd_yaw, v_int, Mv, fields), 3)
    bound, by = bound_tick_field(torch, device, 4096)
    log(f"[times] tick field kernel (4096 envs, 8 periods of 5 substeps): {ms_k:.4f} ms of "
        f"device time (torch.profiler), plain terrain periods {ms_p:.3f} ms (CUDA events, eager), "
        f"bound {bound:.4f} ms ({by}, share {bound / ms_k:.3f})")
    tick_field = {"launches": launches["fused_tick"],
                  "max_abs_err": max(max(v for k, v in e.items() if k != "energy")
                                     for e, _ in errs.values()),
                  "ms": ms_k, "plain_ms": ms_p, "bound": (bound, by)}
    return launches, sec, field, tick_field


def _device_kernels(torch, fn):
    """Device kernels one call of ``fn`` launches (``torch.profiler``, after
    a warm-up call): a count that does not depend on the host's speed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def time_terrain(torch, device, sec_terrain, sec_chain):
    """One tick split into its stages (host clock, synchronized after each
    stage, mean of 3 ticks after 2), on the terrain slice's fields (the
    low-level loop one launch of the tick kernel's field variant, as the
    terrain path) and on no terrain (the plain chain) from the same worlds
    and robots, in turns
    (terrain, flat, flat, terrain: the host's speed drifts within a call),
    with the two rates; and the device kernels one plain substep and one
    low-level stage launch with and without a terrain, the cost of the
    height gathers on the plain chain that does not depend on the host."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick
    from biped_mpc_py_torch.parallel import rollout_art as ra
    from biped_mpc_py_torch.sim.engine import art_step, art_substep, mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model = hector_model(device=device)
    w0, bipeds, terrains = terrain_setup(torch, device)
    names = ("control stage (MPC)", "Minv",
             "low-level loop (tick field kernel; flat: plain control and substeps x 8)", "post")
    ll_dt = mpc.dt / 8
    biped = BipedParams().to(device)

    def chain_tick(terrain):
        def tick(w, mark):
            x_fb, t_g, hold, contact, sol = ra._art_control_stage(w, bipeds, mpc, gait, model,
                                                                  terrain)
            u0 = sol.controls[:, 0]
            mark(names[0])
            sim = w.sim
            Minv = mass_matrix_inv(model, sim.q)
            mark(names[1])
            if terrain is None:
                energy = torch.zeros_like(sim.t)
                for _ in range(8):
                    tau = ra._lowlevel_stage(model, sim, sim.t, contact, u0, w, bipeds, mpc,
                                             gait)
                    energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
                    sim = art_step(model, sim, tau, ll_dt, 5, Minv=Minv)
            else:
                sim, energy = fused_tick(model, biped, mpc, gait, sim, u0, contact[:, 0, 0:2],
                                         sim.t, w.ctrl.cmd_ref[:, 2], w.ctrl.v_int, Minv,
                                         terrain=terrain, bipeds=bipeds)
            mark(names[2])
            w = ra._art_post_stage(w, sim, energy, x_fb, sol, t_g, hold, mpc)
            mark(names[3])
            return w

        return tick

    runs = [_stage_split(torch, names, w0, chain_tick(terrain), n=3)
            for terrain in (terrains, None, None, terrains)]
    turns = [(runs[0], runs[1]), (runs[3], runs[2])]
    log(f"[times] terrain path {N_ENVS} envs x {N_TERRAIN_TICKS} ticks: "
        f"{N_ENVS * N_TERRAIN_TICKS / sec_terrain:.1f} env-steps/s "
        f"({sec_terrain * 1e3 / N_TERRAIN_TICKS:.3f} ms/tick; flat plain chain "
        f"{N_ENVS / sec_chain:.1f} env-steps/s, {sec_chain * 1e3:.3f} ms/tick); stages, ms, mean "
        f"of 3, terrain (flat plain chain), run in the order terrain, flat, flat, terrain: "
        + "; then ".join(
            ", ".join(f"{k} {acc_t[k]:.3f} ({acc_f[k]:.3f})" for k in names)
            + f", total {sum(acc_t.values()):.3f} ({sum(acc_f.values()):.3f}), ratio "
            f"{sum(acc_t.values()) / sum(acc_f.values()):.3f}" for acc_t, acc_f in turns))

    sim = w0.sim
    Minv = mass_matrix_inv(model, sim.q)
    tau = torch.zeros_like(sim.q)
    contact = ra.contact_sequence(sim.t, mpc, gait)
    u0 = torch.zeros((N_ENVS, 12), device=device)
    counts = {
        label: (_device_kernels(torch, lambda: art_substep(model, sim, tau, 0.001, terrain,
                                                           Minv=Minv)),
                _device_kernels(torch, lambda: ra._lowlevel_stage(
                    model, sim, sim.t, contact, u0, w0, bipeds, mpc, gait, terrain)))
        for label, terrain in (("terrain", terrains), ("flat", None))
    }
    (sub_t, ll_t), (sub_f, ll_f) = counts["terrain"], counts["flat"]
    log(f"[times] device kernels per call, terrain (flat): one plain substep {sub_t} ({sub_f}), "
        f"one low-level stage {ll_t} ({ll_f}); per tick of 40 substeps and 8 low-level stages "
        f"the gathers add {40 * (sub_t - sub_f) + 8 * (ll_t - ll_f)} launches to "
        f"{40 * sub_f + 8 * ll_f}")


def phase_cmd_rollout(torch, device):
    """Per-env commands on the SRB loop: 1024 randomized robots x 50 ticks
    through ``batched_cmd_rollout``, env i commanded forward at 0.4 i /
    1023 m/s. Zero falls, and the mean distance of each quarter of the
    command range above the quarter's below."""
    from biped_mpc_py_torch import GaitConfig, fast_mpc_config
    from biped_mpc_py_torch.ops.cuda import qp_kernel
    from biped_mpc_py_torch.parallel.rollout import (
        batch_worlds, batched_cmd_rollout, randomize_params,
    )

    mpc, gait = fast_mpc_config(), GaitConfig()
    worlds = batch_worlds(mpc, N_ENVS, device=device)
    bipeds = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
    x_cmd = torch.zeros(N_ENVS, 12, device=device)
    x_cmd[:, 5] = 0.55
    x_cmd[:, 9] = torch.linspace(0.0, 0.4, N_ENVS, device=device)
    batched_cmd_rollout(worlds, bipeds, x_cmd, 2, mpc, gait)  # warm-up
    torch.cuda.synchronize()
    qp_kernel.fused_qp_solve.launches = 0
    t0 = time.perf_counter()
    w = batched_cmd_rollout(worlds, bipeds, x_cmd, N_TICKS, mpc, gait)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = qp_kernel.fused_qp_solve.launches
    x = w.sim.x_fb
    falls = float(w.metrics.falls.sum())
    finite = bool(torch.isfinite(x).all())
    speed = x[:, 3] / (N_TICKS * mpc.dt)
    quarters = [float(q.mean()) for q in speed.chunk(4)]
    vel_rms = float((w.metrics.vel_err_sq / w.metrics.n_steps).sqrt().mean())
    log(f"[cmd] {N_ENVS} envs x {N_TICKS} ticks, vx 0-0.4 m/s per env: "
        f"{N_ENVS * N_TICKS / sec:.1f} env-steps/s ({sec * 1e3 / N_TICKS:.3f} ms/tick), launches "
        f"{launches}, falls {falls}, finite {finite}, mean speed by quarter of the command range "
        f"{json.dumps(quarters)} m/s, vel RMS against each env's command {vel_rms:.5f}, height "
        f"[{float(x[:, 5].min()):.4f}, {float(x[:, 5].max()):.4f}]")
    if launches != N_TICKS:
        raise AssertionError(f"QP kernel launched {launches} times in {N_TICKS} ticks")
    if not (finite and falls == 0 and all(a < b for a, b in zip(quarters, quarters[1:]))):
        raise AssertionError("per-env command rollout failed its checks")


# --- the deployment slice: sweeps and the N = 1 loops ------------------------

# The sweep: a 4 x 4 grid of foot-heading gains times 64 perturbed worlds.
SWEEP_GRID = (0.0, 0.5, 1.0, 1.5)  # multiples of the base kp_hipyaw, kd_hipyaw
SWEEP_WORLDS = 64
SWEEP_TICKS = 25
SWEEP_SCALE = 2e-3
# (config, world) of the 8 envs run on the card and on the CPU
SWEEP_COMPARE = ((0, 0), (5, 1), (10, 0), (10, 3), (15, 0), (3, 7), (7, 9), (12, 11))
# The port's plain chain against JAX: tests/test_torch_rollout_art.py.
CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}
# The N = 1 loops: tests/test_mj_contact.py's pinned MuJoCo operating point,
# and tests/test_torch_deploy.py's bounds on the feedback states and forces.
ORACLE_MPC = dict(kp_hipyaw=3.0, kd_hipyaw=0.4, tau_z_max=4.0, swing_td_damp=8.0,
                  swing_z_sin2=True)
MJ_BOUNDS = {"att_pos": 1e-4, "vel": 2e-3, "force": 1.0}
N_MJ_TICKS = 100
MG = 12.0 * 9.81
N_CKPT_TICKS = 10


def _have_mujoco() -> bool:
    try:
        import mujoco  # noqa: F401
    except ImportError:
        return False
    return True


def _kernel_counters():
    from biped_mpc_py_torch.ops.cuda import qp_kernel, substep_kernel, tick_kernel

    return {"fused_qp_solve": qp_kernel.fused_qp_solve, "fused_tick": tick_kernel.fused_tick,
            "fused_substeps": substep_kernel.fused_substeps}


def _reset_counts():
    for fn in _kernel_counters().values():
        fn.launches = 0


def _counts():
    return {k: fn.launches for k, fn in _kernel_counters().items()}


def _max_diff(a, b, keys):
    return {k: float((getattr(a, k).cpu() - getattr(b, k).cpu()).abs().max()) for k in keys}


def _sweep_worlds(torch, configs, n_worlds, device):
    """``stack_configs`` of each config on ``n_worlds`` perturbed worlds
    (seed 0): env ``n_worlds c + w`` runs config c on world w."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.parallel.sweep import perturbed_worlds, stack_configs

    mpc_s, per_env = stack_configs([c for c in configs for _ in range(n_worlds)], device)
    worlds = perturbed_worlds(configs[0], n_worlds, torch.Generator().manual_seed(SEED),
                              SWEEP_SCALE, device)
    worlds = worlds.map(lambda t: t.repeat((len(configs),) + (1,) * (t.dim() - 1)))
    n = len(configs) * n_worlds
    return mpc_s, per_env, worlds, BipedParams().expand(n).to(device)


def _card_vs_cpu(torch, worlds, bipeds, mpc, gait, per_env, kw, ticks, idx=None):
    """``art_sweep`` of the envs ``idx`` (all when None) on the card, then
    on the CPU, each stopping at the tick counts in ``ticks`` -> (card world
    at the last, the card run's launch counts, max |diff| per CHAIN_BOUNDS
    key at each). Where the card runs the tick path with the tick kernel's
    per-env variant (``rollout_art._tick_table_path``) the CPU runs the
    same path's plain version (``batched_art_rollout_tick_kernel(per_env=)``;
    ``art_sweep`` on the CPU is the plain chain), else ``art_sweep``."""
    from biped_mpc_py_torch.parallel import rollout_art
    from biped_mpc_py_torch.parallel.sweep import art_sweep

    if idx is not None:
        worlds, bipeds = worlds.map(lambda t: t[idx]), bipeds.map(lambda t: t[idx])
        per_env = {k: v[idx] for k, v in per_env.items()}
    cpu = torch.device("cpu")
    kw_cpu = dict(kw, model=kw["model"].to(cpu))
    host = (worlds.to(cpu), bipeds.to(cpu), {k: v.cpu() for k, v in per_env.items()})
    _reset_counts()
    card, done = [worlds], 0
    for n in ticks:
        card.append(art_sweep(card[-1], bipeds, n - done, mpc, gait, per_env, **kw))
        done = n
    torch.cuda.synchronize()
    launches = _counts()
    x_cmd, fields = rollout_art.split_per_env(per_env)
    tick_path = rollout_art._tick_table_path(None, gait, 8, kw["minv_ll_hold"], x_cmd, fields)
    w, done, diffs = host[0], 0, []
    for n, w_c in zip(ticks, card[1:]):
        if tick_path:
            w = rollout_art.batched_art_rollout_tick_kernel(
                w, host[1], n - done, mpc, gait, model=kw_cpu["model"],
                n_substeps=kw["n_substeps"], per_env=host[2])
        else:
            w = art_sweep(w, host[1], n - done, mpc, gait, host[2], **kw_cpu)
        done = n
        diffs.append(_max_diff(w_c.sim, w.sim, CHAIN_BOUNDS))
    return card[-1], launches, diffs


def _finite(sim):
    return all(bool(t.isfinite().all()) for t in (sim.pos, sim.quat, sim.v_base, sim.q, sim.qd))


def sweep_setup(torch, device):
    """The sweep's 1024 envs: env 64 c + w runs config c of the grid on
    perturbed world w. The grid's last cell repeats the base config, so that
    two equal configs share the nominal world. The bf16 knobs are off: the
    phase holds 8 envs on the card against the CPU pointwise, which the
    bf16 K^-1 product's rounding flips would not leave (see phase_kernel)."""
    import dataclasses

    mpc, gait = _art_config()
    mpc = dataclasses.replace(mpc, **KNOBS_OFF)
    grid = [(mpc.kp_hipyaw * a, mpc.kd_hipyaw * b) for a in SWEEP_GRID for b in SWEEP_GRID]
    grid[-1] = (mpc.kp_hipyaw, mpc.kd_hipyaw)
    configs = [dataclasses.replace(mpc, kp_hipyaw=kp, kd_hipyaw=kd) for kp, kd in grid]
    mpc_s, per_env, worlds, bipeds = _sweep_worlds(torch, configs, SWEEP_WORLDS, device)
    return mpc_s, gait, per_env, worlds, bipeds, grid


def _sweep_table_inputs(torch, device, n):
    """``tick_inputs``' states and controls at ``n`` envs with four configs
    around the articulated bench config, env i under config i % 4 (the
    command's speed and turn rate, every swing, Raibert and heading gain,
    the touchdown overdrive), as ``tests/test_torch_cuda.py::
    _sweep_table_values`` draws them -> (state, controls, x_cmd, per_env,
    the robots)."""
    import dataclasses

    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.parallel.sweep import stack_configs

    mpc, _ = _art_config()
    configs = [dataclasses.replace(
        mpc, x_cmd=tuple(mpc.x_cmd[:8]) + (0.1 * i, 0.2 + 0.2 * i) + tuple(mpc.x_cmd[10:]),
        kp_swing=500.0 + 100 * i, kd_swing=10.0 - i, swing_height=0.04 + 0.01 * i,
        raibert_capture_gain=0.3 + 0.05 * i, raibert_ff_scale=1.0 - 0.1 * i,
        kp_hipyaw=0.8 * i, kd_hipyaw=0.1 * i, swing_td_overdrive=0.005 * i,
        kv=0.01 + 0.01 * i) for i in range(4)]
    _, per_env = stack_configs([configs[i % 4] for i in range(n)], device=device)
    state, args = tick_inputs(torch, n, SEED)
    return (state.to(device), [a.to(device) for a in args], per_env.pop("x_cmd"), per_env,
            BipedParams().expand(n).to(device))


def bound_tick_table(torch, device, n):
    """(bound ms, what sets it) of one per-env tick call at ``n`` envs (8
    periods of 5 substeps): the flat tick's operations (the table adds
    none: the constants are read, not formed), and its bytes with the table
    (n x 45 f32) read once."""
    from biped_mpc_py_torch.ops.cuda.tick_kernel import CONTROL_NAMES
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model
    from biped_mpc_py_torch.utils import roofline

    model = hector_model(device=device)
    sc, ac, _, _, _ = _sweep_table_inputs(torch, device, n)
    Minv = mass_matrix_inv(model, sc.q)
    table = torch.zeros(n, len(CONTROL_NAMES))
    return roofline.bound_ms(roofline.tick_ops(n, 8, 5),
                             roofline.tensor_bytes(sc, ac, Minv, model, sc, sc.t, table))


def tick_table_check(torch, device, model, n):
    """One per-env tick at ``n`` envs through the kernel (one launch)
    against its plain version (``fused_tick_reference`` with the same
    ``x_cmd``, ``per_env`` and robots) on the card. Raises unless every state
    field is within ``TICK_BOUNDS``, the energy within rtol 2e-3 / atol 1e-3
    and ``t`` bit-equal -> (max |err| per field, the inputs)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_reference
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv

    mpc, gait = _art_config()
    sc, ac, x_cmd, per_env, bipeds = _sweep_table_inputs(torch, device, n)
    Minv = mass_matrix_inv(model, sc.q)
    biped = BipedParams().to(device)
    out_k, e_k = fused_tick(model, biped, mpc, gait, sc, *ac, Minv, x_cmd=x_cmd,
                            per_env=per_env, bipeds=bipeds)
    out_p, e_p = fused_tick_reference(model, biped, mpc, gait, sc, *ac, Minv, x_cmd=x_cmd,
                                      per_env=per_env, bipeds=bipeds)
    torch.cuda.synchronize()
    errs = _max_diff(out_k, out_p, TICK_BOUNDS)
    errs["energy"] = float((e_k - e_p).abs().max())
    energy_ok = bool(torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3))
    finite = all(bool(torch.isfinite(getattr(out_k, k)).all()) for k in TICK_BOUNDS)
    t_equal = bool(torch.equal(out_k.t, out_p.t))
    log(f"[sweep] tick kernel's per-env variant vs its plain version, {n} envs in 4 configs, "
        f"8 periods of 5 substeps: max|err| {json.dumps(errs)} (bounds "
        f"{json.dumps(TICK_BOUNDS)}, energy rtol 2e-3), finite {finite}, t bit-equal {t_equal}")
    if (any(not errs[k] < b for k, b in TICK_BOUNDS.items()) or not energy_ok or not finite
            or not t_equal):
        raise AssertionError(f"the tick kernel's per-env variant left its bounds at {n} envs")
    return errs, (sc, ac, x_cmd, per_env, bipeds, Minv)


def phase_tick_table(torch, device):
    """The per-env variant against its plain version at 1024 and 4096 envs,
    and its device time at 4096 beside the plain version's and its bound
    -> the kernels line's entry (without ``launches``)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_reference
    from biped_mpc_py_torch.sim.model import hector_model

    model = hector_model(device=device)
    mpc, gait = _art_config()
    errs = {n: tick_table_check(torch, device, model, n) for n in (N_ENVS, 4096)}
    sc, ac, x_cmd, per_env, bipeds, Mv = errs[4096][1]
    biped = BipedParams().to(device)
    kw = dict(x_cmd=x_cmd, per_env=per_env, bipeds=bipeds)
    ms_k, = _device_ms(torch, lambda: fused_tick(model, biped, mpc, gait, sc, *ac, Mv, **kw),
                       ("tick_kernel",), 50)
    ms_flat, = _device_ms(torch, lambda: fused_tick(model, biped, mpc, gait, sc, *ac, Mv),
                          ("tick_kernel",), 50)
    ms_p = _timed(torch, lambda: fused_tick_reference(model, biped, mpc, gait, sc, *ac, Mv, **kw),
                  3)
    bound, by = bound_tick_table(torch, device, 4096)
    log(f"[times] tick kernel per-env variant (4096 envs, 8 periods of 5 substeps): {ms_k:.4f} "
        f"ms of device time (torch.profiler; the flat kernel {ms_flat:.4f} on the same inputs), "
        f"plain per-env periods {ms_p:.3f} ms (CUDA events, eager), bound {bound:.4f} ms "
        f"({by}, share {bound / ms_k:.3f})")
    return {"max_abs_err": max(max(v for k, v in e.items() if k != "energy")
                               for e, _ in errs.values()),
            "ms": ms_k, "plain_ms": ms_p, "bound": (bound, by)}


def phase_sweep(torch, device):
    """The tick kernel's per-env variant (``phase_tick_table``), then 16
    configs x 64 perturbed worlds x 25 ticks of ``art_sweep``, then 8 of
    its envs x 2 ticks on the card against the same path on the CPU -> the
    kernels line's ``fused_tick_table`` entry."""
    from biped_mpc_py_torch.parallel.sweep import art_sweep
    from biped_mpc_py_torch.sim.model import hector_model

    tick_table = phase_tick_table(torch, device)
    mpc, gait, per_env, worlds, bipeds, grid = sweep_setup(torch, device)
    n = bipeds.m.shape[0]
    kw = dict(model=hector_model(device=device), n_substeps=5, minv_ll_hold=8)
    art_sweep(worlds, bipeds, 1, mpc, gait, per_env, **kw)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    w = art_sweep(worlds, bipeds, SWEEP_TICKS, mpc, gait, per_env, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _counts()
    s = w.sim
    finite = _finite(s)
    falls = [float(f) for f in w.metrics.falls.reshape(len(grid), SWEEP_WORLDS).sum(1)]
    base, repeat, zero = 10 * SWEEP_WORLDS, 15 * SWEEP_WORLDS, 0
    equal = all(torch.equal(getattr(s, k)[base], getattr(s, k)[repeat])
                for k in ("pos", "quat", "v_base", "q", "qd"))
    d_zero = float((s.q[zero] - s.q[base]).abs().max())

    idx = torch.tensor([c * SWEEP_WORLDS + w % SWEEP_WORLDS for c, w in SWEEP_COMPARE],
                       device=device)
    diffs = _card_vs_cpu(torch, worlds, bipeds, mpc, gait, per_env, kw, (2,), idx)[2][0]
    log(f"[sweep] {len(grid)} configs (kp_hipyaw, kd_hipyaw) x {SWEEP_WORLDS} perturbed worlds "
        f"(scale {SWEEP_SCALE}) x {SWEEP_TICKS} ticks in {sec:.3f} s: "
        f"{n * SWEEP_TICKS / sec:.1f} env-steps/s ({sec * 1e3 / SWEEP_TICKS:.3f} ms/tick), "
        f"launches {json.dumps(launches)}, finite {finite}, repeated config bit-equal {equal}, "
        f"zero-gain config vs base max|dq| {d_zero:.3e}; falls per config [kp, kd, falls] "
        + json.dumps([[round(kp, 4), round(kd, 4), f] for (kp, kd), f in zip(grid, falls)])
        + f"; 8 envs x 2 ticks card vs CPU {json.dumps(diffs)} (bounds {json.dumps(CHAIN_BOUNDS)})")
    if launches != {"fused_qp_solve": SWEEP_TICKS, "fused_tick": SWEEP_TICKS,
                    "fused_substeps": 0}:
        raise AssertionError(f"sweep launch counts {launches} in {SWEEP_TICKS} ticks")
    if not (finite and equal and d_zero > 1e-5):
        raise AssertionError("the sweep failed its checks")
    if any(diffs[k] >= b for k, b in CHAIN_BOUNDS.items()):
        raise AssertionError(f"the sweep on the card and on the CPU differ: {diffs}")
    return {**tick_table, "launches": launches["fused_tick"]}


# The numerics sweep: raibert_pitch_place x admm_rho, 64 perturbed worlds each.
NUMERICS_PITCH_PLACE = (0.0, 0.1, 0.2, 0.25)  # with raibert_pitch_nom 0.12
NUMERICS_PITCH_NOM = 0.12
NUMERICS_RHO = (0.1, 0.3, 1.0, 3.0)
NUMERICS_BASE = 1  # the cell (pitch_place 0, rho 0.3) that the last cell repeats
# (rho, sigma, alpha) of the kernel's four value groups, 256 envs each
NUMERICS_GROUPS = ((0.1, 1e-6, 1.6), (0.3, 1e-5, 1.4), (1.0, 1e-4, 1.8), (3.0, 1e-6, 1.2))
DT_SWEEP = (0.03, 0.035, 0.04, 0.045)
DT_WORLDS = 8
DT_TICKS = 10


def _numerics_config():
    """``art_mpc_config()`` at the bench budget, walking in place at three
    MPC steps a phase (the sweeps' operating point in
    ``tests/test_torch_sweep.py``)."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.parallel.rollout_art import art_mpc_config

    mpc = art_mpc_config(n_admm_iters=40, admm_rho_phases=1, admm_polish=False,
                         kinv_ns_iters=10)
    return mpc, GaitConfig(steps_per_phase=3)


def sweep_numerics_rollout(torch, device):
    """16 configs (``raibert_pitch_place`` x ``admm_rho``, the last cell a
    repeat of the base cell) x 64 perturbed worlds x 25 ticks of
    ``art_sweep``: one QP launch a tick with each env's rho and one launch
    of the tick kernel's per-env variant, finite, the repeated cell
    bit-equal to its twin on every world; 8 envs x 2 ticks on the card
    against the same path on the CPU."""
    import dataclasses

    from biped_mpc_py_torch.parallel.sweep import art_sweep
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _numerics_config()
    grid = [(pp, rho) for pp in NUMERICS_PITCH_PLACE for rho in NUMERICS_RHO]
    grid[-1] = grid[NUMERICS_BASE]
    configs = [dataclasses.replace(mpc, raibert_pitch_place=pp,
                                   raibert_pitch_nom=NUMERICS_PITCH_NOM, admm_rho=rho)
               for pp, rho in grid]
    mpc_s, per_env, worlds, bipeds = _sweep_worlds(torch, configs, SWEEP_WORLDS, device)
    if set(per_env) != {"raibert_pitch_place", "admm_rho"}:
        raise AssertionError(f"the numerics sweep batches {sorted(per_env)}")
    n = bipeds.m.shape[0]
    kw = dict(model=hector_model(device=device), n_substeps=5, minv_ll_hold=8)
    art_sweep(worlds, bipeds, 1, mpc_s, gait, per_env, **kw)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    w = art_sweep(worlds, bipeds, SWEEP_TICKS, mpc_s, gait, per_env, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _counts()
    s = w.sim
    twin = slice(NUMERICS_BASE * SWEEP_WORLDS, (NUMERICS_BASE + 1) * SWEEP_WORLDS)
    last = slice(n - SWEEP_WORLDS, n)
    equal = all(torch.equal(getattr(s, k)[twin], getattr(s, k)[last])
                for k in ("pos", "quat", "v_base", "q", "qd", "t"))
    falls = [float(f) for f in w.metrics.falls.reshape(len(grid), SWEEP_WORLDS).sum(1)]
    idx = torch.tensor([c * SWEEP_WORLDS + w_ % SWEEP_WORLDS for c, w_ in SWEEP_COMPARE],
                       device=device)
    diffs = _card_vs_cpu(torch, worlds, bipeds, mpc_s, gait, per_env, kw, (2,), idx)[2][0]
    log(f"[numerics] {len(grid)} configs (raibert_pitch_place, admm_rho; pitch_nom "
        f"{NUMERICS_PITCH_NOM}) x {SWEEP_WORLDS} perturbed worlds x {SWEEP_TICKS} ticks in "
        f"{sec:.3f} s: {n * SWEEP_TICKS / sec:.1f} env-steps/s ({sec * 1e3 / SWEEP_TICKS:.3f} "
        f"ms/tick), launches {json.dumps(launches)}, finite {_finite(s)}, repeated cell "
        f"bit-equal to its twin on all {SWEEP_WORLDS} worlds {equal}; falls per config "
        "[pitch_place, rho, falls] "
        + json.dumps([[pp, rho, f] for (pp, rho), f in zip(grid, falls)])
        + f"; 8 envs x 2 ticks card vs CPU {json.dumps(diffs)}")
    if launches != {"fused_qp_solve": SWEEP_TICKS, "fused_tick": SWEEP_TICKS,
                    "fused_substeps": 0}:
        raise AssertionError(f"numerics sweep launch counts {launches} in {SWEEP_TICKS} ticks")
    if not (_finite(s) and equal):
        raise AssertionError("the numerics sweep failed its checks")
    if any(diffs[k] >= b for k, b in CHAIN_BOUNDS.items()):
        raise AssertionError(f"the numerics sweep on the card and on the CPU differ: {diffs}")
    return sec


def numerics_kernel(torch, device):
    """1024 real MPC QPs at the bench budget with per-env (rho, sigma,
    alpha) in four value groups of 256 envs, in one launch: within
    ``BOUND_BENCH`` per env of the plain version with the same per-env
    values, bit-equal per env to one scalar launch per group, and per-env
    values all equal to the config's bit-equal to the scalar launch. Times
    the per-env launch beside the scalar launch (CUDA events, in turns)
    -> (max |du| N, per-env ms, scalar ms). The bf16 knobs are off: the
    per-env bound is pointwise, which the bf16 K^-1 product's rounding
    flips would not leave (see phase_kernel)."""
    from biped_mpc_py_torch.ops import qp as tqp
    from biped_mpc_py_torch.ops.cuda.qp_kernel import (
        fused_qp_solve, fused_qp_solve_reference,
    )

    mpc = bench_budgets()["bench-f32"]
    qp = mpc_qps(torch, mpc, N_ENVS, device, SEED)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    kw = tqp.solver_args(mpc)
    g = N_ENVS // len(NUMERICS_GROUPS)
    table = torch.tensor(NUMERICS_GROUPS).repeat_interleave(g, 0).to(device)
    per_env = {k: table[:, i].contiguous() for i, k in enumerate(("rho", "sigma", "alpha"))}
    out = fused_qp_solve(*args, **{**kw, **per_env})
    torch.cuda.synchronize()
    ref = fused_qp_solve_reference(*args, **{**kw, **per_env})
    du = (tqp.recover_solution(qp, *out, D, E, c).controls
          - tqp.recover_solution(qp, *ref, D, E, c).controls).abs().flatten(1).amax(1)
    du_groups = [float(du[i * g:(i + 1) * g].max()) for i in range(len(NUMERICS_GROUPS))]
    groups_equal = []
    for i, (rho, sigma, alpha) in enumerate(NUMERICS_GROUPS):
        rows = slice(i * g, (i + 1) * g)
        part = fused_qp_solve(*[a[rows] for a in args],
                              **{**kw, "rho": rho, "sigma": sigma, "alpha": alpha})
        groups_equal.append(all(torch.equal(u[rows], v) for u, v in zip(out, part)))
    same = {k: torch.full((N_ENVS,), kw[k], device=device) for k in per_env}
    scalar_equal = all(torch.equal(u, v) for u, v in zip(
        fused_qp_solve(*args, **kw), fused_qp_solve(*args, **{**kw, **same})))
    times = {"scalar": [], "per_env": []}
    for which in ("scalar", "per_env", "per_env", "scalar"):
        kw_w = kw if which == "scalar" else {**kw, **per_env}
        times[which].append(_timed(torch, lambda: fused_qp_solve(*args, **kw_w), 20))
    ms_env, ms_scalar = (sum(times[k]) / 2 for k in ("per_env", "scalar"))
    log(f"[numerics] QP kernel, {N_ENVS} real QPs at the bench budget, per-env (rho, sigma, "
        f"alpha) in {len(NUMERICS_GROUPS)} groups of {g} {json.dumps(NUMERICS_GROUPS)}, one "
        f"launch: max|du| against the plain version with the same values per group "
        f"{json.dumps(du_groups)} N (bound {BOUND_BENCH}); bit-equal to one scalar launch per "
        f"group {groups_equal}; all equal to the config's bit-equal to the scalar launch "
        f"{scalar_equal}; per-env launch {ms_env:.4f} ms ({', '.join(f'{t:.4f}' for t in times['per_env'])}), "
        f"scalar launch {ms_scalar:.4f} ms ({', '.join(f'{t:.4f}' for t in times['scalar'])}) "
        "(CUDA events, in turns)")
    if not (all(groups_equal) and scalar_equal):
        raise AssertionError("the per-env QP launch is not bit-equal to the scalar launches")
    if not (bool(torch.isfinite(out[0]).all()) and max(du_groups) < BOUND_BENCH):
        raise AssertionError(f"per-env QP kernel vs plain past {BOUND_BENCH} N: {du_groups}")
    return max(du_groups), ms_env, ms_scalar


def sweep_dt(torch, device):
    """4 configs with ``dt`` in ``DT_SWEEP`` x 8 perturbed worlds x 10
    ticks on the card (a per-env ``dt``: the plain chain): one QP launch a
    tick and no physics launch, finite,
    within ``CHAIN_BOUNDS`` of the CPU after 2 ticks (the horizon those
    bounds hold at: the closed loop's contact events flip on last-bit
    differences later, with or without per-env values, so the 10-tick
    difference is printed beside that of the same worlds under one shared
    ``dt``), and each env's clock bit-equal to a run of its config alone
    on the CPU (8 worlds, the ``dt`` handed per env as in the sweep; the
    config's float form, which rounds the substep from double as the JAX
    loop with a trace-time ``dt`` does, within 1 us)."""
    import dataclasses

    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.parallel.sweep import art_sweep, perturbed_worlds
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _numerics_config()
    kw = dict(model=hector_model(device=device), n_substeps=5, minv_ll_hold=8)

    def card_and_cpu(configs):
        mpc_s, per_env, worlds, bipeds = _sweep_worlds(torch, configs, DT_WORLDS, device)
        out = _card_vs_cpu(torch, worlds, bipeds, mpc_s, gait, per_env, kw, (2, DT_TICKS))
        return (*out, per_env)

    configs = [dataclasses.replace(mpc, dt=dt) for dt in DT_SWEEP]
    out_c, launches, (diffs2, diffs10), per_env = card_and_cpu(configs)
    if set(per_env) != {"dt"}:
        raise AssertionError(f"the dt sweep batches {sorted(per_env)}")
    control10 = card_and_cpu([mpc] * len(DT_SWEEP))[2][1]
    cpu = torch.device("cpu")
    kw_cpu = dict(kw, model=kw["model"].to(cpu))
    w8 = perturbed_worlds(mpc, DT_WORLDS, torch.Generator().manual_seed(SEED), SWEEP_SCALE, cpu)
    b8 = BipedParams().expand(DT_WORLDS)
    t_card = out_c.sim.t.cpu().reshape(len(DT_SWEEP), DT_WORLDS)
    alone_equal, float_err = [], []
    for i, cfg in enumerate(configs):
        dt8 = {"dt": torch.full((DT_WORLDS,), cfg.dt)}
        t_alone = art_sweep(w8, b8, DT_TICKS, cfg, gait, dt8, **kw_cpu).sim.t
        t_float = art_sweep(w8, b8, DT_TICKS, cfg, gait, {}, **kw_cpu).sim.t
        alone_equal.append(torch.equal(t_card[i], t_alone))
        float_err.append(float((t_card[i] - t_float).abs().max()))
    clocks = [float(t_card[i, 0]) for i in range(len(DT_SWEEP))]
    falls = [float(f) for f in out_c.metrics.falls.reshape(len(DT_SWEEP), DT_WORLDS).sum(1)]
    log(f"[numerics] dt sweep {json.dumps(DT_SWEEP)} x {DT_WORLDS} worlds x {DT_TICKS} ticks: "
        f"launches on the card {json.dumps(launches)}, finite {_finite(out_c.sim)}, card vs "
        f"CPU after 2 ticks {json.dumps(diffs2)} (bounds {json.dumps(CHAIN_BOUNDS)}), after "
        f"{DT_TICKS} ticks {json.dumps(diffs10)} (one shared dt {mpc.dt} on the same worlds: "
        f"{json.dumps(control10)}); clocks after {DT_TICKS} ticks {json.dumps(clocks)} s, "
        f"bit-equal to each config alone {alone_equal}, the float form within "
        f"{json.dumps(float_err)} s; falls per config {json.dumps(falls)}")
    if launches != {"fused_qp_solve": DT_TICKS, "fused_tick": 0, "fused_substeps": 0}:
        raise AssertionError(f"dt sweep launch counts {launches}")
    if not (_finite(out_c.sim) and all(alone_equal) and max(float_err) < 1e-6):
        raise AssertionError("the dt sweep failed its checks")
    if any(diffs2[k] >= b for k, b in CHAIN_BOUNDS.items()):
        raise AssertionError(f"the dt sweep on the card and on the CPU differ: {diffs2}")


def phase_sweep_numerics(torch, device):
    """Every dynamic config field per env (``raibert_pitch_place`` x
    ``admm_rho`` at 1024 envs, the QP kernel's per-env numerics, per-env
    ``dt``) -> (per-env QP ms, scalar QP ms)."""
    sweep_numerics_rollout(torch, device)
    _, ms_env, ms_scalar = numerics_kernel(torch, device)
    sweep_dt(torch, device)
    return ms_env, ms_scalar


class MujocoPlant:
    """MuJoCo CPU as the robot behind the Plant interface (the port's
    feedback of the MuJoCo state on the CPU), as tests/test_torch_deploy.py's."""

    def __init__(self, torch):
        import mujoco

        from biped_mpc_py_torch.sim import mj_driver
        from biped_mpc_py_torch.sim.engine import ArtState
        from biped_mpc_py_torch.sim.mjcf import penalty_matched_solref, to_mjcf
        from biped_mpc_py_torch.sim.model import hector_model

        self.mujoco, self.driver = mujoco, mj_driver
        self.model = hector_model(device="cpu")
        self.m = mujoco.MjModel.from_xml_string(to_mjcf(
            self.model, mj_driver.MJ_DT, contact=True, solref=penalty_matched_solref(self.model)))
        self.d = mujoco.MjData(self.m)
        s0 = ArtState.standing()
        self.d.qpos[0:3], self.d.qpos[3:7] = s0.pos[0].numpy(), s0.quat[0].numpy()
        self.d.qpos[7:17] = s0.q[0].numpy()
        self.t, self.forces, self.sec = 0.0, [], 0.0

    def read_state(self):
        from biped_mpc_py_torch.sim.engine import feedback_and_soles

        t0 = time.perf_counter()
        s = self.driver.state_from_mj(self.d, self.t, device="cpu")
        x, self.pf = feedback_and_soles(self.model, s)
        self.sec += time.perf_counter() - t0
        return x[0].numpy(), s.q[0].numpy(), s.qd[0].numpy()

    def foot_positions(self):
        self.read_state()
        return self.pf[0].numpy()

    def apply(self, tau, dt):
        t0 = time.perf_counter()
        self.d.qfrc_applied[6:16] = tau
        for _ in range(int(round(dt / self.driver.MJ_DT))):
            self.mujoco.mj_step(self.m, self.d)
        self.t += dt
        self.forces.append(self.driver.mj_foot_forces(self.m, self.d))
        self.sec += time.perf_counter() - t0

    def z(self) -> float:
        return float(self.d.qpos[2])

    def tick_forces(self):
        return np.asarray(self.forces).reshape(-1, 8, 2).mean(1)


def _plant(torch, device):
    return MujocoPlant(torch) if _have_mujoco() else EnginePlant(torch, device)


def _contact_stats(forces):
    """(mean total stance force after tick 10, per-foot duty factors) of
    per-tick per-foot forces (n, 2): tests/test_mj_contact.py:145-171."""
    return float(forces[10:].sum(1).mean()), [float((forces[:, i] > 20).mean()) for i in (0, 1)]


def _mj_controller_run(torch, mpc, gait, n_ticks, device, plant_device):
    """``n_ticks`` of ``MjController`` (the MuJoCo loop's three graphs) on
    ``device`` against an ``EnginePlant`` on ``plant_device``, walking in
    place, the graphs captured first -> (plant, controller seconds and
    plant seconds of the run, the run's launch counts)."""
    from biped_mpc_py_torch.sim.mj_driver import N_LL, MjController

    plant = EnginePlant(torch, plant_device)
    ctl = MjController(mpc, gait, device=device)
    ctl.warmup(plant.qpos_qvel)
    ll_dt = mpc.dt / N_LL
    _reset_counts()
    plant.sec = 0.0
    t0 = time.perf_counter()
    for k in range(n_ticks):
        ctl.tick(plant.qpos_qvel, lambda tau: plant.apply(tau, ll_dt), k * mpc.dt)
    sec = time.perf_counter() - t0
    return plant, sec, _counts()


def phase_mujoco(torch, device):
    """One robot walking in place for 100 ticks under the N = 1 controller
    on the card: through ``run_mujoco_closed_loop`` where MuJoCo is
    installed, else through its controller, ``MjController`` (three CUDA
    graphs), against ``EnginePlant``; then 5 ticks with the controller on
    the card against the same on the CPU. Returns ms per tick."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.parallel.rollout_art import art_mpc_config
    from biped_mpc_py_torch.sim.mj_driver import run_mujoco_closed_loop

    mpc, gait = art_mpc_config(**ORACLE_MPC), GaitConfig()
    bench = art_mpc_config(**ORACLE_MPC, n_admm_iters=40, admm_rho_phases=1,
                           admm_polish=False, kinv_ns_iters=10)
    cpu = torch.device("cpu")
    if _have_mujoco():
        plant_name = "MuJoCo (run_mujoco_closed_loop)"
        run_mujoco_closed_loop(mpc, gait, 1, device=device)  # warm-up
        _reset_counts()
        t0 = time.perf_counter()
        forces, _, fell = run_mujoco_closed_loop(mpc, gait, N_MJ_TICKS, device=device)
        sec = time.perf_counter() - t0
        launches = _counts()
        want_qp = N_MJ_TICKS + 1  # and the solve graph's capture warms up once
        runs = [run_mujoco_closed_loop(bench, gait, 5, device=d) for d in (device, cpu)]
        (f_c, x_c, _), (f_h, x_h, _) = runs
    else:
        plant_name = ("the port's engine (EnginePlant) under MjController, the MuJoCo loop's "
                      "three graphs (mujoco is not installed here)")
        plant, sec, launches = _mj_controller_run(torch, mpc, gait, N_MJ_TICKS, device, device)
        want_qp = N_MJ_TICKS
        plant_name += f", the plant {plant.sec * 1e3 / N_MJ_TICKS:.3f} ms of the tick"
        forces, fell = plant.tick_forces(), plant.z() < 0.25
        plants = [_mj_controller_run(torch, bench, gait, 5, d, cpu)[0] for d in (device, cpu)]
        (x_c, x_h) = (p.read_state()[0] for p in plants)
        f_c, f_h = (p.tick_forces() for p in plants)
    total, duty = _contact_stats(forces)
    d = np.abs(np.asarray(x_c) - np.asarray(x_h))
    diffs = {"att_pos": float(d[..., 0:6].max()), "vel": float(d[..., 6:12].max()),
             "force": float(np.abs(f_c - f_h).max())}
    log(f"[mujoco] plant: {plant_name}; 1 robot x {N_MJ_TICKS} ticks walking in place at "
        f"ORACLE_MPC: {sec * 1e3 / N_MJ_TICKS:.3f} ms/tick, launches {json.dumps(launches)}, "
        f"fell {fell}, mean total stance force after tick 10 {total:.2f} N (m g {MG:.2f}), duty "
        f"factors {duty[0]:.3f} {duty[1]:.3f}; 5 ticks, controller on the card vs the CPU "
        f"(bench budget): {json.dumps(diffs)} (bounds {json.dumps(MJ_BOUNDS)})")
    if launches["fused_qp_solve"] != want_qp or launches["fused_tick"]:
        raise AssertionError(f"N = 1 loop launch counts {launches} in {N_MJ_TICKS} ticks")
    if fell or abs(total - MG) > 0.1 * MG or any(abs(x - 0.5) > 0.1 for x in duty):
        raise AssertionError("the N = 1 walking loop failed its contact checks")
    if any(diffs[k] >= b for k, b in MJ_BOUNDS.items()):
        raise AssertionError(f"the N = 1 loop on the card and on the CPU differ: {diffs}")
    return sec * 1e3 / N_MJ_TICKS


def _stats_ok(stats, n):
    return (stats.n_ticks == n and stats.latency_p50_ms > 0
            and stats.latency_max_ms >= stats.latency_p99_ms >= stats.latency_p50_ms
            and 0 <= stats.deadline_misses <= n)


def phase_realtime(torch, device):
    """``RealtimeLoop`` on the card against a plant: 50 ticks as fast as
    possible, then 25 against the 40 ms deadlines; the latencies are
    reported, not bounded. Then the same loop with the controller on the
    CPU against the same kind of plant on the same device for 25 ticks, as
    a figure. Each run's plant time per tick is printed beside it (the
    controller's is the rest)."""
    from biped_mpc_py_torch import BipedParams, GaitConfig, RealtimeLoop
    from biped_mpc_py_torch.parallel.rollout_art import art_mpc_config

    mpc, gait = art_mpc_config(), GaitConfig()

    def run(plant, loop, n, **kw):
        sec = plant.sec
        stats = loop.run(plant, n, **kw)
        return stats, (plant.sec - sec) * 1e3 / n

    plant = _plant(torch, device)
    loop = RealtimeLoop(mpc, gait, BipedParams(), device=device)
    loop.warmup(plant)
    _reset_counts()
    fast = run(plant, loop, 50, realtime=False)
    timed = run(plant, loop, 25, t0=50 * mpc.dt, realtime=True)
    launches = _counts()
    z = plant.z()
    cpu = torch.device("cpu")
    plant_h = _plant(torch, device)
    loop_h = RealtimeLoop(mpc, gait, BipedParams(), device=cpu)
    loop_h.warmup(plant_h)
    host = run(plant_h, loop_h, 25, realtime=False)

    def fmt(r):
        s, plant_ms = r
        return (f"p50 {s.latency_p50_ms:.3f} p99 {s.latency_p99_ms:.3f} max "
                f"{s.latency_max_ms:.3f} ms (plant {plant_ms:.3f} ms per tick), misses "
                f"{s.deadline_misses}/{s.n_ticks}, realtime_ok {s.realtime_ok(mpc.dt)}")

    pools = ", ".join(f"{g.pool_mb:.1f}" for g in loop._graphs)
    log(f"[realtime] plant {type(plant).__name__} on {device.type}, controller on the card "
        f"(two CUDA graphs, pools {pools} MB): "
        f"50 ticks as fast as possible: {fmt(fast)}; 25 ticks against the deadlines: "
        f"{fmt(timed)}; torso z {z:.4f} m, launches {json.dumps(launches)}; controller on the "
        f"CPU (a figure): 25 ticks {fmt(host)}")
    fast, timed, host = fast[0], timed[0], host[0]
    if not (z > 0.4 and _stats_ok(fast, 50) and _stats_ok(timed, 25)):
        raise AssertionError("the real-time loop failed its checks")
    if launches["fused_qp_solve"] != 75:
        raise AssertionError(f"real-time loop launch counts {launches} in 75 ticks")
    return fast, timed, host


def replay_against_eager(torch, device, mpc, qpos):
    """Max |diff| of the exported frames ``qpos`` (n, 17) against an eager
    loop of ``art_closed_loop_tick`` at N = 1 from standing (the same
    physics: 5 substeps, Minv held all tick), for the frame's pos, quat and
    q."""
    from biped_mpc_py_torch import BipedParams, GaitConfig
    from biped_mpc_py_torch.parallel.rollout_art import art_closed_loop_tick, init_art_world
    from biped_mpc_py_torch.sim.model import hector_model

    w = init_art_world(mpc, 1, device=device)
    model, biped = hector_model(device=device), BipedParams().to(device)
    frames = []
    for _ in range(len(qpos)):
        w = art_closed_loop_tick(w, mpc, GaitConfig(), biped, model, n_substeps=5,
                                 minv_ll_hold=8)
        frames.append(torch.cat([w.sim.pos, w.sim.quat, w.sim.q], -1)[0])
    d = np.abs(torch.stack(frames).cpu().numpy() - qpos)
    return {"pos": float(d[:, 0:3].max()), "quat": float(d[:, 3:7].max()),
            "q": float(d[:, 7:17].max())}


def phase_replay_checkpoint(torch, device):
    """``export_rollout`` of 25 ticks of one robot on the card, reloaded
    (in MuJoCo where it is installed); then a tick-path world of 1024 envs
    saved at tick 10 and resumed, against the uninterrupted run at tick
    20."""
    import os
    import tempfile
    import xml.etree.ElementTree as ET

    from biped_mpc_py_torch import GaitConfig, batched_art_rollout_tick_kernel
    from biped_mpc_py_torch.parallel.rollout_art import art_mpc_config
    from biped_mpc_py_torch.sim.replay import export_rollout
    from biped_mpc_py_torch.utils.checkpoint import load_pytree, save_pytree

    mpc = art_mpc_config(n_admm_iters=40, admm_rho_phases=1, admm_polish=False,
                         kinv_ns_iters=10)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "flat")
        _reset_counts()
        info = export_rollout(prefix, mpc, GaitConfig(), 25, device=device, n_substeps=5,
                              minv_ll_hold=8)
        launches = _counts()
        qpos = np.load(prefix + "_traj.npz")["qpos"]
        frames_diff = replay_against_eager(torch, device, mpc, qpos)
        root = ET.parse(prefix + "_model.xml").getroot()
        n_bodies = len(root.findall(".//body"))
        feet = []
        if _have_mujoco():
            import mujoco

            m = mujoco.MjModel.from_xml_path(prefix + "_model.xml")
            dm = mujoco.MjData(m)
            for q in qpos:
                dm.qpos[:] = q
                mujoco.mj_forward(m, dm)
                feet.append(min(dm.geom_xpos[mujoco.mj_name2id(
                    m, mujoco.mjtObj.mjOBJ_GEOM, g)][2] for g in ("l_foot_toe", "r_foot_toe")))
        ckpt = os.path.join(d, "world.npz")
        mpc_a, gait = _art_config()
        w0, bipeds = art_worlds(torch, device)
        w10 = batched_art_rollout_tick_kernel(w0, bipeds, N_CKPT_TICKS, mpc_a, gait)
        save_pytree(ckpt, w10)
        straight = batched_art_rollout_tick_kernel(w10, bipeds, N_CKPT_TICKS, mpc_a, gait)
        back = load_pytree(ckpt, w0)
        resumed = batched_art_rollout_tick_kernel(back, bipeds, N_CKPT_TICKS, mpc_a, gait)
    leaves = [(k, getattr(a, f), getattr(b, f)) for k, a, b in (
        ("sim", resumed.sim, straight.sim), ("ctrl", resumed.ctrl, straight.ctrl),
        ("metrics", resumed.metrics, straight.metrics))
        for f in a.__dataclass_fields__ if torch.is_tensor(getattr(a, f))]
    equal = all(torch.equal(x, y) for _, x, y in leaves) and torch.equal(
        resumed.ctrl.qp.controls, straight.ctrl.qp.controls)
    z = qpos[:, 2]
    log(f"[replay] export_rollout of 25 ticks on the card: {json.dumps(info['frames'])} frames, "
        f"falls {info['falls']}, launches {json.dumps(launches)}, torso z [{z.min():.4f}, "
        f"{z.max():.4f}] m, {n_bodies} bodies in the MJCF"
        + (f", lowest toe per frame max {max(feet):.4f} m (MuJoCo)" if feet else
           " (mujoco is not installed here: the frames are not reloaded in it)")
        + f"; its frames (the plain chain's graph replayed at N = 1) against an eager loop "
        f"of art_closed_loop_tick: max |diff| {json.dumps(frames_diff)}"
        + f"; checkpoint: {N_ENVS} envs on the tick-kernel path saved at tick {N_CKPT_TICKS}, "
        f"resumed to tick {2 * N_CKPT_TICKS}: bit-equal to the run straight through {equal}")
    # 25 replays of the graph, and the capture's warm-up tick (it ran)
    if not (info["frames"] == 25 and info["falls"] == 0 and launches["fused_qp_solve"] == 26
            and 0.45 < z.min() and z.max() < 0.65 and n_bodies == 11
            and (not feet or max(feet) < 0.08)):
        raise AssertionError("the exported rollout failed its checks")
    if any(frames_diff[k] >= CHAIN_BOUNDS[k] for k in frames_diff):
        raise AssertionError(f"the replayed frames differ from the eager loop's: {frames_diff}")
    if not equal:
        raise AssertionError("a resumed checkpoint differs from the run straight through")


def phase_demo(torch, device):
    """``python -m biped_mpc_py_torch.demo --compat --rollout-steps 50
    --device cuda`` in a subprocess: exit code 0 and the tick's torques
    against the golden tick (tests/golden/tick_t0_walking.npz, 0.02 N m plus
    the printout's 0.005); the graphed tick's time (under a second) and the
    graphed rollout's real-time factor, as the demo prints them."""
    import os
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "biped_mpc_py_torch.demo", "--compat", "--rollout-steps", "50",
         "--device", device.type],
        capture_output=True, text=True, timeout=600, env=env, cwd=root,
    )
    sec = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the demo exited {out.returncode}: {out.stderr[-2000:]}")
    block = out.stdout.split("Torques:")[1].split("closed-loop")[0]
    tau = np.array([float(v) for v in re.findall(r"-?\d+\.\d*", block)])
    golden = np.load(root / "tests" / "golden" / "tick_t0_walking.npz")["tau"]
    err = float(np.abs(tau - golden).max()) if tau.shape == golden.shape else float("inf")
    lines = [ln for ln in out.stdout.splitlines()
             if "execution time" in ln or "rollout" in ln or "final state" in ln]
    tick_s = float(re.search(r"execution time: ([0-9.]+) seconds", out.stdout).group(1))
    realtime = float(re.search(r"\(([0-9.]+)x real-time\)", out.stdout).group(1))
    log(f"[demo] rc 0 in {sec:.1f} s (process included), torques vs golden max|d| {err:.4f} "
        f"N m (bound 0.025); the graphed tick {tick_s * 1e3:.3f} ms, the graphed rollout "
        f"{realtime:.0f}x real-time: " + " | ".join(ln.strip() for ln in lines))
    if not err < 0.025:
        raise AssertionError(f"the demo's torques are {err} N m from the golden tick")
    if not 0 < tick_s < 1.0:
        raise AssertionError(f"the demo's graphed tick took {tick_s} s")


N_SHARD_ART_TICKS = 10
SHARD_BOUND = 1.5e-3  # x_fb, two ranks against one: tests/test_rollout.py:273-281


def _same(torch, a, b) -> bool:
    """Every tensor leaf of two nests of TensorStructs bit-equal."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x) and not torch.equal(x, y):
            return False
        if dataclasses.is_dataclass(x) and not _same(torch, x, y):
            return False
    return True


def _rows(w):
    """This rank's rows of a sharded world."""
    return w.map(lambda t: t.to_local())


def _synced(torch, fn):
    """fn() -> (its result, host seconds between two synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _two_rank_srb(mesh, mpc, gait, ckpt):
    """One of two ranks on the card: its 512 of the 1024 SRB worlds (the
    smoke's robots) for 50 ticks, the world saved at tick 25 (its shards by
    ``save_pytree_dcp``, gathered whole by ``save_pytree``), after its
    robots' shards (the first save, which sets DCP up, untimed)."""
    import os

    import torch
    import torch.distributed as dist

    from biped_mpc_py_torch.ops.cuda import qp_kernel
    from biped_mpc_py_torch.parallel import sharding
    from biped_mpc_py_torch.parallel.rollout import randomize_params
    from biped_mpc_py_torch.utils.checkpoint import save_pytree, save_pytree_dcp

    bipeds = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device="cuda")
    ws = sharding.make_sharded_batch(mpc, N_ENVS, mesh)
    bs = sharding.shard_world(bipeds, mesh)
    sharding.sharded_rollout(ws, bs, 2, mpc, gait, mesh)  # warm-up: library load, first reduce
    dist.barrier()
    (w25, _), sec_a = _synced(torch, lambda: sharding.sharded_rollout(
        ws, bs, N_TICKS // 2, mpc, gait, mesh))
    save_pytree_dcp(os.path.join(ckpt, "robots"), bs)  # the first save sets DCP up: untimed
    dist.barrier()
    _, sec_save = _synced(torch, lambda: save_pytree_dcp(os.path.join(ckpt, "two"), w25))
    save_pytree(os.path.join(ckpt, "w25.npz"), w25)
    dist.barrier()
    (w50, summary), sec_b = _synced(torch, lambda: sharding.sharded_rollout(
        w25, bs, N_TICKS - N_TICKS // 2, mpc, gait, mesh))
    return dict(x_fb=w50.sim.x_fb, summary=summary, sec=sec_a + sec_b, save_sec=sec_save,
                launches=qp_kernel.fused_qp_solve.launches,
                device=torch.cuda.current_device())


def sharded_fns(torch, mesh, srb, art):
    """Phase 21 (a), the compiled forms: ``sharded_rollout_fn`` (50 SRB
    ticks) and ``sharded_art_rollout_fn`` (10 ticks of the plain chain) on
    the one NCCL rank, each bit-equal to its eager sharded loop and to the
    unsharded ``*_fn`` on the same worlds, with the eager loop's summary,
    one QP launch a tick and no physics launch; ms per tick of the graph
    call beside the eager sharded loop's (``srb`` and ``art``: sharded
    worlds and robots, config, gait, the eager loop's world and summary, and
    the unsharded worlds and robots)."""
    from biped_mpc_py_torch.parallel import sharding
    from biped_mpc_py_torch.parallel.rollout import batched_rollout_fn
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_fn

    kw = dict(n_substeps=5, minv_ll_hold=8)
    cases = {
        "SRB": (sharding.sharded_rollout_fn(N_TICKS, srb[2], srb[3], mesh),
                batched_rollout_fn(N_TICKS, srb[2], srb[3]), N_TICKS, srb),
        "articulated": (sharding.sharded_art_rollout_fn(N_SHARD_ART_TICKS, art[2], art[3], mesh,
                                                        **kw),
                        batched_art_rollout_fn(N_SHARD_ART_TICKS, art[2], art[3], **kw),
                        N_SHARD_ART_TICKS, art),
    }
    for name, (fn, unsharded, n, (ws, bs, _, _, w_eager, s_eager, w, b)) in cases.items():
        _, sec_capture = _synced(torch, lambda: fn(ws, bs))
        _reset_counts()
        (w_g, s_g), sec = _synced(torch, lambda: fn(ws, bs))
        launches = _counts()
        w_u = unsharded(w, b)
        equal = _same(torch, _rows(w_g), _rows(w_eager)), _same(torch, _rows(w_g), w_u)
        same_summary = ({k: float(v) for k, v in s_g.items()}
                        == {k: float(v) for k, v in s_eager.items()})
        log(f"[sharded] (a) {name} on the graph (sharded_*_fn), 1 rank over NCCL, {N_ENVS} "
            f"envs x {n} ticks: bit-equal to the eager sharded loop {equal[0]}, to the "
            f"unsharded *_fn {equal[1]}, the same summary {same_summary}; launches "
            f"{json.dumps(launches)}; {sec * 1e3 / n:.3f} ms per tick (first call, capture "
            f"included, {sec_capture:.3f} s)")
        if not (all(equal) and same_summary and launches == {
                "fused_qp_solve": n, "fused_tick": 0, "fused_substeps": 0}):
            raise AssertionError(f"the one-rank sharded {name} graph failed its checks")


def phase_sharded(torch, device):
    """Phase 21, the multi-device layer on the one card.

    (a) One rank over NCCL on ``cuda:0``: ``sharded_rollout`` of
    ``make_sharded_batch`` at 1024 envs x 50 SRB ticks and
    ``sharded_art_rollout`` of the articulated worlds x 10 ticks (5
    substeps, Minv held all tick), each bit-equal to its unsharded loop on
    the same worlds, with its launches (one QP a tick, no physics kernel),
    n_steps and zero falls; ms per tick of both, in turns; then their
    compiled forms (:func:`sharded_fns`). (b) Two ranks on
    the card over gloo (NCCL refuses two ranks on one device), 512 of the
    same 1024 SRB worlds each: the all-reduced summary equal to (a)'s
    (height within rtol 1e-5), x_fb within 1.5e-3. (c) Their tick-25 shards
    (``save_pytree_dcp``) loaded into the one-rank mesh (a reshard),
    bit-equal to the world they gathered at tick 25 (``save_pytree``);
    resumed 25 ticks, bit-equal to the run resumed from a one-rank save.
    (d) ``dryrun_multichip(1, device="cuda")``, the dry run's default
    path: one NCCL rank in a process of its own, its three phases checked.
    The SRB loop runs with the bf16 knobs off, the articulated one at
    ``_art_config()``.
    """
    import dataclasses
    import os
    import tempfile

    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.parallel import sharding
    from biped_mpc_py_torch.parallel.rollout import (
        batch_worlds, batched_rollout, randomize_params,
    )
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout
    from biped_mpc_py_torch.utils.checkpoint import load_pytree, load_pytree_dcp, save_pytree_dcp

    # the bf16 knobs off: (b) holds two ranks of 512 envs against one of 1024
    # pointwise, which the bf16 K^-1 product's rounding flips would not leave
    mpc, gait = dataclasses.replace(_walk_config(), **KNOBS_OFF), GaitConfig()
    with tempfile.TemporaryDirectory() as d, sharding.env_group(os.path.join(d, "store"), "nccl"):
        mesh = sharding.env_mesh("cuda")
        bipeds = randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
        bs = sharding.shard_world(bipeds, mesh)
        ws = sharding.make_sharded_batch(mpc, N_ENVS, mesh)
        sharding.sharded_rollout(ws, bs, 2, mpc, gait, mesh)  # warm-up: NCCL's first reduce

        # (a) SRB, then the articulated loop: checked runs first, then in turns
        _reset_counts()
        (w_s, s), sec_s1 = _synced(torch, lambda: sharding.sharded_rollout(
            ws, bs, N_TICKS, mpc, gait, mesh))
        launches = _counts()
        worlds = batch_worlds(mpc, N_ENVS, device=device)
        w_u, sec_u1 = _synced(torch, lambda: batched_rollout(worlds, bipeds, N_TICKS, mpc, gait))
        _, sec_u2 = _synced(torch, lambda: batched_rollout(worlds, bipeds, N_TICKS, mpc, gait))
        _, sec_s2 = _synced(torch, lambda: sharding.sharded_rollout(
            ws, bs, N_TICKS, mpc, gait, mesh))
        srb_equal = _same(torch, _rows(w_s), w_u)
        ms = [1e3 * t / N_TICKS for t in (sec_s1, sec_u1, sec_u2, sec_s2)]
        log(f"[sharded] (a) SRB, 1 rank over NCCL, {N_ENVS} envs x {N_TICKS} ticks: summary "
            f"{json.dumps({k: float(v) for k, v in s.items()})}, launches {json.dumps(launches)}, "
            f"bit-equal to batched_rollout {srb_equal}; ms per tick sharded {ms[0]:.3f}, "
            f"unsharded {ms[1]:.3f}, unsharded {ms[2]:.3f}, sharded {ms[3]:.3f}")
        if not (srb_equal and float(s["n_steps"]) == N_TICKS * N_ENVS and float(s["falls"]) == 0
                and launches == {"fused_qp_solve": N_TICKS, "fused_tick": 0, "fused_substeps": 0}):
            raise AssertionError("the one-rank sharded SRB loop failed its checks")

        mpc_a, gait_a = _art_config()
        aw, ab = art_worlds(torch, device)
        aws, abs_ = sharding.shard_world(aw, mesh), sharding.shard_world(ab, mesh)
        kw = dict(n_substeps=5, minv_ll_hold=8)
        _reset_counts()
        (a_s, a_sum), asec_s1 = _synced(torch, lambda: sharding.sharded_art_rollout(
            aws, abs_, N_SHARD_ART_TICKS, mpc_a, gait_a, mesh, **kw))
        alaunches = _counts()
        a_u, asec_u1 = _synced(torch, lambda: batched_art_rollout(
            aw, ab, N_SHARD_ART_TICKS, mpc_a, gait_a, **kw))
        _, asec_u2 = _synced(torch, lambda: batched_art_rollout(
            aw, ab, N_SHARD_ART_TICKS, mpc_a, gait_a, **kw))
        _, asec_s2 = _synced(torch, lambda: sharding.sharded_art_rollout(
            aws, abs_, N_SHARD_ART_TICKS, mpc_a, gait_a, mesh, **kw))
        art_equal = _same(torch, _rows(a_s), a_u)
        ams = [1e3 * t / N_SHARD_ART_TICKS for t in (asec_s1, asec_u1, asec_u2, asec_s2)]
        log(f"[sharded] (a) articulated, 1 rank over NCCL, {N_ENVS} envs x {N_SHARD_ART_TICKS} "
            f"ticks (plain chain, 5 substeps, Minv held): summary "
            f"{json.dumps({k: float(v) for k, v in a_sum.items()})}, launches "
            f"{json.dumps(alaunches)}, bit-equal to batched_art_rollout {art_equal}; ms per tick "
            f"sharded {ams[0]:.3f}, unsharded {ams[1]:.3f}, unsharded {ams[2]:.3f}, "
            f"sharded {ams[3]:.3f}")
        if not (art_equal and float(a_sum["n_steps"]) == N_SHARD_ART_TICKS * N_ENVS
                and float(a_sum["falls"]) == 0 and alaunches == {
                    "fused_qp_solve": N_SHARD_ART_TICKS, "fused_tick": 0, "fused_substeps": 0}):
            raise AssertionError("the one-rank sharded articulated loop failed its checks")

        # (a) the compiled forms on the same rank: one graph over its rows
        sharded_fns(torch, mesh, (ws, bs, mpc, gait, w_s, s, worlds, bipeds),
                    (aws, abs_, mpc_a, gait_a, a_s, a_sum, aw, ab))

        # (b) two ranks on the one card
        ckpt = os.path.join(d, "ckpt")
        ranks = sharding.spawn_env_group(2, _two_rank_srb, mpc, gait, ckpt, device="cuda",
                                         timeout=600)
        sums = [{k: float(v) for k, v in r["summary"].items()} for r in ranks]
        x_two = torch.cat([r["x_fb"] for r in ranks]).to(device)
        dx = float((x_two - w_u.sim.x_fb).abs().max())
        sec_two = max(r["sec"] for r in ranks)
        log(f"[sharded] (b) 2 ranks on the one card over gloo (cards "
            f"{[r['device'] for r in ranks]}), {N_ENVS // 2} envs each x {N_TICKS} ticks: summary "
            f"{json.dumps(sums[0])}, QP launches per rank {[r['launches'] for r in ranks]}; "
            f"against (a): max|dx_fb| {dx:.3e} (bound {SHARD_BOUND}), bit-equal {dx == 0.0}; "
            f"{sec_two * 1e3 / N_TICKS:.3f} ms per tick, "
            f"{N_ENVS * N_TICKS / sec_two:.1f} env-steps/s for the two, "
            f"{(sec_s1 + sec_s2) / 2 / sec_two:.3f}x one rank's rate in (a)")
        one = {k: float(v) for k, v in s.items()}
        if not (sums[0] == sums[1] and sums[0]["n_steps"] == one["n_steps"]
                and sums[0]["falls"] == one["falls"]
                and abs(sums[0]["height_rmse_sum"] - one["height_rmse_sum"])
                <= 1e-5 * abs(one["height_rmse_sum"])
                and dx <= SHARD_BOUND and all(r["launches"] == N_TICKS + 2 for r in ranks)):
            raise AssertionError("two ranks on the card disagree with one")

        # (c) the two ranks' checkpoint into the one-rank mesh
        robots = load_pytree_dcp(os.path.join(ckpt, "robots"), bs)  # the first load: untimed
        like = sharding.make_sharded_batch(mpc, N_ENVS, mesh)
        loaded, sec_load = _synced(torch, lambda: load_pytree_dcp(os.path.join(ckpt, "two"), like))
        gathered = load_pytree(os.path.join(ckpt, "w25.npz"), worlds)
        reshard_equal = _same(torch, _rows(loaded), gathered)
        _, sec_save1 = _synced(torch, lambda: save_pytree_dcp(
            os.path.join(ckpt, "one"), sharding.shard_world(gathered, mesh)))
        loaded1, sec_load1 = _synced(torch, lambda: load_pytree_dcp(os.path.join(ckpt, "one"),
                                                                    like))
        rest = N_TICKS - N_TICKS // 2
        r_two, _ = sharding.sharded_rollout(loaded, bs, rest, mpc, gait, mesh)
        r_one, _ = sharding.sharded_rollout(loaded1, bs, rest, mpc, gait, mesh)
        resume_equal = _same(torch, _rows(r_two), _rows(r_one))
        dx_resume = float((r_two.sim.x_fb.to_local() - x_two).abs().max())
        log(f"[sharded] (c) DCP, {N_ENVS}-env world at tick {N_TICKS // 2}: 2-rank save "
            f"{max(r['save_sec'] for r in ranks) * 1e3:.3f} ms, load into 1 rank (reshard) "
            f"{sec_load * 1e3:.3f} ms, bit-equal to the ranks' gathered world {reshard_equal}; "
            f"1-rank save {sec_save1 * 1e3:.3f} ms, load {sec_load1 * 1e3:.3f} ms; resumed "
            f"{rest} ticks bit-equal to the one-rank save's resume {resume_equal} (against "
            f"the two ranks' tick {N_TICKS}: max|dx_fb| {dx_resume:.3e})")
        if not (reshard_equal and resume_equal and _same(torch, _rows(robots), bipeds)):
            raise AssertionError("the resharded checkpoint differs")

    # (d) the dry run's command-line path: one NCCL rank of its own
    lines = sharding.dryrun_multichip(1, device="cuda", timeout=600)
    log(f"[sharded] (d) dryrun_multichip(1, device='cuda'): {len(lines)} lines")
    if not ("dryrun_multichip SRB OK: 1 ranks on cuda, 2 envs" in lines[0]
            and "dryrun_multichip ART OK: 1 ranks on cuda, 2 envs, 50 steps" in lines[1]
            and any(line.strip().startswith("ranks=1 envs=4 steps=50") for line in lines)):
        raise AssertionError(f"dryrun_multichip on the card failed its checks: {lines}")


def time_tick(torch, device):
    """The tick kernel (device time from ``torch.profiler``; the wrapper's
    call by CUDA events beside it) and its plain version at 1024 envs, and
    one tick of the tick-kernel path split into its stages (host clock,
    synchronized after each stage, mean of 10 ticks after 2)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick, fused_tick_reference
    from biped_mpc_py_torch.parallel import rollout_art as ra
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model, biped = hector_model(device=device), BipedParams().to(device)
    state, args = tick_inputs(torch, N_ENVS, SEED)
    sc, ac = state.to(device), [a.to(device) for a in args]
    Minv = mass_matrix_inv(model, sc.q)
    ms_k, = _device_ms(torch, lambda: fused_tick(model, biped, mpc, gait, sc, *ac, Minv),
                       ("tick_kernel",), 20)
    ms_call = _timed(torch, lambda: fused_tick(model, biped, mpc, gait, sc, *ac, Minv), 20)
    ms_p = _timed(torch, lambda: fused_tick_reference(model, biped, mpc, gait, sc, *ac, Minv), 3)
    log(f"[times] fused_tick ({N_ENVS} envs, 8 periods x 5 substeps): kernel {ms_k:.4f} ms of "
        f"device time (torch.profiler), {ms_call:.4f} ms per wrapper call (CUDA events), "
        f"plain {ms_p:.3f} ms")

    names = ("control stage (MPC)", "Minv", "tick kernel", "post")

    def tick_path_tick(w, mark):
        x_fb, t_g, hold, contact, sol = ra._art_control_stage(w, bipeds, mpc, gait, model)
        mark(names[0])
        Minv = mass_matrix_inv(model, w.sim.q)
        mark(names[1])
        sim, energy = fused_tick(model, biped, mpc, gait, w.sim, sol.controls[:, 0],
                                 contact[:, 0, 0:2], w.sim.t, w.ctrl.cmd_ref[:, 2],
                                 w.ctrl.v_int, Minv)
        mark(names[2])
        w = ra._art_post_stage(w, sim, energy, x_fb, sol, t_g, hold, mpc)
        mark(names[3])
        return w

    w, bipeds = art_worlds(torch, device)
    acc = _stage_split(torch, names, w, tick_path_tick)
    total = sum(acc.values())
    log("[times] art tick stages, tick-kernel path (ms, mean of 10): " + ", ".join(
        f"{k} {v:.3f}" for k, v in acc.items()) + f", total {total:.3f}")
    return ms_k, ms_p


PHYSICS_SIZES = (1024, 4096, 16384, 65536)


def physics_kernel_ms(torch, device, n, reps=10):
    """Device ms (``torch.profiler``) of one ``fused_substeps`` call (5
    substeps) and one ``fused_tick`` call (8 periods x 5 substeps) at ``n``
    perturbed in-contact envs -> (substep ms, tick ms)."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = _art_config()
    model, biped = hector_model(device=device), BipedParams().to(device)
    state, args = tick_inputs(torch, n, SEED)
    _, tau = perturbed_art_states(torch, n, SEED)
    sc, tc, ac = state.to(device), tau.to(device), [a.to(device) for a in args]
    Minv = mass_matrix_inv(model, sc.q)

    def both():
        fused_substeps(model, sc, tc, Minv, 0.005, 5)
        fused_tick(model, biped, mpc, gait, sc, *ac, Minv)

    return _device_ms(torch, both, ("substep_kernel", "tick_kernel"), reps)


def time_physics_sizes(torch, device):
    """Each physics kernel's device time, bound and share of it at 1024 to
    65,536 envs (the kernel only; the plain versions run at 1024)."""
    rows = []
    for n in PHYSICS_SIZES:
        ms_s, ms_t = physics_kernel_ms(torch, device, n)
        b_s, b_t = bound_substep(torch, device, n)[0], bound_tick(torch, device, n)[0]
        rows.append(f"{n} envs: fused_substeps {ms_s:.4f} ms (bound {b_s:.5f}, share "
                    f"{b_s / ms_s:.4f}), fused_tick {ms_t:.4f} ms (bound {b_t:.5f}, share "
                    f"{b_t / ms_t:.4f})")
    log("[times] physics kernels by size (device time, torch.profiler): " + "; ".join(rows))


def _union_ms(spans):
    """Length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_tick_path(torch, device, n_ticks=5, config=None):
    """One ``torch.profiler`` window of ``n_ticks`` steady tick-path ticks
    at ``config`` (default ``_art_config()``) -> (device kernels per tick,
    device busy ms per tick: the union of the device's activity intervals,
    QP kernel ms per tick, tick kernel ms per tick)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_tick_kernel
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = config or _art_config()
    model = hector_model(device=device)
    w, bipeds = art_worlds(torch, device)
    w = batched_art_rollout_tick_kernel(w, bipeds, 12, mpc, gait, model=model)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batched_art_rollout_tick_kernel(w, bipeds, n_ticks, mpc, gait, model=model)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device activity on the tick path")
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    by_name = {k: sum(e.time_range.end - e.time_range.start for e in dev if k in e.name) / 1e3
               for k in ("qp_admm", "tick_kernel")}
    return len(dev) / n_ticks, busy / n_ticks, by_name["qp_admm"] / n_ticks, \
        by_name["tick_kernel"] / n_ticks


GRAPH_TICKS = {"srb": N_TICKS, "tick": N_TICKS, "substep": N_COMPARE_TICKS, "plain": 10,
               "terrain": 10, "sweep": 10}
# Replay against eager when a leaf is not bit-equal (the op named in the
# log): the articulated paths at CHAIN_BOUNDS, the SRB path at the bound of
# phase 21's two ranks against one.
SRB_GRAPH_BOUND = 1.5e-3


def _graph_paths(torch, device):
    """{path: (eager(k): k ticks of the eager rollout, its compiled
    factory's fn, the fn's inputs, expected launches per tick)} for phase
    22, at phases 4, 9, 6, 10 and 15's configurations: the plain chain
    (flat, 5 substeps, Minv held all tick), the terrain walk (randomized
    robots on per-env 0.03 m 64 x 64 fields) and the 4 x 4 x 64 sweep (the
    tick path with the tick kernel's per-env variant)."""
    from biped_mpc_py_torch import GaitConfig
    from biped_mpc_py_torch.parallel import rollout as r
    from biped_mpc_py_torch.parallel import rollout_art as ra
    from biped_mpc_py_torch.parallel import sweep as sw

    srb = _walk_config()
    w_srb = r.batch_worlds(srb, N_ENVS, device=device)
    b_srb = r.randomize_params(torch.Generator().manual_seed(SEED), N_ENVS, device=device)
    mpc, gait = _art_config()
    w_art, b_art = art_worlds(torch, device)
    w_ter, b_ter, fields = terrain_setup(torch, device)
    mpc_s, gait_s, per_env, w_sw, b_sw, _ = sweep_setup(torch, device)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    n = GRAPH_TICKS
    qp_only = {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 0}
    per_period = {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 8}
    per_tick = {"fused_qp_solve": 1, "fused_tick": 1, "fused_substeps": 0}
    return {
        "srb": (lambda k: r.batched_rollout(w_srb, b_srb, k, srb, GaitConfig()),
                r.batched_rollout_fn(n["srb"], srb, GaitConfig()), (w_srb, b_srb), qp_only),
        "tick": (lambda k: ra.batched_art_rollout_tick_kernel(w_art, b_art, k, mpc, gait),
                 ra.batched_art_rollout_tick_kernel_fn(n["tick"], mpc, gait), (w_art, b_art),
                 per_tick),
        "substep": (lambda k: ra.batched_art_rollout_kernel(w_art, b_art, k, mpc, gait),
                    ra.batched_art_rollout_kernel_fn(n["substep"], mpc, gait), (w_art, b_art),
                    per_period),
        "plain": (lambda k: ra.batched_art_rollout(w_art, b_art, k, mpc, gait, **kw),
                  ra.batched_art_rollout_fn(n["plain"], mpc, gait, **kw), (w_art, b_art),
                  qp_only),
        "terrain": (lambda k: ra.batched_art_rollout_terrain(w_ter, b_ter, fields, k, mpc, gait,
                                                             **kw),
                    ra.batched_art_rollout_terrain_fn(n["terrain"], mpc, gait, **kw),
                    (w_ter, b_ter, fields), per_tick),
        "sweep": (lambda k: sw.art_sweep(w_sw, b_sw, k, mpc_s, gait_s, per_env, **kw),
                  sw.art_sweep_fn(n["sweep"], mpc_s, gait_s, **kw), (w_sw, b_sw, per_env),
                  per_tick),
    }


def _leaf_diffs(a, b) -> dict:
    """{field path: max |a - b|} over the leaves of two worlds that differ."""
    import dataclasses

    out = {}

    def walk(x, y, path):
        if hasattr(x, "__dataclass_fields__"):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), getattr(y, f.name), path + [f.name])
        elif x is not None and not bool((x == y).all()):
            out[".".join(path)] = float((x.double() - y.double()).abs().max())

    walk(a, b, [])
    return out


def sync_check(torch, paths):
    """One eager tick of each path under ``torch.cuda.set_sync_debug_mode
    ("error")``, after a tick that makes the constants: any host
    synchronization in the tick raises here, before a capture would."""
    for name, (eager, _, _, _) in paths.items():
        eager(1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    log(f"[graphs] one eager tick of each path ({', '.join(paths)}) under "
        "set_sync_debug_mode('error'): no host synchronization")


def profile_graph_ticks(torch, fn, inputs, n_ticks=5):
    """``torch.profiler`` over ``fn(*inputs)`` (a graph of ``n_ticks``
    replays) -> (device kernels per tick, device busy ms per tick, the
    window's device span per tick: first kernel's start to last kernel's
    end; the replays run back to back, so the span is the graph tick under
    the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*inputs)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device activity in the graph ticks")
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    span = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    return len(dev) / n_ticks, _union_ms(spans) / n_ticks, span / n_ticks


# the plain-chain paths' profiled windows: 2 graph ticks (~25k kernels each)
PROFILE_PLAIN_TICKS = 2


def phase_graphs(torch, device, eager_profile):
    """22. The compiled entry points (``*_fn``, one tick captured as a CUDA
    graph and replayed), at 1024 envs and the bench budget: SRB x 50 ticks,
    the tick path x 50, the substep path x 25. For each path: the replay
    against the eager loop from the same worlds (bit-equal, or within the
    stated bound with the differing leaves named), the launch counts of a
    graph call (counts set to 0 just before it), ms per tick in turns
    (eager, graph, graph, eager) and the graph pool's MB; then one
    ``torch.profiler`` window of 5 graph ticks of the tick path: device
    kernels, busy ms and the idle share, beside phase 13's eager figures."""
    from biped_mpc_py_torch.parallel import rollout_art as ra

    paths = _graph_paths(torch, device)
    sync_check(torch, paths)
    result = {}
    for name, (eager, fn, inputs, per_tick) in paths.items():
        n = GRAPH_TICKS[name]
        e1, sec_e1 = _synced(torch, lambda: eager(n))
        g0, sec_capture = _synced(torch, lambda: fn(*inputs))
        _reset_counts()
        g1, sec_g1 = _synced(torch, lambda: fn(*inputs))
        launches = _counts()
        g2, sec_g2 = _synced(torch, lambda: fn(*inputs))
        e2, sec_e2 = _synced(torch, lambda: eager(n))
        graph = next(iter(fn.graphs.values()))
        diffs = _leaf_diffs(e1, g0)
        again = [_leaf_diffs(g0, g) for g in (g1, g2)] + [_leaf_diffs(e1, e2)]
        want = {k: v * n for k, v in per_tick.items()}
        ms = [sec * 1e3 / n for sec in (sec_e1, sec_g1, sec_g2, sec_e2)]
        capture_s = sec_capture - (sec_g1 + sec_g2) / 2
        log(f"[graphs] {name}: {N_ENVS} envs x {n} ticks; replay vs eager: "
            + ("bit-equal" if not diffs else f"differ in {json.dumps(diffs)}")
            + f"; graph calls and eager runs repeat bit-equal: {not any(again)}; launches of a "
            f"graph call {json.dumps(launches)} (want {json.dumps(want)}); ms per tick in turns "
            f"(eager, graph, graph, eager): {ms[0]:.3f}, {ms[1]:.3f}, {ms[2]:.3f}, {ms[3]:.3f}; "
            f"first call (capture + {n} ticks) {sec_capture:.3f} s, the capture about "
            f"{capture_s:.3f} s; graph pool {graph.pool_mb:.1f} MB")
        if launches != want:
            raise AssertionError(f"graph launch counts {launches}, want {want}")
        if any(again):
            raise AssertionError(f"repeated runs differ: {again}")
        if diffs:
            sim = _max_diff(e1.sim, g0.sim, CHAIN_BOUNDS) if name != "srb" else \
                {"x_fb": float((e1.sim.x_fb - g0.sim.x_fb).abs().max())}
            bounds = CHAIN_BOUNDS if name != "srb" else {"x_fb": SRB_GRAPH_BOUND}
            if any(sim[k] >= v for k, v in bounds.items()):
                raise AssertionError(f"{name}: replay and eager differ past {bounds}: {sim}")
        result[name] = {"ms": ms, "pool_mb": graph.pool_mb, "bit_equal": not diffs,
                        "capture_s": capture_s}

    w, b = paths["tick"][2]
    mpc, gait = _art_config()
    fn5 = ra.batched_art_rollout_tick_kernel_fn(5, mpc, gait)
    kernels, busy, span = profile_graph_ticks(torch, fn5, (w, b))
    graph_ms = sum(result["tick"]["ms"][1:3]) / 2
    e_kernels, e_busy, e_tick_ms = eager_profile
    log(f"[graphs] profile, tick path, 5 graph ticks: {kernels:.1f} device kernels per tick, "
        f"device busy {busy:.3f} ms of a {span:.3f} ms profiled tick: the card idles "
        f"{1 - busy / span:.3f} of it (against the unprofiled graph tick of {graph_ms:.3f} ms: "
        f"{1 - busy / graph_ms:.3f}; the profiler stretches the kernels); eager, phase 13: "
        f"{e_kernels:.1f} kernels, busy {e_busy:.3f} of {e_tick_ms:.3f} ms, idle "
        f"{1 - e_busy / e_tick_ms:.3f}")
    from biped_mpc_py_torch.parallel import sweep as sw

    kw = dict(n_substeps=5, minv_ll_hold=8)
    mpc_s, gait_s = sweep_setup(torch, device)[0:2]
    short = {"plain": ra.batched_art_rollout_fn(PROFILE_PLAIN_TICKS, mpc, gait, **kw),
             "terrain": ra.batched_art_rollout_terrain_fn(PROFILE_PLAIN_TICKS, mpc, gait, **kw),
             "sweep": sw.art_sweep_fn(PROFILE_PLAIN_TICKS, mpc_s, gait_s, **kw)}
    for name, fn in short.items():
        kernels, busy, span = profile_graph_ticks(torch, fn, paths[name][2],
                                                  PROFILE_PLAIN_TICKS)
        graph_ms = sum(result[name]["ms"][1:3]) / 2
        result[name]["idle"] = 1 - busy / graph_ms
        log(f"[graphs] profile, {name}, {PROFILE_PLAIN_TICKS} graph ticks: {kernels:.1f} device "
            f"kernels per tick, device busy {busy:.3f} ms of a {span:.3f} ms profiled tick (idle "
            f"{1 - busy / span:.3f}); against the unprofiled graph tick of {graph_ms:.3f} ms the "
            f"card idles {1 - busy / graph_ms:.3f}")
    return result


# The bench's art configuration (``art_mpc_config()``, walking in place)
# runs identical robots, so each articulated run is one trajectory, and at
# the bf16 knobs a solve is discontinuous in roundoff: whether that
# one walk falls in 50 ticks is a draw. From the bench's robots started 1e-6
# rad apart the JAX package's own paths drop some of 1024
# (``JAX_START_FALLS``), so the falls of the knobs-on identical runs are
# reported, and the knobs-on paths are held on those starts instead
# (``phase_bench_starts``). Falls are bounded (to none) on the SRB runs and
# on the articulated paths with the knobs off, the budget that
# tests/test_rollout_art.py::test_articulated_bench_budget_accuracy
# validates; on terrain they are reported.
BENCH_ART = {"BENCH_MODE": "art"}
BENCH_KNOBS_OFF = {"BENCH_NS_BF16": "0", "BENCH_BF16_MATVEC": "0", "BENCH_RUIZ_BF16": "0"}
# (label, BENCH_* variables, falls bounded) at 1024 envs x 50 ticks; SRB and
# the tick path again at BENCH_SIZES
BENCH_RUNS = (
    ("srb", {}, True),
    ("srb randomized", {"BENCH_RANDOMIZE": "1"}, True),
    ("tick", BENCH_ART, False),
    ("substep", BENCH_ART | {"BENCH_ART_BACKEND": "kernel"}, False),
    ("plain", BENCH_ART | {"BENCH_ART_BACKEND": "xla"}, False),
    ("terrain randomized", BENCH_ART | {"BENCH_TERRAIN": str(TERRAIN_AMPLITUDE),
                                        "BENCH_RANDOMIZE": "1"}, False),
    ("tick knobs off", BENCH_ART | BENCH_KNOBS_OFF, True),
    ("substep knobs off", BENCH_ART | BENCH_KNOBS_OFF | {"BENCH_ART_BACKEND": "kernel"}, True),
    ("plain knobs off", BENCH_ART | BENCH_KNOBS_OFF | {"BENCH_ART_BACKEND": "xla"}, True),
)
BENCH_SIZES = (256, 4096, 16384)
# launches per tick by the bench's path
BENCH_LAUNCHES = {
    "srb": {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 0, "fused_ruiz": 1},
    "tick": {"fused_qp_solve": 1, "fused_tick": 1, "fused_substeps": 0, "fused_ruiz": 1},
    "kernel": {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 8, "fused_ruiz": 1},
    "plain": {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 0, "fused_ruiz": 1},
    "terrain": {"fused_qp_solve": 1, "fused_tick": 1, "fused_substeps": 0, "fused_ruiz": 1},
}


def _bench_ok(result, name, falls_bounded):
    """Raise unless the bench result ``result`` launched its path's kernels
    once (eight times) a tick, ended finite, counted no more non-finite
    resets than falls and, where ``falls_bounded``, fell nowhere."""
    want = {k: v * result["steps"] for k, v in BENCH_LAUNCHES[result["path"]].items()}
    checks = result["checks"]
    if result["launches"] != want:
        raise AssertionError(f"bench {name}: launches {result['launches']}, want {want}")
    if not checks["finite"]:
        raise AssertionError(f"bench {name}: non-finite states")
    if falls_bounded and checks["falls"] != 0:
        raise AssertionError(f"bench {name}: {checks['falls']} falls")
    if checks["nonfinite_resets"] > checks["falls"]:  # each such reset is a fall
        raise AssertionError(f"bench {name}: {checks['nonfinite_resets']} non-finite resets, "
                             f"{checks['falls']} falls")


# The falls of the bench's art configuration at the bf16 knobs in the JAX
# package, 1024 envs x 50 ticks from the bench's identical robots started
# with seeded numpy noise of START_NOISE_RAD on the joint angles: python -m
# tests.jax_bench_accuracy art-starts 1024 (the CPU; the Pallas kernels in
# interpret mode). By the bench's path name.
JAX_START_FALLS = {"plain": 0, "kernel": 22, "tick": 27}
START_NOISE_RAD = 1e-6


def phase_bench_starts(torch):
    """23(b). The knobs-on articulated paths from the bench's robots
    started ``START_NOISE_RAD`` apart, as ``tests/jax_bench_accuracy.py
    art-starts`` makes them: each path's envs that fell in ``N_TICKS``, held
    to twice the JAX package's count on the same starts plus 10 (its binomial
    spread at ~2% is ~5). -> {path: falls}."""
    import dataclasses
    import gc

    from biped_mpc_py_torch import bench

    noise = START_NOISE_RAD * np.random.default_rng(0).normal(size=(N_ENVS, 10))
    out = {}
    for path, backend in (("tick", "tick"), ("kernel", "kernel"), ("plain", "xla")):
        plan = bench.resolve(BENCH_ART | {"BENCH_ART_BACKEND": backend, "BENCH_ENVS": str(N_ENVS),
                                          "BENCH_STEPS": str(N_TICKS)})
        fn, (worlds, bipeds) = bench.build(plan)
        q = worlds.sim.q + torch.from_numpy(noise.astype(np.float32)).to(worlds.sim.q.device)
        world = fn(dataclasses.replace(worlds, sim=dataclasses.replace(worlds.sim, q=q)), bipeds)
        checks = bench.walk_checks(world, "art")
        falls = int((world.metrics.falls > 0).sum())
        del fn, world
        gc.collect()
        torch.cuda.empty_cache()
        bound = 2 * JAX_START_FALLS[path] + 10
        log(json.dumps({"bench_starts": path, "envs_fell": falls, "bound": bound,
                        "jax_envs_fell": JAX_START_FALLS[path]} | checks))
        if not checks["finite"] or falls > bound:
            raise AssertionError(f"bench starts {path}: {falls} of {N_ENVS} envs fell (bound "
                                 f"{bound}), finite {checks['finite']}")
        out[path] = falls
    return out


def phase_bench_shadow(torch):
    """23(c). The bench's knobs-on substep-path run (its identical robots,
    ``N_ENVS`` x ``N_TICKS``) eagerly, each substep launch held against its
    plain version on the same inputs: ``SUBSTEP_BOUNDS`` times the field's
    largest value where that passes 1 (a falling robot moves fast). Shows
    whether the kernel, launch by launch, is where the walk's fall comes
    from. -> (envs that fell, the largest error by field)."""
    from biped_mpc_py_torch import bench
    from biped_mpc_py_torch.ops.cuda import substep_kernel
    from biped_mpc_py_torch.parallel import rollout_art

    plan = bench.resolve(BENCH_ART | {"BENCH_ART_BACKEND": "kernel", "BENCH_ENVS": str(N_ENVS),
                                      "BENCH_STEPS": str(N_TICKS)})
    _, (worlds, bipeds) = bench.build(plan)
    worst = dict.fromkeys(SUBSTEP_BOUNDS, 0.0)
    bad = []

    def shadow(model, sim, tau, Minv, dt, n):
        out = substep_kernel.fused_substeps(model, sim, tau, Minv, dt, n)
        ref = substep_kernel.fused_substeps_reference(model, sim, tau, Minv, dt, n)
        for k, bound in SUBSTEP_BOUNDS.items():
            a, b = getattr(out, k), getattr(ref, k)
            err = float((a - b).abs().max())
            worst[k] = max(worst[k], err)
            if not err <= bound * max(1.0, float(b.abs().max())):
                bad.append((k, err))
        return out

    rollout_art.fused_substeps = shadow
    try:
        world = rollout_art.batched_art_rollout_kernel(
            worlds, bipeds, N_TICKS, plan.mpc, plan.gait, n_substeps=plan.n_substeps,
            minv_ll_hold=plan.minv_ll_hold)
    finally:
        rollout_art.fused_substeps = substep_kernel.fused_substeps
    falls = int((world.metrics.falls > 0).sum())
    log(json.dumps({"bench_shadow": "kernel", "envs_fell": falls, "max_abs_err": worst,
                    "past_bound": len(bad)} | bench.walk_checks(world, "art")))
    if bad:
        raise AssertionError(f"bench shadow: substep kernel vs plain past the bound {bad[:5]}")
    return falls, worst


def phase_bench(torch, device, name):
    """23. ``biped_mpc_py_torch.bench``, the port's headline entry point:
    ``run`` in process over ``BENCH_RUNS`` at 1024 envs x 50 ticks, SRB and
    the tick path at ``BENCH_SIZES``, then the command in a subprocess.
    -> {label: result}."""
    import gc
    import os

    from biped_mpc_py_torch import bench

    runs = [(label, env | {"BENCH_ENVS": str(N_ENVS)}, bounded)
            for label, env, bounded in BENCH_RUNS]
    runs += [(f"{label} {n}", env | {"BENCH_ENVS": str(n)}, bounded)
             for label, env, bounded in BENCH_RUNS if label in ("srb", "tick")
             for n in BENCH_SIZES]
    out = {}
    for label, env, bounded in runs:
        result = bench.run(env | {"BENCH_STEPS": str(N_TICKS)})
        gc.collect()  # the run's graphs and their pools
        torch.cuda.empty_cache()
        log(json.dumps({"bench": label} | result))
        _bench_ok(result, label, bounded)
        out[label] = result
    root = os.path.dirname(os.path.abspath(__file__))
    clean = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "biped_mpc_py_torch.bench"], env=clean,
                         cwd=root, capture_output=True, text=True, timeout=300)
    sec = time.perf_counter() - t0
    for line in cli.stderr.splitlines()[-4:]:
        log(f"[bench] cli stderr: {line}")
    lines = cli.stdout.splitlines()
    if cli.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench cli: exit {cli.returncode}, stdout {cli.stdout!r}")
    result = json.loads(lines[0])
    log(json.dumps({"bench": "cli", "wall_s": sec} | result))
    want = {"metric": bench.METRIC, "path": "srb", "envs": N_ENVS, "steps": N_TICKS,
            "device": name}
    if {k: result.get(k) for k in want} != want:
        raise AssertionError(f"bench cli: {result}, want {want}")
    _bench_ok(result, "cli", True)
    out["cli"] = result
    out["starts"] = phase_bench_starts(torch)
    out["shadow"] = phase_bench_shadow(torch)
    return out


TOOL_STEPS = 25
TOOL_REPS = 2
# each tool's variants whose final world must be finite
TOOL_BASES = {"bench_tick_stages": ("base",), "bench_tick_kernel": ("tick", "substep"),
              "bench_art_probe": ("base", "base-knobs-off")}


def phase_tools(torch):
    """24. Each stage-timing tool's ``run`` at ``N_ENVS`` envs,
    ``TOOL_STEPS`` ticks or calls per stage, ``TOOL_REPS`` rounds in turns;
    the records printed and gated (the docstring's item 24). -> {tool:
    records}."""
    import gc

    from biped_mpc_py_torch.tools import (
        bench_art_probe,
        bench_art_stages,
        bench_cone_kernel,
        bench_stages,
        bench_tick_kernel,
        bench_tick_stages,
    )

    t0 = time.perf_counter()
    out = {}
    for mod in (bench_tick_stages, bench_tick_kernel, bench_stages, bench_art_stages,
                bench_art_probe, bench_cone_kernel):
        t_mod = time.perf_counter()
        records = mod.run(N_ENVS, TOOL_STEPS, TOOL_REPS)
        gc.collect()  # the tool's graphs and their pools
        torch.cuda.empty_cache()
        for r in records:
            log(json.dumps({"tools": mod.TOOL} | r))
        by_name = {r["name"]: r for r in records}
        bad = [(r["name"], r["launches"]) for r in records
               if "launches" in r and r["launches"] != mod.LAUNCHES[r["name"]]]
        bad += [(k, "not finite") for k in TOOL_BASES.get(mod.TOOL, ())
                if not by_name[k]["finite"]]
        if mod is bench_tick_stages:
            total = sum(by_name["attribution"]["ms"].values())
            if abs(total - by_name["base"]["ms"]) > 1e-6 * by_name["base"]["ms"]:
                bad.append(("attribution", total))
        if mod is bench_cone_kernel:
            bad += [("agreement", f) for f in bench_cone_kernel.agreement_faults(
                by_name["agreement"])]
        if bad:
            raise AssertionError(f"tools {mod.TOOL}: {bad}")
        log(f"[tools] {mod.TOOL}: {len(records)} records in {time.perf_counter() - t_mod:.1f} s")
        out[mod.TOOL] = records
    attribution = out["bench_tick_stages"][-1]["ms"]
    log("[tools] attribution of the tick path's graph tick (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in attribution.items()))
    log(f"[tools] phase 24 in {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    name, _ = phase_device(torch)
    device = torch.device("cuda", 0)
    phase_build()
    from biped_mpc_py_torch.utils.precision import f32_matmul

    with torch.no_grad(), f32_matmul():
        qp_err = phase_kernel(torch, device)
        ruiz = phase_ruiz(torch, device)
        srb_launches, sec_k, sec_p, w_bench = phase_slice(torch, device)
        substep_err = phase_substep_kernel(torch, device)
        art_launches, sec_art, w25_substep = phase_art_slice(torch, device)
        probe = phase_probe(torch, device)
        tick_err = phase_tick_kernel(torch, device)
        tick_launches, sec_tick = phase_tick_path(torch, device, w25_substep)
        _, sec_terrain, field, tick_field = phase_terrain(torch, device)
        phase_cmd_rollout(torch, device)
        solve_ms = time_solves(torch, device)
        phase_bench_accuracy(w_bench, time_default_rollouts(torch, device))
        time_stages(torch, device)
        substep_ms, substep_plain_ms, sec_chain = time_art(torch, device)
        tick_ms, tick_plain_ms = time_tick(torch, device)
        time_terrain(torch, device, sec_terrain, sec_chain)
        time_physics_sizes(torch, device)
        events, busy_ms, qp_tick_ms, tick_tick_ms = profile_tick_path(torch, device)
        tick_table = phase_sweep(torch, device)
        phase_sweep_numerics(torch, device)
        phase_mujoco(torch, device)
        phase_realtime(torch, device)
        phase_replay_checkpoint(torch, device)
        phase_demo(torch, device)
        phase_sharded(torch, device)
        phase_graphs(torch, device, (events, busy_ms, sec_tick * 1e3 / N_ART_TICKS))
        phase_bench(torch, device, name)
        phase_tools(torch)
        bounds = {"fused_qp_solve": solve_ms["bench"][2:4],
                  "fused_substeps": bound_substep(torch, device),
                  "fused_tick": bound_tick(torch, device),
                  "probe_ops": bound_probe(torch, device),
                  "fused_ruiz": ruiz["bound"],
                  "fused_substeps_field": field["bound"],
                  "fused_tick_field": tick_field["bound"],
                  "fused_tick_table": tick_table["bound"]}
    log("[bounds] " + json.dumps(bounds))
    rate_k = N_ENVS * N_TICKS / sec_k
    rate_p = N_ENVS * N_TICKS / sec_p
    log(f"[times] rollout {N_ENVS} envs x {N_TICKS} ticks: kernel {rate_k:.1f} env-steps/s "
        f"({sec_k * 1e3 / N_TICKS:.3f} ms/tick), plain core {rate_p:.1f} env-steps/s "
        f"({sec_p * 1e3 / N_TICKS:.3f} ms/tick) (SRB launches {srb_launches})")
    log(f"[times] art rollout {N_ENVS} envs x {N_ART_TICKS} ticks: tick-kernel path "
        f"{N_ENVS * N_ART_TICKS / sec_tick:.1f} env-steps/s ({sec_tick * 1e3 / N_ART_TICKS:.3f} "
        f"ms/tick); substep-kernel path {N_ENVS * N_ART_TICKS / sec_art:.1f} env-steps/s "
        f"({sec_art * 1e3 / N_ART_TICKS:.3f} ms/tick); plain chain "
        f"{N_ENVS / sec_chain:.1f} env-steps/s")
    tick_path_ms = sec_tick * 1e3 / N_ART_TICKS
    log(f"[profile] tick-kernel path, 5 steady ticks: {events:.1f} device kernels per tick, "
        f"device busy {busy_ms:.3f} ms per tick (QP kernel {qp_tick_ms:.3f} ms, "
        f"{qp_tick_ms / busy_ms:.3f} of it; tick kernel {tick_tick_ms:.3f} ms); against the unprofiled {tick_path_ms:.3f} ms "
        f"tick above, the card idles {1 - busy_ms / tick_path_ms:.3f} of the tick")
    kernels = [
        {
            "name": "fused_qp_solve",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/qp_admm.cu",
            "replaces": "biped_mpc_py_tpu/ops/pallas/qp_kernel.py:255",
            "launches": tick_launches["fused_qp_solve"],
            # the largest of the checks with a per-env bound (bench-f32,
            # bench-ns); the knobs-on bench's, held to its noise floor, beside
            "max_abs_err": max(qp_err["bench-f32"], qp_err["bench-ns"]),
            "max_abs_err_knobs_on": qp_err["bench"],
            "ms": solve_ms["bench"][0],
            "plain_ms": solve_ms["bench"][1],
            "ms_knobs_off": solve_ms["bench-f32"][0],
            "plain_ms_knobs_off": solve_ms["bench-f32"][1],
            "bound_ms_knobs_off": solve_ms["bench-f32"][2],
        },
        {
            "name": "fused_substeps",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/substep.cu",
            "replaces": "biped_mpc_py_tpu/ops/pallas/substep_kernel.py:466",
            "launches": art_launches["fused_substeps"],
            "max_abs_err": substep_err,
            "ms": substep_ms,
            "plain_ms": substep_plain_ms,
        },
        {
            "name": "fused_substeps_field",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/substep.cu",
            # none: the JAX package steps a height field with the plain chain
            # (biped_mpc_py_tpu/sim/engine.py::art_step)
            "replaces": None,
            # phase 10's 50 terrain ticks: none since the terrain path runs
            # the tick kernel's field variant (fused_tick_field)
            "launches": field["launches"],
            # rough fields at 1024 and 4096 envs against art_step
            "max_abs_err": field["max_abs_err"],
            # 4096 envs
            "ms": field["ms"],
            "plain_ms": field["plain_ms"],
        },
        {
            "name": "fused_tick_field",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/tick.cu",
            # none: the JAX package runs a height field on the plain chain
            # (biped_mpc_py_tpu/parallel/rollout_art.py, art_step and the
            # plain low-level control)
            "replaces": None,
            # phase 10's 50 terrain ticks, 1 a tick
            "launches": tick_field["launches"],
            # rough fields at 1024 and 4096 envs against its plain version
            "max_abs_err": tick_field["max_abs_err"],
            # 4096 envs
            "ms": tick_field["ms"],
            "plain_ms": tick_field["plain_ms"],
        },
        {
            "name": "fused_tick_table",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/tick.cu",
            # none: the JAX package runs a config per env on the plain chain
            # (biped_mpc_py_tpu/parallel/sweep.py; the Pallas kernel closes
            # over one config)
            "replaces": None,
            # phase 15's 25 sweep ticks, 1 a tick
            "launches": tick_table["launches"],
            # four configs at 1024 and 4096 envs against its plain version
            "max_abs_err": tick_table["max_abs_err"],
            # 4096 envs
            "ms": tick_table["ms"],
            "plain_ms": tick_table["plain_ms"],
        },
        {
            "name": "fused_tick",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/tick.cu",
            "replaces": "biped_mpc_py_tpu/ops/pallas/tick_kernel.py:531",
            "launches": tick_launches["fused_tick"],
            "max_abs_err": tick_err,
            "ms": tick_ms,
            "plain_ms": tick_plain_ms,
        },
        {
            "name": "fused_ruiz",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/ruiz.cu",
            # none: the JAX package's Ruiz (biped_mpc_py_tpu/ops/qp.py:445) is plain jnp
            "replaces": None,
            # the tick path's 50-tick rollout of phase 25, one launch a tick
            "launches": ruiz["launches"],
            "max_abs_err": ruiz["max_abs_err"],
            "max_ulps": ruiz["max_ulps"],
            # 4096 envs, warm: bf16 norms (the bench budget), f32 beside
            "ms": ruiz["ms"],
            "plain_ms": ruiz["plain_ms"],
            "ms_f32": ruiz["ms_f32"],
            "plain_ms_f32": ruiz["plain_ms_f32"],
            "bound_ms_f32": ruiz["bound_ms_f32"],
        },
        {
            "name": "probe_ops",
            "route": "cuda",
            "source": "biped_mpc_py_torch/csrc/probe_ops.cu",
            "replaces": "tools/probe_mosaic_ops.py:49",
            "launches": probe[0],
            "max_abs_err": probe[1],
            "ms": probe[2],
            "plain_ms": probe[3],
        },
    ]
    for k in kernels:
        # No single PyTorch call computes any of these functions.
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

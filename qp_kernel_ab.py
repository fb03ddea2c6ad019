#!/usr/bin/env python3
"""The QP kernel of this checkout against another source of the same C
interface (for example a parent commit's), on one card, in turns.

    mkdir -p build/ab
    git show <commit>:biped_mpc_py_torch/csrc/qp_admm.cu > build/ab/qp_admm_base.cu
    python3 qp_kernel_ab.py build/ab/qp_admm_base.cu

The other source is built under ``build/`` (git-ignored) with ``nvcc
-Xptxas -v`` (printed) and launched through its own C function; the
checkout's kernel runs through its wrapper, ``fused_qp_solve``. The two take
turns (base, new, new, base) as the rollouts' QP solve, routed as
``chip_smoke.py`` routes its plain-core runs, for:

1. the solve at 1024 envs, bench and default budgets, also with
   ``ns_iters=0`` and ``n_iters=0`` (CUDA events over repeated launches);
2. the SRB rollout, 1024 envs x 50 ticks, at the bench and default budgets;
3. the tick-kernel path, 1024 envs x 250 ticks;
4. ``chip_smoke.profile_tick_path``: device busy and QP kernel ms per tick.

Each measurement is printed as one JSON line; all go to ``--out``. Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from biped_mpc_py_torch.ops.cuda import build, qp_kernel

TURNS = ("base", "new", "new", "base")


def launcher(source: Path):
    """A solve with ``fused_qp_solve``'s signature that launches the kernel
    built from ``source`` (the ``qp_admm_solve`` C interface)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = build.load(source, {
        "qp_admm_solve": ([ptr] * 11 + [i32] * 3 + [f32] * 3 + [i32] * 4 + [i32, ptr], i32),
    })

    def solve(P, Ah, q, l, u, x0, z0, y0, *, rho, n_iters, n_phases, ns_iters, sigma,
              alpha, polish):
        n_env, h, m, _ = Ah.shape
        x, z, y = torch.empty_like(q), torch.empty_like(l), torch.empty_like(l)
        rc = lib.qp_admm_solve(
            *[t.data_ptr() for t in (P, Ah, q, l, u, x0, z0, y0, x, z, y)],
            n_env, h, m, float(rho), float(sigma), float(alpha), int(n_iters),
            int(n_phases), int(ns_iters), int(bool(polish)), P.device.index,
            torch.cuda.current_stream(P.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{source.name}: qp_admm_solve failed ({rc})")
        return x, z, y

    return solve


def solve_times(solvers, device, emit):
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.ops import qp as tqp

    for budget, mpc in (("bench", cs._walk_config()), ("default", MpcConfig())):
        qp = cs.mpc_qps(torch, mpc, cs.N_ENVS, device, cs.SEED)
        Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters)
        args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
        kw = tqp.solver_args(mpc)
        for variant, over in (("full", {}), ("ns_iters=0", {"ns_iters": 0}),
                              ("n_iters=0", {"n_iters": 0})):
            for version in TURNS:
                solve, kw_v = solvers[version], {**kw, **over}
                ms = cs._timed(torch, lambda: solve(*args, **kw_v), 20)
                emit(what="solve", budget=budget, variant=variant, version=version, ms=ms)


def rollout_rates(solvers, device, emit):
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_tick_kernel
    from biped_mpc_py_torch.sim.model import hector_model

    for budget, mpc in (("bench", None), ("default", MpcConfig(x_cmd=cs.WALK_CMD))):
        for version in TURNS:
            with cs.solve_via(solvers[version]):
                cs.run_rollout(torch, device, 2, mpc)
                w, sec = cs.run_rollout(torch, device, cs.N_TICKS, mpc)
            emit(what="srb rollout", budget=budget, version=version,
                 env_steps_per_s=cs.N_ENVS * cs.N_TICKS / sec,
                 ms_per_tick=sec * 1e3 / cs.N_TICKS, falls=float(w.metrics.falls.sum()))
    mpc, gait = cs._art_config()
    model = hector_model(device=device)
    for version in TURNS:
        w0, bipeds = cs.art_worlds(torch, device)
        with cs.solve_via(solvers[version]):
            batched_art_rollout_tick_kernel(w0, bipeds, 2, mpc, gait, model=model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = batched_art_rollout_tick_kernel(w0, bipeds, cs.N_ART_TICKS, mpc, gait, model=model)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        emit(what="tick-path rollout", budget="bench", version=version,
             env_steps_per_s=cs.N_ENVS * cs.N_ART_TICKS / sec,
             ms_per_tick=sec * 1e3 / cs.N_ART_TICKS, falls=float(w.metrics.falls.sum()),
             x_min=float(w.sim.pos[:, 0].min()))
    for version in ("base", "new"):
        with cs.solve_via(solvers[version]):
            events, busy, qp = cs.profile_tick_path(torch, device)
        emit(what="profiled tick-path ticks", version=version, device_kernels_per_tick=events,
             device_busy_ms_per_tick=busy, qp_kernel_ms_per_tick=qp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="the other qp_admm.cu (same C interface)")
    ap.add_argument("--out", type=Path, default=Path("build/ab/qp_kernel_ab.json"))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("qp_kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    base = opts.base.resolve()
    build.build(base, qp_kernel.SOURCE, verbose=True)
    solvers = {"base": launcher(base), "new": qp_kernel.fused_qp_solve}
    device = torch.device("cuda", 0)
    rows = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    from biped_mpc_py_torch.utils.precision import f32_matmul

    with torch.no_grad(), f32_matmul():
        solve_times(solvers, device, emit)
        rollout_rates(solvers, device, emit)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(f"wrote {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

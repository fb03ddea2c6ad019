#!/usr/bin/env python3
"""The kernels of this checkout against other sources of the same C
interfaces (for example a parent commit's), on one card, in turns.

The QP kernel:

    mkdir -p build/ab
    git show <commit>:biped_mpc_py_torch/csrc/qp_admm.cu > build/ab/qp_admm_base.cu
    python3 kernel_ab.py qp build/ab/qp_admm_base.cu

The physics kernels (the fused tick and the fused substeps), from a
directory that holds the other ``tick.cu``, ``substep.cu`` and the header
they include:

    mkdir -p build/ab/base
    for f in tick.cu substep.cu substep_device.cuh; do
      git show <commit>:biped_mpc_py_torch/csrc/$f > build/ab/base/$f; done
    python3 kernel_ab.py physics build/ab/base

The other sources are built under ``build/`` (git-ignored) with the
checkout's ``nvcc`` flags, ``-Xptxas -v`` printed; the two versions take
turns (base, new, new, base).

``qp``: the other kernel is launched through its own C function and routed
into the rollouts as ``chip_smoke.py`` routes its plain-core runs (at the
bench budget as the JAX bench runs it, with the bf16 knobs, when both
sources take them; else both with the knobs off, labelled ``bench-f32``),
for

1. the solve at 1024 envs, bench and default budgets, also with
   ``ns_iters=0`` and ``n_iters=0`` (CUDA events over repeated launches);
2. the SRB rollout, 1024 envs x 50 ticks, at the bench and default budgets;
3. the tick-kernel path, 1024 envs x 250 ticks;
4. ``chip_smoke.profile_tick_path``: device busy and QP kernel ms per tick.

``physics``: the other libraries take the place of the wrappers' own
(``fused_tick`` and ``fused_substeps`` check, allocate and count as always),
for

1. ``-Xptxas -v`` of each source and, where the toolkit has ``cuobjdump``,
   the SASS instruction count of each library with its local-memory loads
   (``LDL``) and stores (``STL``);
2. both kernels' device time (``torch.profiler``) at 1024, 4096, 16,384
   and 65,536 envs (``--sizes``);
3. the tick kernel at 1024 envs with (periods, substeps) = (8, 5), (8, 1),
   (1, 5), (1, 1): a substep is (t85 - t81) / 32, a period's feedback and
   control (t81 - t11) / 7 less one substep, the rest is the launch;
4. the SRB rollout (which runs neither kernel: the host's spread), the
   substep-kernel path (1024 envs x 50 ticks) and the tick-kernel path
   (1024 envs x 250 ticks), env-steps/s;
5. ``chip_smoke.profile_tick_path`` per version: device busy, QP kernel and
   tick kernel ms per tick;
6. with ``--clocks DIR``: DIR holds a copy of ``tick.cu`` (and its header)
   whose kernel adds up ``clock64()`` cycles per phase in one lane of each
   warp and writes them into ``q_out[:, 0:7]`` of that lane's env, in the
   order of ``CLOCK_PHASES``, zeros elsewhere; the mean over the nonzero
   rows is printed per phase (one tick, 1024 envs).

Each measurement is printed as one JSON line; all go to ``--out``. Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from biped_mpc_py_torch.ops.cuda import build, qp_kernel, substep_kernel, tick_kernel

TURNS = ("base", "new", "new", "base")
CLOCK_PHASES = ("feedback", "control", "forward pass", "contact", "backward pass",
                "rhs + Minv product", "integration")


def launcher(source: Path):
    """A solve with ``fused_qp_solve``'s signature that launches the kernel
    built from ``source`` (the ``qp_admm_solve`` C interface, with or
    without the per-env ``rho_env``, ``sigma_env``, ``alpha_env`` pointers
    and the ``bf16_iters``, ``bf16_matvec`` knobs; this launcher passes
    scalars only). A source without the knobs refuses them when set; the
    solve's ``knobs`` attribute says whether it takes them."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    text = source.read_text()
    per_env = [ptr] * 3 if "rho_env" in text else []
    knobs = "bf16_iters" in text
    lib = build.load(source, {
        "qp_admm_solve": ([ptr] * 11 + [i32] * 3 + [f32] * 3 + per_env
                          + [i32] * (6 if knobs else 4) + [i32, ptr], i32),
    })

    def solve(P, Ah, q, l, u, x0, z0, y0, *, rho, n_iters, n_phases, ns_iters, sigma,
              alpha, polish, bf16_iters=0, bf16_matvec=False):
        if not knobs and (bf16_iters or bf16_matvec):
            raise ValueError(f"{source.name} has no bf16 knobs")
        n_env, h, m, _ = Ah.shape
        x, z, y = torch.empty_like(q), torch.empty_like(l), torch.empty_like(l)
        rc = lib.qp_admm_solve(
            *[t.data_ptr() for t in (P, Ah, q, l, u, x0, z0, y0, x, z, y)],
            n_env, h, m, float(rho), float(sigma), float(alpha), *[None] * len(per_env),
            int(n_iters), int(n_phases), int(ns_iters), int(bool(polish)),
            *([int(bf16_iters), int(bool(bf16_matvec))] if knobs else []), P.device.index,
            torch.cuda.current_stream(P.device).cuda_stream)
        if rc:
            raise RuntimeError(f"{source.name}: qp_admm_solve failed ({rc})")
        return x, z, y

    solve.knobs = knobs
    return solve


def _budgets(solvers):
    """(label, SRB config, articulated config) of the bench budget each
    version can run: as the JAX bench runs it (the bf16 knobs on) when both
    take the knobs, else with the knobs off."""
    import dataclasses

    knobs = all(getattr(s, "knobs", True) for s in solvers.values())
    srb, (art, gait) = cs._walk_config(), cs._art_config()
    if knobs:
        return "bench", srb, (art, gait)
    return ("bench-f32", dataclasses.replace(srb, **cs.KNOBS_OFF),
            (dataclasses.replace(art, **cs.KNOBS_OFF), gait))


def solve_times(solvers, device, emit):
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.ops import qp as tqp

    label, srb, _ = _budgets(solvers)
    for budget, mpc in ((label, srb), ("default", MpcConfig())):
        qp = cs.mpc_qps(torch, mpc, cs.N_ENVS, device, cs.SEED)
        Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
        args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
        kw = tqp.solver_args(mpc)
        for variant, over in (("full", {}), ("ns_iters=0", {"ns_iters": 0}),
                              ("n_iters=0", {"n_iters": 0})):
            for version in TURNS:
                solve, kw_v = solvers[version], {**kw, **over}
                ms = cs._timed(torch, lambda: solve(*args, **kw_v), 20)
                emit(what="solve", budget=budget, variant=variant, version=version, ms=ms)


def srb_rollout(device, emit, version, budget="bench", mpc=None):
    cs.run_rollout(torch, device, 2, mpc)
    w, sec = cs.run_rollout(torch, device, cs.N_TICKS, mpc)
    emit(what="srb rollout", budget=budget, version=version,
         env_steps_per_s=cs.N_ENVS * cs.N_TICKS / sec,
         ms_per_tick=sec * 1e3 / cs.N_TICKS, falls=float(w.metrics.falls.sum()))


def art_rollout(device, emit, version, entry, what, n_ticks, config=None, budget="bench"):
    """``n_ticks`` of one articulated entry point at 1024 envs after a
    2-tick warm-up, at ``config`` (default ``chip_smoke._art_config()``)."""
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = config or cs._art_config()
    model = hector_model(device=device)
    w0, bipeds = cs.art_worlds(torch, device)
    entry(w0, bipeds, 2, mpc, gait, model=model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = entry(w0, bipeds, n_ticks, mpc, gait, model=model)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    emit(what=what, budget=budget, version=version,
         env_steps_per_s=cs.N_ENVS * n_ticks / sec, ms_per_tick=sec * 1e3 / n_ticks,
         falls=float(w.metrics.falls.sum()), x_min=float(w.sim.pos[:, 0].min()))


def profiled_ticks(device, emit, version, config=None):
    events, busy, qp, tick = cs.profile_tick_path(torch, device, config=config)
    emit(what="profiled tick-path ticks", version=version, device_kernels_per_tick=events,
         device_busy_ms_per_tick=busy, qp_kernel_ms_per_tick=qp,
         tick_kernel_ms_per_tick=tick)


def rollout_rates(solvers, device, emit):
    from biped_mpc_py_torch import MpcConfig
    from biped_mpc_py_torch.parallel.rollout_art import batched_art_rollout_tick_kernel

    label, srb, art = _budgets(solvers)
    for budget, mpc in ((label, srb), ("default", MpcConfig(x_cmd=cs.WALK_CMD))):
        for version in TURNS:
            with cs.solve_via(solvers[version]):
                srb_rollout(device, emit, version, budget, mpc)
    for version in TURNS:
        with cs.solve_via(solvers[version]):
            art_rollout(device, emit, version, batched_art_rollout_tick_kernel,
                        "tick-path rollout", cs.N_ART_TICKS, art, label)
    for version in ("base", "new"):
        with cs.solve_via(solvers[version]):
            profiled_ticks(device, emit, version, art)


def run_qp(opts, device, emit):
    base = opts.base.resolve()
    build.build(base, qp_kernel.SOURCE, verbose=True)
    solvers = {"base": launcher(base), "new": qp_kernel.fused_qp_solve}
    solve_times(solvers, device, emit)
    rollout_rates(solvers, device, emit)


class physics_via:
    """Put the libraries ``libs = (tick, substep)`` in the place of the
    wrappers' own inside the block (``None``: the checkout's)."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = (tick_kernel._lib, substep_kernel._lib)
        if self.libs is not None:
            tick_kernel._lib, substep_kernel._lib = self.libs

    def __exit__(self, *exc):
        tick_kernel._lib, substep_kernel._lib = self.saved


def load_physics(directory: Path, need_substep=True):
    """Build and open ``directory``'s tick.cu and substep.cu -> (tick
    library, substep library)."""
    tick_src, sub_src = directory / "tick.cu", directory / "substep.cu"
    sources = [tick_src] + ([sub_src] if need_substep else [])
    build.build(*sources, verbose=True)
    tick = build.load(tick_src, tick_kernel.FUNCTIONS)
    if tick.tick_n_consts() != tick_kernel.N_TICK_CONSTS:
        raise RuntimeError(f"{tick_src} expects {tick.tick_n_consts()} tick constants")
    sub = build.load(sub_src, substep_kernel.FLAT_FUNCTIONS) if need_substep else None
    return tick, sub


def sass_counts(source: Path):
    """Instructions, local loads and local stores in the SASS of the library
    built from ``source`` (``cuobjdump -sass``), or None without the tool."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(build._library_path(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    lines = [ln for ln in sass.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln)]
    return {"instructions": len(lines),
            "LDL": sum(" LDL" in ln for ln in lines), "STL": sum(" STL" in ln for ln in lines)}


def tick_split(device, emit, version):
    """The tick kernel at 1024 envs over (periods, substeps), device time."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    mpc, gait = cs._art_config()
    model, biped = hector_model(device=device), BipedParams().to(device)
    state, args = cs.tick_inputs(torch, cs.N_ENVS, cs.SEED)
    sc, ac = state.to(device), [a.to(device) for a in args]
    Minv = mass_matrix_inv(model, sc.q)
    t = {}
    for n_ll, n_sub in ((8, 5), (8, 1), (1, 5), (1, 1)):
        t[(n_ll, n_sub)], = cs._device_ms(
            torch, lambda: tick_kernel.fused_tick(model, biped, mpc, gait, sc, *ac, Minv,
                                                  n_lowlevel=n_ll, n_substeps=n_sub),
            ("tick_kernel",), 10)
    substep = (t[(8, 5)] - t[(8, 1)]) / 32
    control = (t[(8, 1)] - t[(1, 1)]) / 7 - substep
    emit(what="tick split", version=version, envs=cs.N_ENVS,
         ms={f"{a}x{b}": v for (a, b), v in t.items()}, substep_ms=substep,
         feedback_control_ms=control, launch_ms=t[(1, 1)] - substep - control)


def tick_clocks(directory: Path, device, emit):
    """One tick of the clock-stamped kernel in ``directory`` at 1024 envs:
    mean cycles per phase over the lanes that wrote them."""
    from biped_mpc_py_torch import BipedParams
    from biped_mpc_py_torch.sim.engine import mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    tick, _ = load_physics(directory, need_substep=False)
    mpc, gait = cs._art_config()
    model, biped = hector_model(device=device), BipedParams().to(device)
    state, args = cs.tick_inputs(torch, cs.N_ENVS, cs.SEED)
    sc, ac = state.to(device), [a.to(device) for a in args]
    Minv = mass_matrix_inv(model, sc.q)
    with physics_via((tick, substep_kernel._lib)):
        out, _ = tick_kernel.fused_tick(model, biped, mpc, gait, sc, *ac, Minv)
    torch.cuda.synchronize()
    rows = out.q[:, :len(CLOCK_PHASES)]
    rows = rows[rows.sum(1) > 0]
    cycles = rows.double().mean(0).tolist()
    total = sum(cycles)
    emit(what="tick clocks", source=str(directory), lanes=rows.shape[0],
         cycles=dict(zip(CLOCK_PHASES, cycles)), total_cycles=total,
         share={k: c / total for k, c in zip(CLOCK_PHASES, cycles)})


def run_physics(opts, device, emit):
    from biped_mpc_py_torch.parallel.rollout_art import (
        batched_art_rollout_kernel, batched_art_rollout_tick_kernel,
    )

    base_dir = opts.base.resolve()
    build.build(tick_kernel.SOURCE, substep_kernel.SOURCE, verbose=True)
    libs = {"base": load_physics(base_dir), "new": None}
    for version, sources in (("base", (base_dir / "tick.cu", base_dir / "substep.cu")),
                             ("new", (tick_kernel.SOURCE, substep_kernel.SOURCE))):
        for source in sources:
            emit(what="build", version=version, source=source.name,
                 ptxas=build.ptxas_report(source), sass=sass_counts(source))
    tick_kernel._load()
    substep_kernel._load()
    for n in opts.sizes:
        for version in TURNS:
            with physics_via(libs[version]):
                ms_s, ms_t = cs.physics_kernel_ms(torch, device, n)
            emit(what="physics kernels", version=version, envs=n, fused_substeps_ms=ms_s,
                 fused_tick_ms=ms_t, bound_substeps_ms=cs.bound_substep(torch, device, n)[0],
                 bound_tick_ms=cs.bound_tick(torch, device, n)[0])
    for version in TURNS:
        with physics_via(libs[version]):
            tick_split(device, emit, version)
    if opts.clocks:
        for directory in opts.clocks:
            tick_clocks(directory.resolve(), device, emit)
    if opts.no_rollouts:
        return
    for version in TURNS:
        with physics_via(libs[version]):
            srb_rollout(device, emit, version)
            art_rollout(device, emit, version, batched_art_rollout_kernel,
                        "substep-path rollout", 50)
            art_rollout(device, emit, version, batched_art_rollout_tick_kernel,
                        "tick-path rollout", cs.N_ART_TICKS)
    for version in ("base", "new"):
        with physics_via(libs[version]):
            profiled_ticks(device, emit, version)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="which", required=True)
    qp = sub.add_parser("qp", help="the QP kernel against another qp_admm.cu")
    qp.add_argument("base", type=Path, help="the other qp_admm.cu (same C interface)")
    ph = sub.add_parser("physics", help="the tick and substep kernels against another pair")
    ph.add_argument("base", type=Path,
                    help="a directory with the other tick.cu, substep.cu and their header")
    ph.add_argument("--sizes", type=lambda s: [int(v) for v in s.split(",")],
                    default=list(cs.PHYSICS_SIZES), help="env counts, comma-separated")
    ph.add_argument("--clocks", type=Path, action="append",
                    help="a directory with a clock-stamped tick.cu (may repeat)")
    ph.add_argument("--no-rollouts", action="store_true",
                    help="kernels only: skip the rollouts and the profiled ticks")
    for p in (qp, ph):
        p.add_argument("--out", type=Path, default=Path("build/ab/kernel_ab.json"))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    rows = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    from biped_mpc_py_torch.utils.precision import f32_matmul

    with torch.no_grad(), f32_matmul():
        (run_qp if opts.which == "qp" else run_physics)(opts, device, emit)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(f"wrote {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's bench budget against its default budget at a
population's size, on the CPU: the reading of
``tests/test_rollout.py::test_bench_budget_accuracy``'s bounds (one nominal
robot, 250 ticks) that ``chip_smoke.py::phase_bench_accuracy`` applies to
the port's 1024 randomized robots x 50 ticks on the card.

    python -m tests.jax_bench_accuracy 1024 50
    python -m tests.jax_bench_accuracy starts 32

The first runs ``batched_rollout_fn`` from ``batch_worlds`` with
``randomize_params(PRNGKey(0), n)`` robots walking at 0.3 m/s at the
default budget, at ``fast_mpc_config()`` (the bf16 knobs on) and with the
knobs off, and prints per-env maxima and population means of the
differences the test bounds. Several minutes at 1024 envs.

The second walks the test's own robot for its 250 ticks from ``n``
starts 1e-6 apart (seeded numpy noise on x_fb) at ``fast_mpc_config()``,
in the JAX package and in the torch port on the CPU, and prints each
one's attitude RMS beside the test's bound (1.2x the default budget's
single walk + 1e-3): the spread of a knobs-on walk over starts that f32
roundoff could produce. About a minute at 32 starts.

    python -m tests.jax_bench_accuracy art 64
    python -m tests.jax_bench_accuracy art-starts 1024

The third runs ``bench.py BENCH_MODE=art``'s configuration (its
``art_mpc_config`` budget, walking in place, 5 substeps, the mass-matrix
inverse held all tick) with ``randomize_params(PRNGKey(0), n)`` robots for
50 ticks, the bf16 knobs on and off: the JAX package's plain chain (and,
at a multiple of 1024 envs, its substep and tick paths, their Pallas
kernels in interpret mode),
and the port on the CPU on the same robots (its plain chain, substep path
and tick path, through ``biped_mpc_py_torch.bench``). It prints each
run's falls. About a minute at 64 envs. The fourth runs the same with
the bench's own robots, ``n`` copies of ``BipedParams()``, each started
from the standing pose with seeded numpy noise of 1e-6 rad on its joint
angles: how often the bench's one identical-robot walk falls when only
roundoff moves it. About half an hour at 1024 envs.
"""

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.parallel import rollout as jroll
from biped_mpc_py_tpu.utils.precision import f32_precision

X_CMD = (0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0)
KNOBS_OFF = dict(kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False)


def walk(mpc, n, ticks):
    bipeds = jroll.randomize_params(jax.random.PRNGKey(0), n)
    out = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, mpc, jcfg.GaitConfig())))(
        jroll.batch_worlds(mpc, n), bipeds)
    x, m = np.asarray(out.sim.x_fb), out.metrics
    return dict(x=x[:, 3], y=x[:, 4], z=x[:, 5],
                att=np.sqrt(np.asarray(m.attitude_err_sq) / ticks),
                vel=np.sqrt(np.asarray(m.vel_err_sq) / ticks),
                falls=float(np.asarray(m.falls).sum()), res=np.asarray(m.res_prim_max))


def main(n: int, ticks: int) -> None:
    x_cmd = jnp.asarray(X_CMD, jnp.float32)
    fast = jcfg.fast_mpc_config(x_cmd=x_cmd)
    runs = {}
    for label, mpc in (("default", jcfg.default_mpc_config(x_cmd=x_cmd)), ("bench", fast),
                       ("bench-f32", dataclasses.replace(fast, **KNOBS_OFF))):
        t0 = time.time()
        runs[label] = walk(mpc, n, ticks)
        print(f"{label}: {n} envs x {ticks} ticks in {time.time() - t0:.1f} s", flush=True)
    d = runs["default"]
    for label in ("bench", "bench-f32"):
        a = runs[label]
        dx, dz = np.abs(a["x"] - d["x"]), np.abs(a["z"] - d["z"])
        print(f"{label} vs default: falls {a['falls']}; per env max|d distance| {dx.max():.4f} m, "
              f"max|d height| {dz.max():.4f} m ({int((dz > 0.02).sum())} envs past 0.02); "
              f"means: distance {a['x'].mean():.4f} vs {d['x'].mean():.4f} m, height "
              f"{a['z'].mean():.4f} vs {d['z'].mean():.4f} m, att RMS {a['att'].mean():.5f} vs "
              f"{d['att'].mean():.5f}, vel RMS {a['vel'].mean():.5f} vs {d['vel'].mean():.5f}; "
              f"res_prim max {a['res'].max():.4f} (mean {a['res'].mean():.4f}, "
              f"{int((a['res'] >= 1.0).sum())} envs at 1.0 or more); max|y| "
              f"{np.abs(a['y']).max():.4f} m", flush=True)


def starts(n: int, ticks: int = 250) -> None:
    import torch

    from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
    from biped_mpc_py_torch import config as tcfg
    from biped_mpc_py_torch.models.biped import BipedParams
    from biped_mpc_py_torch.parallel import rollout as troll

    x_cmd = jnp.asarray(X_CMD, jnp.float32)
    full = jcfg.default_mpc_config(x_cmd=x_cmd)
    w = jax.jit(jroll.rollout_fn(ticks, full, jcfg.GaitConfig()))(jroll.init_world(full),
                                                                  JBipedParams())
    bound = 1.2 * float(jnp.sqrt(w.metrics.attitude_err_sq / ticks)) + 1e-3
    noise = (1e-6 * np.random.default_rng(0).normal(size=(n, 12))).astype(np.float32)
    fast = jcfg.fast_mpc_config(x_cmd=x_cmd)
    jw = jroll.batch_worlds(fast, n)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, x_fb=jw.sim.x_fb + noise))
    jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), JBipedParams())
    out = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, fast, jcfg.GaitConfig())))(jw, jb)
    att_j = np.sort(np.sqrt(np.asarray(out.metrics.attitude_err_sq) / ticks))
    tm = tcfg.fast_mpc_config(x_cmd=X_CMD)
    tw = troll.batch_worlds(tm, n, device="cpu")
    tw = dataclasses.replace(tw, sim=dataclasses.replace(
        tw.sim, x_fb=tw.sim.x_fb + torch.from_numpy(noise)))
    o = troll.batched_rollout(tw, BipedParams().expand(n), ticks, tm, tcfg.GaitConfig())
    att_t = np.sort(torch.sqrt(o.metrics.attitude_err_sq / ticks).numpy())
    for label, att in (("JAX", att_j), ("port", att_t)):
        print(f"{label} bench budget, {n} starts x {ticks} ticks: attitude RMS "
              f"{att.min():.5f}-{att.max():.5f} (mean {att.mean():.5f}), "
              f"{int((att >= bound).sum())} at the test's bound {bound:.5f} or past it",
              flush=True)


def art(n: int, ticks: int = 50, case: str = "randomized") -> None:
    import torch

    from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
    from biped_mpc_py_tpu.parallel import rollout_art as jra
    from biped_mpc_py_torch import bench
    from biped_mpc_py_torch.models.biped import BipedParams
    from biped_mpc_py_torch.utils.convert import from_numpy

    if case == "randomized":
        jb = jroll.randomize_params(jax.random.PRNGKey(0), n)
        tb = from_numpy(BipedParams, dataclasses.asdict(jax.tree.map(np.asarray, jb)),
                        device="cpu")
        noise = np.zeros((n, 10), np.float32)
        robots = f"{n} randomized robots"
    else:
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), JBipedParams())
        tb = BipedParams().expand(n)
        noise = (1e-6 * np.random.default_rng(0).normal(size=(n, 10))).astype(np.float32)
        robots = f"{n} identical robots from starts 1e-6 rad apart"
    for knobs in (True, False):
        env = {"BENCH_PLATFORM": "cpu", "BENCH_MODE": "art", "BENCH_ENVS": str(n),
               "BENCH_STEPS": str(ticks)}
        if not knobs:
            env |= {"BENCH_NS_BF16": "0", "BENCH_BF16_MATVEC": "0", "BENCH_RUIZ_BF16": "0"}
        plan = bench.resolve(env)
        mpc = jra.art_mpc_config(**{f: getattr(plan.mpc, f) for _, f, _, _ in bench.BUDGET})
        jw = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)),
                          jra.init_art_world(mpc))
        jw = jw.replace(sim=jw.sim.replace(q=jw.sim.q + noise))
        kw = dict(n_substeps=5, minv_ll_hold=8)
        jfns = {"JAX plain chain": jra.batched_art_rollout_fn(ticks, mpc, jcfg.GaitConfig(), **kw)}
        if n % 1024 == 0:  # the Pallas kernels' block; interpret mode here
            jfns["JAX substep path"] = jra.batched_art_rollout_kernel_fn(
                ticks, mpc, jcfg.GaitConfig(), **kw)
            jfns["JAX tick path"] = jra.batched_art_rollout_tick_kernel_fn(
                ticks, mpc, jcfg.GaitConfig(), n_substeps=5)
        runs = {}
        for label, f in jfns.items():
            t0 = time.time()
            out = jax.jit(f32_precision(f))(jw, jb)
            runs[label] = (np.asarray(out.metrics.falls), time.time() - t0)
        for backend in ("xla", "kernel", "tick"):
            fn, args = bench.build(bench.resolve(env | {"BENCH_ART_BACKEND": backend}))
            tw = dataclasses.replace(args[0], sim=dataclasses.replace(
                args[0].sim, q=args[0].sim.q + torch.from_numpy(noise)))
            t0 = time.time()
            falls = fn(tw, tb).metrics.falls.numpy()
            runs[f"port {bench.ART_BACKENDS[backend]} path"] = (falls, time.time() - t0)
        for label, (falls, secs) in runs.items():
            print(f"{label}, bf16 knobs {'on' if knobs else 'off'}, {robots} x {ticks} ticks: "
                  f"{int((falls > 0).sum())} envs fell ({secs:.0f} s)", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1 and sys.argv[1] == "starts":
        starts(int(sys.argv[2]) if len(sys.argv) > 2 else 32)
    elif len(sys.argv) > 1 and sys.argv[1] in ("art", "art-starts"):
        art(int(sys.argv[2]) if len(sys.argv) > 2 else 64,
            case="randomized" if sys.argv[1] == "art" else "starts")
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024,
             int(sys.argv[2]) if len(sys.argv) > 2 else 50)

"""The port's headline benchmark, ``python -m biped_mpc_py_torch.bench``, on
the CPU at a tiny size.

- ``resolve`` over the variable sets of ``bench.py``'s modes: the path each
  runs, and its ``MpcConfig`` and ``GaitConfig`` equal, field by field, to
  what ``bench.py:127-161`` builds from the same variables in the JAX
  package (carried across with ``utils/convert.py``; no JAX computation).
- The refusals: the tick path with another mass-matrix hold, the TPU's
  ``BENCH_BLOCK_ENVS``, an unknown mode, backend or platform, the card
  asked for where there is none; from the command line each gives one
  ``{"error": ...}`` line on stdout and exit code 1, as does a first call
  that fails (a kernel's build or launch, the capture).
- A run of each path (SRB, randomized SRB, the tick path, randomized, the
  substep path, the plain chain, randomized robots on rough terrain), 2
  envs x 2 ticks (the plain chain and terrain 1 tick): the bench's final
  world bit-equal to the path's ``*_fn`` called directly on inputs made
  here, the result's keys, and no kernel launch (the CPU runs the plain
  versions). The randomized tick path holds that the tick kernel takes the
  factory's one robot while the MPC stage takes the batch.
- ``main`` prints exactly one JSON line; importing the module needs no JAX.

The rates themselves are the card's: ``chip_smoke.py`` (``phase_bench``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_torch import bench
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.utils.convert import to_numpy
from biped_mpc_py_torch.utils.graphs import leaves
from tests.test_torch_convert import _assert_same, _fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"BENCH_PLATFORM": "cpu"}
KNOBS_OFF = {"BENCH_NS_BF16": "0", "BENCH_BF16_MATVEC": "0", "BENCH_RUIZ_BF16": "0"}
DEFAULT_BUDGET = {"BENCH_ITERS": "60", "BENCH_PHASES": "3", "BENCH_POLISH": "1",
                  "BENCH_NS_ITERS": "14", **KNOBS_OFF}
ART = {"BENCH_MODE": "art"}

# name: (variables, the path they resolve to)
MODES = {
    "srb": ({}, "srb"),
    "srb/pallas": ({"BENCH_BACKEND": "pallas"}, "srb"),
    "srb/knobs-off": (KNOBS_OFF, "srb"),
    "srb/default-budget": (DEFAULT_BUDGET, "srb"),
    "srb/standing-randomized": ({"BENCH_GAIT": "0", "BENCH_RANDOMIZE": "1"}, "srb"),
    "art": (ART, "tick"),
    "art/kernel": (ART | {"BENCH_ART_BACKEND": "kernel"}, "kernel"),
    "art/xla": (ART | {"BENCH_ART_BACKEND": "xla"}, "plain"),
    "art/hold-1": (ART | {"BENCH_MINV_HOLD": "1"}, "kernel"),
    "art/hold-1-xla": (ART | {"BENCH_MINV_HOLD": "1", "BENCH_ART_BACKEND": "xla"}, "plain"),
    "art/terrain-randomized": (ART | {"BENCH_TERRAIN": "0.03", "BENCH_RANDOMIZE": "1"},
                               "terrain"),
    "art/knobs-off-substeps-10": (ART | KNOBS_OFF | {"BENCH_ART_SUBSTEPS": "10"}, "tick"),
    "art/default-budget-256": (ART | DEFAULT_BUDGET | {"BENCH_ENVS": "256"}, "tick"),
}

RESULT_KEYS = {
    "metric", "value", "unit", "vs_baseline", "path", "envs", "steps", "gait",
    "minv_ll_hold", "n_substeps", "terrain", "randomize", "n_admm_iters",
    "admm_rho_phases", "admm_polish", "kinv_ns_iters", "kinv_bf16_iters",
    "admm_bf16_matvec", "ruiz_bf16_norms", "device", "elapsed_s", "capture_s", "peak_mb",
    "graph_pool_mb", "launches", "checks",
}


def _jax_bench_configs(env):
    """(MpcConfig, GaitConfig) as ``bench.py:122-161`` builds them from
    ``env``, in the JAX package."""
    g = lambda name, default: env.get(name, default)  # noqa: E731
    mpc = dataclasses.replace(
        jcfg.MpcConfig(),
        n_admm_iters=int(g("BENCH_ITERS", "40")),
        admm_rho_phases=int(g("BENCH_PHASES", "1")),
        admm_polish=bool(int(g("BENCH_POLISH", "0"))),
        kinv_ns_iters=int(g("BENCH_NS_ITERS", "10")),
        kinv_bf16_iters=int(g("BENCH_NS_BF16", "8")),
        admm_bf16_matvec=bool(int(g("BENCH_BF16_MATVEC", "1"))),
        ruiz_bf16_norms=bool(int(g("BENCH_RUIZ_BF16", "1"))),
    )
    if g("BENCH_MODE", "srb") == "art":
        mpc = jra.art_mpc_config(
            n_admm_iters=mpc.n_admm_iters, admm_rho_phases=mpc.admm_rho_phases,
            admm_polish=mpc.admm_polish, kinv_ns_iters=mpc.kinv_ns_iters,
            kinv_bf16_iters=mpc.kinv_bf16_iters, admm_bf16_matvec=mpc.admm_bf16_matvec,
            ruiz_bf16_norms=mpc.ruiz_bf16_norms,
        )
    return mpc, jcfg.GaitConfig(gait_mode=int(g("BENCH_GAIT", "1")))


@pytest.mark.parametrize("name", sorted(MODES))
def test_resolve_matches_the_jax_bench(name):
    """The path of each variable set, and its configs equal to the JAX
    bench's field by field."""
    env, path = MODES[name]
    plan = bench.resolve(CPU | env)
    assert plan.path == path
    assert plan.mode == env.get("BENCH_MODE", "srb")
    jmpc, jgait = _jax_bench_configs(env)
    _assert_same(_fields(jmpc), to_numpy(plan.mpc), name)
    _assert_same(_fields(jgait), to_numpy(plan.gait), name)
    assert plan.n_envs == int(env.get("BENCH_ENVS", "1024"))
    assert plan.n_steps == 50
    assert plan.device == torch.device("cpu")
    assert plan.randomize == (env.get("BENCH_RANDOMIZE") == "1")
    assert plan.terrain_amp == float(env.get("BENCH_TERRAIN", "0"))
    if plan.mode == "art":
        assert plan.n_substeps == int(env.get("BENCH_ART_SUBSTEPS", "5"))
        assert plan.minv_ll_hold == int(env.get("BENCH_MINV_HOLD", "8"))
    else:
        assert plan.n_substeps is None and plan.minv_ll_hold is None


@pytest.mark.parametrize("env, match", [
    (ART | {"BENCH_ART_BACKEND": "tick", "BENCH_MINV_HOLD": "1"}, "BENCH_MINV_HOLD=1"),
    ({"BENCH_BLOCK_ENVS": "256"}, "BENCH_BLOCK_ENVS"),
    ({"BENCH_BLOCK_ENVS": "0"}, "BENCH_BLOCK_ENVS"),
    ({"BENCH_MODE": "mjx"}, "BENCH_MODE='mjx'"),
    (ART | {"BENCH_ART_BACKEND": "pallas"}, "BENCH_ART_BACKEND='pallas'"),
    ({"BENCH_BACKEND": "triton"}, "BENCH_BACKEND='triton'"),
    ({"BENCH_PLATFORM": "tpu"}, "BENCH_PLATFORM='tpu'"),
], ids=["tick-hold-1", "block-envs", "block-envs-0", "mode", "art-backend", "srb-backend",
        "platform"])
def test_resolve_refuses(env, match):
    with pytest.raises(ValueError, match=match):
        bench.resolve(CPU | env)


def test_resolve_without_a_card_raises(monkeypatch):
    """The card is the default device; without one the bench fails and
    never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.resolve({})
    assert bench.resolve(CPU).device == torch.device("cpu")


def _cli(env):
    """``python -m biped_mpc_py_torch.bench`` in a subprocess with ``env``
    as its only ``BENCH_*`` variables and no card."""
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    return subprocess.run([sys.executable, "-m", "biped_mpc_py_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=base | {"CUDA_VISIBLE_DEVICES": ""} | env)


def test_cli_without_a_card_prints_one_error_line():
    out = _cli({})
    lines = out.stdout.splitlines()
    assert out.returncode == 1, out.stderr
    assert len(lines) == 1, out.stdout
    err = json.loads(lines[0])
    assert err["error"] == "bench_setup_failure"
    assert "is_available" in err["detail"]


def test_cli_refusal_prints_one_error_line():
    out = _cli(CPU | ART | {"BENCH_MINV_HOLD": "2", "BENCH_ART_BACKEND": "tick"})
    assert out.returncode == 1, out.stderr
    (line,) = out.stdout.splitlines()
    err = json.loads(line)
    assert err["error"] == "bench_setup_failure"
    assert err["detail"].startswith("ValueError: BENCH_ART_BACKEND=tick")


def test_first_call_failure_is_one_error_line(monkeypatch, capsys):
    """A kernel that fails to build or launch, or a capture that fails,
    surfaces from the first call: one error line, exit code 1, no second
    attempt on another path."""
    calls = []

    def broken(*args):
        calls.append(args)
        raise RuntimeError("nvcc failed: csrc/qp_admm.cu")

    monkeypatch.setattr(bench, "build", lambda plan: (broken, ()))
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    assert bench.main() == 1
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line) == {"error": "backend_or_compile_failure",
                                "detail": "RuntimeError: nvcc failed: csrc/qp_admm.cu"}
    assert len(calls) == 1


def _direct(path, plan, randomize):
    """The path's ``*_fn`` on inputs made here, as a caller of the
    package would make them: (fn, args)."""
    n, mpc, gait, k = 2, plan.mpc, plan.gait, plan.n_steps
    bipeds = (troll.randomize_params(torch.Generator("cpu").manual_seed(0), n, device="cpu")
              if randomize else BipedParams().expand(n))
    if path == "srb":
        return troll.batched_rollout_fn(k, mpc, gait), (troll.batch_worlds(mpc, n, "cpu"), bipeds)
    worlds = tra.init_art_world(mpc, n, device="cpu")
    kw = dict(n_substeps=5, minv_ll_hold=8)
    if path == "tick":
        return tra.batched_art_rollout_tick_kernel_fn(k, mpc, gait, n_substeps=5), (worlds, bipeds)
    if path == "kernel":
        return tra.batched_art_rollout_kernel_fn(k, mpc, gait, **kw), (worlds, bipeds)
    if path == "plain":
        return tra.batched_art_rollout_fn(k, mpc, gait, **kw), (worlds, bipeds)
    fields = Terrain.rough_batch(torch.Generator("cpu").manual_seed(1), n, amplitude=0.03,
                                 device="cpu")
    return tra.batched_art_rollout_terrain_fn(k, mpc, gait, **kw), (worlds, bipeds, fields)


# name: (variables, ticks)
RUNS = {
    "srb": ({}, 2),
    "srb/randomized": ({"BENCH_RANDOMIZE": "1"}, 2),
    "tick": (ART, 2),
    "tick/randomized": (ART | {"BENCH_RANDOMIZE": "1"}, 2),
    "kernel": (ART | {"BENCH_ART_BACKEND": "kernel"}, 2),
    "plain": (ART | {"BENCH_ART_BACKEND": "xla"}, 1),
    "terrain": (ART | {"BENCH_TERRAIN": "0.03", "BENCH_RANDOMIZE": "1"}, 1),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_bench_run_is_the_entry_point(name):
    """The bench's final world bit-equal to the ``*_fn`` called directly;
    the result's keys and figures."""
    env, ticks = RUNS[name]
    plan = bench.resolve(CPU | env | {"BENCH_ENVS": "2", "BENCH_STEPS": str(ticks)})
    world, result = bench.measure(plan)
    fn, args = _direct(plan.path, plan, plan.randomize)
    ref = fn(*args)
    got, want = leaves(world), leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(result) == RESULT_KEYS
    assert result["path"] == name.split("/")[0]
    assert (result["envs"], result["steps"], result["device"]) == (2, ticks, "cpu")
    assert result["metric"] == "fused_sim_mpc_env_steps_per_sec_per_chip"
    assert result["value"] > 0 and result["peak_mb"] is None and result["graph_pool_mb"] == 0
    assert result["launches"] == {"fused_qp_solve": 0, "fused_tick": 0, "fused_substeps": 0,
                                  "fused_ruiz": 0}
    checks = result["checks"]
    assert checks["finite"] and checks["falls"] == float(world.metrics.falls.sum())
    assert checks["nonfinite_resets"] == 0
    if plan.mode == "art":
        assert checks["x_min"] == float(world.sim.pos[:, 0].min())
        assert checks["res_prim_ge_1"] == int((world.metrics.res_prim_max >= 1.0).sum())
    else:
        assert checks["height_max"] == float(world.sim.x_fb[:, 5].max())


def test_main_prints_one_json_line(monkeypatch, capsys):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in (CPU | {"BENCH_ENVS": "2", "BENCH_STEPS": "1"}).items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    out = capsys.readouterr()
    (line,) = out.out.splitlines()
    result = json.loads(line)
    assert set(result) == RESULT_KEYS
    assert result["path"] == "srb" and result["envs"] == 2 and result["steps"] == 1
    assert "capture+first run:" in out.err and "envs=2 steps=1 elapsed=" in out.err


def test_bench_imports_no_jax():
    """The module imports with JAX and the JAX package unimportable."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['biped_mpc_py_tpu'] = None; "
            "import biped_mpc_py_torch.bench as b; print(b.METRIC)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "fused_sim_mpc_env_steps_per_sec_per_chip"

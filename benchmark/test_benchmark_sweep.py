"""The sweep loop (``harness/loops/sweep.py``) and its generator
(``traffic/sweep.py``) on the CPU at a tiny size: the configs drawn from the
seed alone, within the traffic's ranges and with env 0 the configuration's,
the cell run end to end and found correct, and the check failing where the
program gives every env env 0's values below the MPC; on the card, the cell
at 512 envs with the program within its limits and the TF32 control beyond
them on three seeds, and the same planted fault failing at full size.

On the CPU the program's sweep runs the plain chain (the tick kernel's
per-env variant runs on the card only), so the fault is planted in both
places it can reach the low-level control: the plain chain's period
(``rollout_art._lowlevel_stage``) and the tick path's kernel call
(``rollout_art.fused_tick``)."""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import control, run
from benchmark.harness import check, common, spec
from benchmark.harness.tree import leaves
from benchmark.reference import config as rconfig
from benchmark.reference.loops import init_art_world

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 17
CELL = "art_sweep_4096"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``BENCHMARK.json`` and ``benchmark/`` copied with the cell's traffic
    cut to 4 envs and 2 ticks a call, all 4 checked; limits as they are."""
    dest = tmp_path_factory.mktemp("sweep")
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.npy"))
    here = dest / "benchmark"
    w = next(w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
             if w["name"] == CELL)
    for path, edit in ((f"traffic/{w['traffic']}.json", {"envs": 4, "ticks_per_call": 2}),
                       (f"workloads/{CELL}.json", {"check": {"chunk_draws": 2, "envs": 4}})):
        d = json.loads((here / path).read_text())
        (here / path).write_text(json.dumps({**d, **edit}))
    return dest


def _draw(cell, seed, n=None):
    gen = spec.generator(cell)
    mpc, _ = common.configs(cell, rconfig)
    traffic = cell.traffic if n is None else {**cell.traffic, "envs": n}
    return gen.inputs(traffic, mpc, init_art_world, seed, CPU), mpc


def test_inputs_are_the_seeds(tiny):
    """Robots, starts and configs, drawn in that order; the same seed gives
    the same inputs, another seed other configs; env 0 keeps the
    configuration's values and every other env's lie in the traffic's
    ranges (256 envs)."""
    cell = spec.load(CELL, tiny)
    (a, mpc), (b, _), (c, _) = _draw(cell, SEED), _draw(cell, SEED), _draw(cell, SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a[:2]), leaves(b[:2])))
    assert a[2].keys() == b[2].keys() and all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert not torch.equal(a[2]["x_cmd"], c[2]["x_cmd"])
    (_, world, per_env), _ = _draw(cell, SEED, 256)
    draws = cell.traffic["per_env"]
    assert set(per_env) == ({"x_cmd"} | set(draws["uniform"]) | set(draws["log_uniform"])
                            | set(draws["log_scale"]))
    assert per_env["x_cmd"].shape == (256, 12) and per_env["Q"].shape == (256, 13)
    assert per_env["R"].shape == (256, 12) and per_env["kp_swing"].shape == (256,)
    assert torch.equal(per_env["x_cmd"][0], torch.tensor(mpc.x_cmd))
    assert torch.equal(per_env["Q"][0], torch.tensor(mpc.Q))
    for i, (lo, hi) in draws["command"].items():
        v = per_env["x_cmd"][1:, int(i)]
        assert bool(((v >= lo) & (v <= hi)).all()) and float(v.std()) > 0
    for name, (lo, hi) in {**draws["uniform"], **draws["log_uniform"]}.items():
        v = per_env[name]
        assert float(v[0]) == pytest.approx(getattr(mpc, name), rel=1e-6), name
        assert bool(((v[1:] >= lo * (1 - 1e-6)) & (v[1:] <= hi * (1 + 1e-6))).all()), name
    for name, (lo, hi) in draws["log_scale"].items():
        scale = per_env[name][1:] / torch.tensor(getattr(mpc, name))
        assert bool(((scale >= lo * (1 - 1e-6)) & (scale <= hi * (1 + 1e-6))).all()), name
        assert abs(float(torch.log(scale).mean()) - math.log(lo * hi) / 2) < 0.1, name
    assert bool((world.sim.q[0] == init_art_world(mpc, 1, device=CPU).sim.q[0]).all())


def test_cell_runs_correct_on_cpu(tiny):
    r = run.run_cell(spec.load(CELL, tiny), SEED, 0.2, False, CPU, run.T_START)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"} and r["attempted"] > 0


def _env0_below_the_mpc(monkeypatch):
    """The planted fault: below the MPC every env runs with env 0's
    command, gains and control constants (the tick kernel's table row); the
    MPC and post stages keep each env's."""
    from biped_mpc_py_torch.parallel import rollout_art

    def row0(t):
        return None if t is None else t[:1].expand_as(t)

    def env0(x_cmd, per_env):
        return row0(x_cmd), None if per_env is None else {k: row0(v) for k, v in
                                                          per_env.items()}

    period, fused = rollout_art._lowlevel_stage, rollout_art.fused_tick

    def faulty_period(model, sim, t_ll, contact, u0, world, biped, mpc, gait, terrain=None,
                      x_cmd=None, per_env=None):
        x_cmd, per_env = env0(x_cmd, per_env)
        return period(model, sim, t_ll, contact, u0, world, biped, mpc, gait, terrain, x_cmd,
                      per_env)

    def faulty_fused(*args, x_cmd=None, per_env=None, table=None, **kw):
        x_cmd, per_env = env0(x_cmd, per_env)
        return fused(*args, x_cmd=x_cmd, per_env=per_env, table=row0(table), **kw)

    monkeypatch.setattr(rollout_art, "_lowlevel_stage", faulty_period)
    monkeypatch.setattr(rollout_art, "fused_tick", faulty_fused)


def test_env0_row_is_not_correct(tiny, monkeypatch):
    _env0_below_the_mpc(monkeypatch)
    r = run.run_cell(spec.load(CELL, tiny), SEED, 0.2, False, CPU, run.T_START)
    assert not r["correct"], r["compared"]


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_and_program_passes_at_512(card):
    cell = spec.load(CELL, ROOT)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "envs": 512}, workload={
        **cell.workload, "check": {"chunk_draws": 2, "envs": 512}})
    seeds = [11, 12, 13]
    for seed, side, nums, _ in control.readings(cell, card, seeds, set(seeds), 1.0):
        ok, rows = check.judge(nums, cell.workload["limits"])
        assert ok == (side == "program"), (seed, side, rows)


@pytest.mark.cuda
def test_env0_row_fails_at_full_size(card, monkeypatch):
    _env0_below_the_mpc(monkeypatch)
    cell = spec.load(CELL, ROOT)
    for seed, _, nums, _ in control.readings(cell, card, [21, 22], set(), 2.0):
        ok, rows = check.judge(nums, cell.workload["limits"])
        assert not ok, (seed, rows)

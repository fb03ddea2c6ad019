"""The rough-ground loop (``harness/loops/terrain.py``) and its generator
(``traffic/terrain.py``) on the CPU at a tiny size: the inputs drawn from
the seed alone, the cell run end to end through the port's plain chain and
found correct, and the check failing where the program steps its physics
on flat ground; on the card, the cell at 512 envs with the program within
its limits and the TF32 control beyond them on three seeds, and the same
planted fault failing at full size."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import control, run
from benchmark.harness import check, common, spec
from benchmark.harness.tree import leaves
from benchmark.reference import config as rconfig
from benchmark.reference.loops import init_art_world
from benchmark.reference.sim.contact import Terrain

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 11
CELL = "art_terrain_4096"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``BENCHMARK.json`` and ``benchmark/`` copied with the cell's traffic
    cut to 4 envs and 2 ticks a call, all 4 checked, on 16 x 16 fields;
    limits as they are."""
    dest = tmp_path_factory.mktemp("terrain")
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
    cfg = here / "configs" / f"{w['config']}.json"
    d = json.loads(cfg.read_text())
    d["terrain"]["res"] = 16
    cfg.write_text(json.dumps(d))
    return dest


def test_inputs_are_the_seeds(tiny):
    """Robots, starts and one field per env, drawn in that order; the same
    seed gives the same inputs, another seed other fields."""
    cell = spec.load(CELL, tiny)
    gen = spec.generator(cell)
    mpc, _ = common.configs(cell, rconfig)

    def draw(seed):
        return gen.inputs(cell.traffic, mpc, init_art_world, cell.config["terrain"], seed, CPU)

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    t = a[2]
    assert isinstance(t, Terrain) and t.heights.shape == (4, 16, 16) and t.extent == 8.0
    assert not torch.equal(t.heights, c[2].heights)
    assert bool((a[1].sim.q[0] == init_art_world(mpc, 1, device=CPU).sim.q[0]).all())


def test_cell_runs_correct_on_cpu(tiny):
    r = run.run_cell(spec.load(CELL, tiny), SEED, 0.2, False, CPU, run.T_START)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"} and r["attempted"] > 0


def _flat_physics(monkeypatch):
    """The planted fault: the program steps its physics on the plane z = 0
    while its references follow the fields."""
    from biped_mpc_py_torch.parallel import rollout_art
    from biped_mpc_py_torch.sim import engine

    step = engine.art_step
    monkeypatch.setattr(rollout_art, "art_step",
                        lambda model, sim, tau, dt, n, terrain=None, **k: step(model, sim, tau,
                                                                               dt, n, **k))


def test_flat_physics_is_not_correct(tiny, monkeypatch):
    _flat_physics(monkeypatch)
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
def test_flat_physics_fails_at_full_size(card, monkeypatch):
    _flat_physics(monkeypatch)
    cell = spec.load(CELL, ROOT)
    for seed, _, nums, _ in control.readings(cell, card, [21, 22], set(), 2.0):
        ok, rows = check.judge(nums, cell.workload["limits"])
        assert not ok, (seed, rows)

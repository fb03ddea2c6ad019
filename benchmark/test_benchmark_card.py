"""The control of ``correct`` on the card: for each cell at 512 envs (the
one-robot cell as it is), three seeds, the program's compared numbers
within their limits and the TF32 control's beyond at least one; and for
each batched cell at its full size, a handful of envs' answers altered in
the program's captured tick fail the check on three seeds. Run on a card
with ``python -m pytest benchmark -q -m cuda -p no:cacheprovider``; it
skips elsewhere."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

from benchmark import control
from benchmark.harness import check, spec

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = spec.load(name, ROOT)
    if cell.traffic["loop"] == "batched":
        t = dict(cell.traffic, envs=512)
        cell = dataclasses.replace(cell, traffic=t, workload={
            **cell.workload, "check": {"chunk_draws": 2, "envs": 512}})
    seeds = [11, 12, 13]
    limits = cell.workload["limits"]
    for seed, side, nums, _ in control.readings(cell, card, seeds, set(seeds), 1.0):
        ok, rows = check.judge(nums, limits)
        assert ok == (side == "program"), (seed, side, rows)


# the program's tick that each batched configuration's entry captures
TICKS = {"hector_srb": ("biped_mpc_py_torch.parallel.rollout", "batched_closed_loop_tick"),
         "hector_art": ("biped_mpc_py_torch.parallel.rollout_art", "_tick_kernel_tick")}
ALTERED_ENVS = 8  # of 4096: one in 512
# the fields of an altered env's state and what is added to each value: the least that
# a handful of envs has to be moved by for the check to see it past the tails of sound
# runs (in the articulated cells sound runs leave robots that flail up to ~0.7 apart
# after one tick; there the position alone is moved, as a robot so moved everywhere
# blows up, and envs left non-finite are the other number's to catch)
ALTERED = {"hector_srb": (None, 0.05), "hector_art": (("pos",), 1.5)}


def _altered(tick, every: int, fields, by: float):
    """Every ``every``-th env's answer altered where it is produced: ``by``
    added to each value of its simulator state's ``fields`` (all where
    None)."""
    import torch

    def f(w, *a, **k):
        new = tick(w, *a, **k)
        n = new.sim.t.shape[0]
        mask = torch.zeros(n, dtype=torch.bool, device=new.sim.t.device)
        mask[::every] = True
        moved = {}
        for name in fields or [f.name for f in dataclasses.fields(new.sim)]:
            t = getattr(new.sim, name)
            moved[name] = torch.where(mask.reshape((-1,) + (1,) * (t.dim() - 1)), t + by, t)
        sim = dataclasses.replace(new.sim, **moved)
        return dataclasses.replace(new, sim=sim)
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c for c in CELLS
                                  if spec.load(c, ROOT).traffic["loop"] == "batched"])
def test_a_handful_of_altered_envs_fails_at_full_size(card, monkeypatch, name):
    import importlib

    cell = spec.load(name, ROOT)
    module, attr = TICKS[cell.config["name"]]
    mod = importlib.import_module(module)
    every = cell.traffic["envs"] // ALTERED_ENVS
    monkeypatch.setattr(mod, attr, _altered(getattr(mod, attr), every,
                                            *ALTERED[cell.config["name"]]))
    seeds = [21, 22, 23]
    for seed, side, nums, _ in control.readings(cell, card, seeds, set(), 2.0):
        ok, rows = check.judge(nums, cell.workload["limits"])
        assert not ok, (seed, rows)

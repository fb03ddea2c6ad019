"""The harness on the CPU at a tiny size: every cell of ``BENCHMARK.json``
found by name and run end to end through the port's plain versions, a new
cell added as files alone, the refusals of ``run.py``, and the check of
``correct`` failing on each fault that a cell's timed path can have."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import spec

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 7
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` copied to ``dest`` with every
    batched traffic cut to 4 envs and 2 ticks a call (all 4 checked) and
    the one-robot traffic to 2 warm-up ticks (3 checked); limits as they
    are."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.npy"))
    shutil.copy(ROOT / "benchmark" / "traffic" / "walk_log.npy", dest / "benchmark" / "traffic")
    for w in BENCH["workloads"]:
        tp = dest / "benchmark" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(tp.read_text())
        wp = dest / "benchmark" / "workloads" / f"{w['name']}.json"
        wl = json.loads(wp.read_text())
        if t["loop"] == "batched":
            t.update(envs=4, ticks_per_call=2)
            wl["check"] = {"chunk_draws": 2, "envs": 4}
        else:
            t["warmup_ticks"] = 2
            wl["check"] = {"ticks": 3}
        tp.write_text(json.dumps(t))
        wp.write_text(json.dumps(wl))
    return dest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def run_tiny(root: Path, name: str) -> dict:
    return run.run_cell(spec.load(name, root), SEED, 0.2, False, CPU, run.T_START)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_cpu(tiny, name):
    r = run_tiny(tiny, name)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"
    cell = spec.load(name, tiny)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert r["attempted"] > 0


def _add_cell(root: Path, name: str, config: str, traffic: str, like: str) -> None:
    """An entry for cell ``name`` in ``root``'s ``BENCHMARK.json``, reporting
    the metrics that cell ``like`` reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_cell_is_found_by_name(tmp_path):
    """Cells added as files and entries of ``BENCHMARK.json`` run, with no
    existing file of ``benchmark/`` edited: one on a new traffic mix, and
    one on a new configuration whose entry is another of the program's
    rollouts (``batched_rollout_fn``, one command for every env), with a
    traffic mix naming a new generator module."""
    root = tiny_copy(tmp_path)
    here = root / "benchmark"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    t = json.loads((here / "traffic/rl_fast_cmd.json").read_text())
    (here / "traffic/new_mix.json").write_text(json.dumps({**t, "command_vx": [0.2, 0.3]}))
    wl = (here / "workloads/srb_cmd_4096.json").read_text()
    (here / "workloads/srb_new.json").write_text(wl)
    _add_cell(root, "srb_new", "hector_srb", "new_mix", "srb_cmd_4096")

    cfg = json.loads((here / "configs/hector_srb.json").read_text())
    cfg["entry"]["batched"].update(program="biped_mpc_py_torch.parallel.rollout.batched_rollout_fn",
                                   takes_command=False)
    (here / "configs/hector_srb_one_cmd.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "hector_srb_one_cmd",
                             "file": "benchmark/configs/hector_srb_one_cmd.json"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "traffic/standing.py").write_text(
        "from benchmark.traffic import generate\n\n\n"
        "def inputs(traffic, mpc, init, takes_command, seed, device):\n"
        "    bipeds, world, _ = generate.inputs(traffic, mpc, init, takes_command, seed, device)\n"
        "    return bipeds, world, None\n")
    (here / "traffic/one_cmd.json").write_text(json.dumps({**t, "generator": "standing",
                                                           "command_vx": None}))
    (here / "workloads/srb_one_cmd.json").write_text(wl)
    _add_cell(root, "srb_one_cmd", "hector_srb_one_cmd", "one_cmd", "srb_cmd_4096")

    for name in ("srb_new", "srb_one_cmd"):
        r = run_tiny(root, name)
        assert r["correct"] and "env_steps_per_s" in r["metrics"], (name, r["compared"])
    assert all(p.read_bytes() == b for p, b in before.items())


def test_metric_readers_found_by_name():
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"], ROOT))


def _cli(cwd: Path, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    r = _cli(ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``benchmark/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _cli(tmp_path, env)
    assert r.returncode != 0 and r.stdout == ""
    assert "biped_mpc_py_torch" in r.stderr


def test_refuses_after_jax_was_imported(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "biped_mpc_py_tpu.ops", sys.modules["json"])
    assert run.forbidden_modules() == ["biped_mpc_py_tpu.ops", "jax"]


# --- faults planted in the timed path: each has to fail the check ---------------


def _unchanged(tick):
    return lambda w, *a, **k: w


def _half_left_out(tick):
    """The tick steps the first half of the batch; the rest keep their
    state."""
    def f(w, *a, **k):
        new = tick(w, *a, **k)
        n = new.sim.t.shape[0]
        keep = torch.arange(n) >= n // 2
        return _where(keep, w, new)
    return f


def _altered(tick):
    """One env's answer altered where it is produced: 0.05 added to every
    value of its state."""
    def f(w, *a, **k):
        new = tick(w, *a, **k)
        first = torch.zeros(new.sim.t.shape[0], dtype=torch.bool)
        first[0] = True
        return dataclasses.replace(new, sim=_where(first, _add(new.sim, 0.05), new.sim))
    return f


def _warm_start_kept(tick):
    """The tick's solve leaves the warm start's iterates (z, y) as they came
    in: the part of the controller state that no first answer shows."""
    def f(w, *a, **k):
        new = tick(w, *a, **k)
        qp = dataclasses.replace(new.ctrl.qp, z=w.ctrl.qp.z, y=w.ctrl.qp.y)
        return dataclasses.replace(new, ctrl=dataclasses.replace(new.ctrl, qp=qp))
    return f


def _clock_and_refs_kept(tick):
    """The gait clock, the command anchor, the velocity integral and the
    pitch reference come out of the tick as they went in."""
    def f(w, *a, **k):
        new = tick(w, *a, **k)
        kept = {n: getattr(w.ctrl, n) for n in ("cmd_ref", "v_int", "t_gait", "hold_count",
                                                 "pitch_ref")}
        return dataclasses.replace(new, ctrl=dataclasses.replace(new.ctrl, **kept))
    return f


def _add(tree, v):
    if isinstance(tree, torch.Tensor):
        return tree + v
    return type(tree)(**{f.name: _add(getattr(tree, f.name), v)
                         for f in dataclasses.fields(tree)})


def _where(mask, a, b):
    if isinstance(a, torch.Tensor):
        m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)
    return type(a)(**{f.name: _where(mask, getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


BATCHED_FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
                  "altered": _altered, "warm_start_kept": _warm_start_kept,
                  "clock_and_refs_kept": _clock_and_refs_kept}
TICKS = {"srb_cmd_4096": ("biped_mpc_py_torch.parallel.rollout", "batched_closed_loop_tick"),
         "srb_default_4096": ("biped_mpc_py_torch.parallel.rollout",
                              "batched_closed_loop_tick"),
         "art_tick_4096": ("biped_mpc_py_torch.parallel.rollout_art", "_tick_kernel_tick")}


@pytest.mark.parametrize("fault", sorted(BATCHED_FAULTS))
@pytest.mark.parametrize("name", [c for c in CELLS if c in TICKS])
def test_batched_fault_is_not_correct(tiny, monkeypatch, name, fault):
    import importlib

    module, attr = TICKS[name]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, BATCHED_FAULTS[fault](getattr(mod, attr)))
    r = run_tiny(tiny, name)
    assert not r["correct"], r["compared"]


def _rt_unchanged_solve(step):
    return lambda self, s: s


def _rt_altered_torque(step):
    def f(self, s):
        out = step(self, s)
        tau = out.tau.clone()
        tau[0, 3] += 1.0
        return dataclasses.replace(out, tau=tau)
    return f


def _rt_half_periods(step):
    """Every other low-level period left out: its torques are the last
    period's."""
    calls = {"n": 0}

    def f(self, s):
        calls["n"] += 1
        return s if calls["n"] % 2 == 0 else step(self, s)
    return f


REALTIME_FAULTS = {"unchanged_solve": ("_solve_step", _rt_unchanged_solve),
                   "altered_torque": ("_lowlevel_step", _rt_altered_torque),
                   "half_periods": ("_lowlevel_step", _rt_half_periods)}


@pytest.mark.parametrize("fault", sorted(REALTIME_FAULTS))
def test_realtime_fault_is_not_correct(tiny, monkeypatch, fault):
    from biped_mpc_py_torch.runtime.realtime import RealtimeLoop

    attr, make = REALTIME_FAULTS[fault]
    monkeypatch.setattr(RealtimeLoop, attr, make(getattr(RealtimeLoop, attr)))
    r = run_tiny(tiny, "art_realtime_n1")
    assert not r["correct"], r["compared"]

"""The port's stage-timing tools (``biped_mpc_py_torch/tools/bench_*.py``) on
the CPU at a tiny size, and the package's exports against the JAX
package's.

- Each tool's command (``main``, which calls ``run``) at 2 envs x 1 tick
  (or 1 call a stage) and 1 round: exit 0, and every record it prints
  parses back, names the tool and one of its variants or stages, and its
  launch table covers it. The times are the card's (``chip_smoke.py``
  phase 24); here the graphs step eagerly and nothing launches.
- ``bench_tick_stages``: ``base`` is ``batched_art_rollout_tick_kernel_fn``,
  and the variant with every flag off bit-equal to it; ``mpc-off`` never
  calls ``solve_mpc`` and holds ``ctrl.qp``; ``minv-off`` hands
  ``fused_tick`` the standing pose's Minv at every tick; the attribution's
  lines sum to ``base``.
- Against the JAX package: the tools' budget equals JAX's
  ``tools/bench_tick_stages.py::fast_art_mpc()`` field by field (the script
  imported by path; it reads ``sys.argv`` at import); ``bench_cone_kernel``'s
  inputs build JAX's ``build_mpc_qp`` QP at ``MpcConfig(mu_z=0.06)`` within
  1e-5 (64 envs); its plain solve agrees with JAX's
  ``solve_qp_batch(backend="xla")`` under ``agreement_faults``, the rule
  ``chip_smoke.py`` holds the kernel to, the floor being JAX's solve
  against the port's plain solve in float64: the median env within 0.01 N
  or twice the floor's (at these 0.01-scale states, forces up to ~200 N,
  the floor's median env is ~0.03 N), the envs past 0.1 N at most twice
  the floor's plus 5, the worst objective excess and constraint violation
  within twice the floor's plus a slack. The rule's clauses one by one,
  and 3 wrong envs of 64 failing it.
- No module of the tools imports JAX or the JAX package.
"""

import ast
import dataclasses
import functools
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_mpc_py_torch
import biped_mpc_py_tpu
from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control.gait import contact_sequence as j_contact
from biped_mpc_py_tpu.control.mpc import build_mpc_qp as j_build
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_torch.config import GaitConfig
from biped_mpc_py_torch.ops.cuda import tick_kernel
from biped_mpc_py_torch.parallel import rollout_art
from biped_mpc_py_torch.sim.engine import ArtState, mass_matrix_inv
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.tools import (
    _harness,
    bench_art_probe,
    bench_art_stages,
    bench_cone_kernel,
    bench_stages,
    bench_tick_kernel,
    bench_tick_stages,
)
from biped_mpc_py_torch.utils.convert import to_numpy
from biped_mpc_py_torch.utils.graphs import leaves
from tests.test_torch_convert import _assert_same, _fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {m.TOOL: m for m in (bench_tick_stages, bench_tick_kernel, bench_stages,
                             bench_art_stages, bench_art_probe, bench_cone_kernel)}
# the records each tool prints besides one per variant or stage
EXTRA = {"bench_tick_stages": {"attribution"}, "bench_tick_kernel": {"speedup"},
         "bench_cone_kernel": {"agreement"}}
CPU = torch.device("cpu")
N = 2


def _names(mod) -> set:
    return set(getattr(mod, "VARIANTS", None) or getattr(mod, "LABELS", None) or mod.LAUNCHES)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_command_prints_parsable_records(tool, capsys, monkeypatch):
    mod = TOOLS[tool]
    monkeypatch.setenv("BENCH_REPS", "1")
    monkeypatch.delenv("BENCH_VARIANTS", raising=False)
    assert mod.main([str(N), "1"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{tool}: device cpu")
    records = [_harness.parse(line) for line in lines if "{" in line]
    names = {r["name"] for r in records}
    assert names == _names(mod) | EXTRA.get(tool, set())
    assert set(mod.LAUNCHES) == _names(mod)
    for r in records:
        assert r["tool"] == tool and r["device"] == "cpu" and r["card"] is None
        if r["name"] in mod.LAUNCHES:
            # the CPU runs the plain versions: no kernel launches
            assert r["launches"] == _harness.launches()
            assert set(r["launches"]) == set(mod.LAUNCHES[r["name"]])
            assert r["envs"] == N and np.isfinite(r["ms"]) and r["ms"] > 0
            assert r["capture_s"] >= 0 and r["pool_mb"] == 0.0
        if "finite" in r:
            assert r["finite"] and r["falls"] >= 0 and r["steps"] == 1


def _tick_inputs():
    mpc = _harness.fast_art_mpc()
    worlds, bipeds = _harness.art_worlds(mpc, N, CPU)
    return mpc, GaitConfig(), worlds, bipeds


def _bit_equal(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y)


def test_tick_stages_base_and_flags_off_are_the_tick_path(monkeypatch):
    """``base`` is the bench's tick path itself, made by its factory (whose
    graph is bit-equal to the eager loop: tests/test_torch_graphs.py); every
    flag off rebuilds it from the stages bit for bit."""
    mpc, gait, worlds, bipeds = _tick_inputs()
    made = []

    def factory(*args, **kwargs):
        made.append((args, kwargs))
        return rollout_art.batched_art_rollout_tick_kernel_fn(*args, **kwargs)

    monkeypatch.setattr(bench_tick_stages, "batched_art_rollout_tick_kernel_fn", factory)
    base = bench_tick_stages.make("base", 2, mpc, gait, CPU)
    assert made == [((2, mpc, gait), {})]
    off = bench_tick_stages.variant_fn(2, mpc, gait, CPU)(worlds, bipeds)
    _bit_equal(off, base(worlds, bipeds))


def test_tick_stages_mpc_off_never_solves(monkeypatch):
    mpc, gait, worlds, bipeds = _tick_inputs()

    def refuse(*args, **kwargs):
        raise AssertionError("solve_qp called with the MPC layer off")

    monkeypatch.setattr(rollout_art, "solve_qp", refuse)
    world = bench_tick_stages.make("mpc", 2, mpc, gait, CPU)(worlds, bipeds)
    assert float(world.metrics.falls.sum()) == 0
    _bit_equal(world.ctrl.qp, worlds.ctrl.qp)
    assert not torch.equal(world.sim.q, worlds.sim.q)


def test_tick_stages_minv_off_holds_the_standing_minv(monkeypatch):
    mpc, gait, worlds, bipeds = _tick_inputs()
    seen = []

    def spy(*args):
        seen.append(args[10].clone())
        return tick_kernel.fused_tick(*args)

    monkeypatch.setattr(bench_tick_stages, "fused_tick", spy)
    bench_tick_stages.make("minv", 3, mpc, gait, CPU)(worlds, bipeds)
    standing = mass_matrix_inv(hector_model(device=CPU), ArtState.standing(1).q)
    assert len(seen) == 3
    for Minv in seen:
        assert torch.equal(Minv, standing.expand(N, 16, 16))


def test_tick_stages_attribution_sums_to_base():
    ms = {"base": 7.0, "mpc": 2.5, "fb": 2.2, "minv": 1.6, "post": 0.4}
    lines = bench_tick_stages.attribution(ms)
    assert len(lines) == 5
    assert sum(lines.values()) == pytest.approx(ms["base"], rel=1e-12)
    assert list(lines.values()) == pytest.approx([4.5, 0.3, 0.6, 1.2, 0.4])


@functools.cache
def _jax_tool():
    """``tools/bench_tick_stages.py`` imported by path, ``sys.argv`` set for
    its module-level ``int(sys.argv[1])``."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_tick_stages", os.path.join(ROOT, "tools", "bench_tick_stages.py"))
    module = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = ["bench_tick_stages.py", "2", "1"]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
    return module


def test_budget_is_the_jax_tools():
    jmpc = _jax_tool().fast_art_mpc()
    _assert_same(_fields(jmpc), to_numpy(_harness.fast_art_mpc()), "fast_art_mpc")
    over = dict(n_admm_iters=1, kinv_ns_iters=1, kinv_bf16_iters=0)
    _assert_same(_fields(_jax_tool().fast_art_mpc(**over)),
                 to_numpy(_harness.fast_art_mpc(**over)), "fast_art_mpc(solver1)")


CONE_ENVS = 64


@functools.cache
def _jax_cone():
    """(JAX's cone QPs, its default-budget xla solve) on the tool's inputs,
    as ``tools/bench_cone_kernel.py`` builds them."""
    mpc = jcfg.MpcConfig(mu_z=0.06)
    contact = j_contact(0.0, mpc, jcfg.GaitConfig())
    x, feet = bench_cone_kernel.state_arrays(CONE_ENVS)
    qp = jax.jit(jax.vmap(lambda xi, f: j_build(xi, 0.0, f, mpc, JBipedParams(), contact)))(
        jnp.asarray(x), jnp.asarray(feet))
    return qp, jqp.solve_qp_batch(qp, mpc, backend="xla")


def test_cone_inputs_build_the_jax_qp():
    jq, _ = _jax_cone()
    tq = bench_cone_kernel.inputs(CONE_ENVS, CPU)
    assert tuple(tq.l.shape) == (CONE_ENVS, 10, 28)
    for f in dataclasses.fields(tq):
        a = getattr(tq, f.name)
        if isinstance(a, torch.Tensor):
            b = np.asarray(getattr(jq, f.name))
            np.testing.assert_allclose(a.numpy(), b.reshape(a.shape), atol=1e-5, rtol=1e-5,
                                       err_msg=f.name)


def test_cone_plain_solve_matches_jax_at_the_default_budget():
    """The plain solve against JAX's xla solve under the rule that
    ``chip_smoke.py`` holds the kernel to (``agreement_faults``): the floor
    is JAX's solve against the port's float64 plain solve."""
    jq, sol_j = _jax_cone()
    mpc = bench_cone_kernel.mpc_config()
    tq = bench_cone_kernel.inputs(CONE_ENVS, CPU)
    sol = _harness.solve_plain(tq, mpc)
    sol64 = _harness.solve_plain(tq.map(torch.Tensor.double), mpc)
    jax_sol = types.SimpleNamespace(controls=torch.from_numpy(np.array(sol_j.controls)),
                                    res_prim=torch.from_numpy(np.array(sol_j.res_prim)))
    assert torch.isfinite(sol.controls).all()
    r = bench_cone_kernel.agreement(tq, sol, jax_sol, sol64)
    assert bench_cone_kernel.agreement_faults(r) == [], r


def _cone_record(**kw):
    fine = {"median": 0.03, "past": 40, "excess": 0.01, "res_prim": 0.1, "floor_median": 0.03,
            "floor_past": 180, "floor_excess": 0.01, "floor_res_prim": 0.1}
    return fine | kw


@pytest.mark.parametrize("broken, fault", [
    ({}, None),
    ({"median": 0.07}, "median"),
    ({"median": 0.009, "floor_median": 0.001}, None),
    ({"past": 366}, "envs past"),
    ({"excess": 0.0211}, "objective"),
    ({"excess": 0.0019, "floor_excess": -0.5}, "objective"),
    ({"res_prim": 0.2011}, "res_prim"),
])
def test_cone_agreement_faults(broken, fault):
    faults = bench_cone_kernel.agreement_faults(_cone_record(**broken))
    assert faults == [] if fault is None else len(faults) == 1 and fault in faults[0]


def test_cone_agreement_catches_a_few_wrong_envs():
    """3 envs of 64 off by 0.3 N (seeded noise) pass the median and the
    count past 0.1 N but not the objective clause; the plain solve held to
    itself passes."""
    mpc = bench_cone_kernel.mpc_config()
    tq = bench_cone_kernel.inputs(CONE_ENVS, CPU)
    sol = _harness.solve_plain(tq, mpc)
    sol64 = _harness.solve_plain(tq.map(torch.Tensor.double), mpc)
    assert bench_cone_kernel.agreement_faults(
        bench_cone_kernel.agreement(tq, sol, sol, sol64)) == []
    controls = sol.controls.clone()
    controls[:3] += 0.3 * torch.randn(controls[:3].shape,
                                      generator=torch.Generator().manual_seed(1))
    r = bench_cone_kernel.agreement(tq, dataclasses.replace(sol, controls=controls), sol, sol64)
    assert r["past"] <= 3 and r["median"] == 0.0
    faults = bench_cone_kernel.agreement_faults(r)
    assert len(faults) == 1 and "objective" in faults[0]


def _imports(path) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_tools_import_no_jax():
    folder = os.path.join(ROOT, "biped_mpc_py_torch", "tools")
    files = [f for f in os.listdir(folder) if f.endswith(".py")]
    assert {f"{t}.py" for t in TOOLS} <= set(files)
    for f in files:
        roots = {name.split(".")[0] for name in _imports(os.path.join(folder, f))}
        assert not roots & {"jax", "jaxlib", "biped_mpc_py_tpu", "tools"}, f


# JAX's exports the port covers otherwise: the batched rollouts at N = 1 are
# the single-env rollouts, and ops.qp.solve_qp (batched) with the kernel
# wrapper is solve_qp_batch.
NOT_EXPORTED = {
    "rollout_fn": "batched_rollout_fn at N = 1",
    "art_rollout_fn": "batched_art_rollout_fn at N = 1",
    "solve_qp_batch": "ops.qp.solve_qp, batched, and the kernel wrapper",
}


def test_exports_cover_the_jax_packages():
    missing = set(biped_mpc_py_tpu.__all__) - set(biped_mpc_py_torch.__all__)
    assert missing == set(NOT_EXPORTED)
    for name in set(biped_mpc_py_tpu.__all__) - set(NOT_EXPORTED):
        assert getattr(biped_mpc_py_torch, name) is not None, name

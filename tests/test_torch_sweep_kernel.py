"""A config per env on the tick-kernel path, on the CPU: the path choice of
``parallel/rollout_art.py::art_closed_loop_tick``, the table of each env's
control constants (``ops/cuda/tick_kernel.py::tick_table``) and the tick
kernel's per-env wrapper ``fused_tick(x_cmd=, per_env=, bipeds=, table=)``.

On the card a config per env on flat ground with one ``dt``, a walking gait
and one mass-matrix inverse a tick runs the low-level loop as one launch of
``tick_kernel<PlaneTable>``, which reads each env's row of the table
(``tests/test_torch_cuda.py`` holds the kernel against its plain version);
every other input keeps the plain chain. On the CPU the wrapper runs the
plain per-env periods, so here:

- (a) ``fused_tick`` with per-env values equals the plain per-env periods
  (``feedback_and_soles``, ``low_level_control(x_cmd=, per_env=)`` with each
  env's robot, ``fused_substeps_reference``) bit for bit, and launches
  nothing;
- (b) with no field that differs, the table is the shared tick buffer's
  control block in every row, bit for bit; with per-env values equal to the
  config's it differs from it only in the five products of a config value
  with another, by an f32 rounding;
- (c) one env of a sweep through the tick path matches a one-config run of
  that env's config, within a tolerance given beside it;
- (d) the port's tick path with ``x_cmd`` and ``per_env`` matches the
  benchmark's plain reference ``benchmark/reference/entries_sweep.py::
  art_sweep_tick`` on the sweep generator's seeded configs, and the planted
  fault (every env given env 0's values below the MPC) fails each of the
  same tolerances;
- the per-env tick records the stage ``art.tick_table`` between ``art.minv``
  and ``art.tick_kernel``, and every input the path refuses (a per-env
  ``dt``, a running gait, ``minv_ll_hold < n_lowlevel``, a field) runs the
  plain chain as it is written out here.

4 envs, the fast budget with the bf16 knobs off (``FAST``) unless the
cell's traffic sets them, 8 periods of 5 substeps, 1 or 2 ticks.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import biped_mpc_py_torch as bt
from benchmark.harness import common, tree
from benchmark.reference import config as rconfig
from benchmark.reference import entries_sweep
from benchmark.reference.loops import init_art_world as ref_init_art_world
from benchmark.reference.precision import matmul
from benchmark.traffic import sweep as sweep_traffic
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.ops.cuda import substep_kernel, tick_kernel
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.parallel.sweep import stack_configs
from biped_mpc_py_torch.sim import engine
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.graphs import leaves
from tests.test_torch_cuda import _tick_config
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N, N_LL, N_SUB = 4, 8, 5
FAST = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
MODEL = hector_model(device="cpu")
GAIT = bt.GaitConfig(steps_per_phase=2)
# the table's columns that multiply a config value by another (or take the
# root of one): the shared buffer forms them from Python floats and rounds
# once, the table in f32 where an operand is per env
PRODUCTS = ("H_rate", "kp_over", "kc_base", "ff", "yaw_lead")


def _base():
    """The sweep cell's base config (``benchmark/configs/hector_art_sweep.json``)
    at the fast budget."""
    return tra.art_mpc_config(x_cmd=tra._x_cmd(vx=0.4), swing_z_sin2=True,
                              cmd_body_frame=True, **FAST)


def _configs():
    """Four configs that differ in the command, the swing, Raibert and
    heading gains, the touchdown overdrive, the weights and the ADMM
    numerics."""
    base = _base()
    return [
        base,
        dataclasses.replace(base, x_cmd=tra._x_cmd(vx=0.8, wz=0.2), kp_swing=700.0,
                            swing_height=0.07, raibert_capture_gain=0.35, admm_rho=0.15,
                            Q=tuple(2.0 * q for q in base.Q)),
        dataclasses.replace(base, x_cmd=tra._x_cmd(vx=1.0, wz=0.1), raibert_ff_scale=0.8,
                            cmd_leak_yaw=0.1, kp_hipyaw=0.5, kd_hipyaw=0.05, admm_alpha=1.45,
                            swing_td_overdrive=0.01, R=tuple(0.6 * r for r in base.R)),
        dataclasses.replace(base, x_cmd=tra._x_cmd(vx=0.6, wz=0.3), kp_swing=550.0,
                            swing_height=0.05, admm_rho=0.8, admm_alpha=1.75,
                            raibert_capture_gain=0.45),
    ]


def _sweep():
    """(mpc, x_cmd, per_env) of the four configs."""
    mpc, per_env = stack_configs(_configs(), device="cpu")
    x_cmd, fields = tra.split_per_env(per_env)
    return mpc, x_cmd, fields


@functools.cache
def _world():
    """Perturbed standing envs a tick into the sweep's walk, so that the
    controller's carry (cmd_ref, v_int, the warm start) is not cold."""
    mpc, x_cmd, per_env = _sweep()
    w = bt.perturbed_worlds(_base(), N, torch.Generator().manual_seed(21), device="cpu")
    return tra._tick_kernel_tick(w, bt.BipedParams().expand(N), mpc, GAIT, MODEL,
                                 bt.BipedParams(), N_LL, N_SUB, x_cmd=x_cmd, per_env=per_env)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


def _launches():
    return tick_kernel.fused_tick.launches, substep_kernel.fused_substeps.launches


def _tick_args(w, mpc, x_cmd, per_env):
    """The MPC stage's outputs of ``w`` as ``fused_tick``'s arguments."""
    _, _, _, contact, sol = tra._art_control_stage(w, bt.BipedParams().expand(N), mpc, GAIT,
                                                   MODEL, None, x_cmd, per_env)
    Minv = engine.mass_matrix_inv(MODEL, w.sim.q)
    return (sol.controls[:, 0], contact[:, 0, 0:2], w.sim.t, w.ctrl.cmd_ref[:, 2],
            w.ctrl.v_int, Minv)


def _two_geometries(n=N):
    """Even envs on the FK leg geometry, odd envs on the Jacobian one."""
    from biped_mpc_py_torch.models.biped import HECTOR_LEG_FK, HECTOR_LEG_JAC

    fk = bt.BipedParams(leg_jac=HECTOR_LEG_FK).expand(n)
    jac = bt.BipedParams(leg_jac=HECTOR_LEG_JAC).expand(n)
    return fk.where(torch.arange(n) % 2 == 1, jac)


@pytest.mark.parametrize("geometry", ["nominal", "two"])
def test_fused_tick_per_env_on_cpu_is_the_plain_per_env_periods(geometry):
    """(a) On CPU tensors ``fused_tick`` with a config per env (and its
    table) is the plain per-env periods of the tick, bit for bit with the
    clock and the energy, and launches nothing; with two leg geometries each
    env reads its own robot's."""
    mpc, x_cmd, per_env = _sweep()
    w = _world()
    bipeds = bt.BipedParams().expand(N) if geometry == "nominal" else _two_geometries()
    u0, c0, t0, cmd_yaw, v_int, Minv = _tick_args(w, mpc, x_cmd, per_env)
    ll_dt = mpc.dt / N_LL
    sim, energy = w.sim, torch.zeros_like(t0)
    for p in range(N_LL):
        x, pf = engine.feedback_and_soles(MODEL, sim)
        tau = low_level_control(x, t0 + p * ll_dt, pf, sim.q, sim.qd, mpc, bipeds,
                                c0[:, None, :], u0, gait=GAIT, cmd_ref=w.ctrl.cmd_ref,
                                v_int=v_int, x_cmd=x_cmd, per_env=per_env)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * ll_dt
        sim = substep_kernel.fused_substeps_reference(MODEL, sim, tau, Minv, ll_dt, N_SUB)
    want = dataclasses.replace(sim, t=w.sim.t + mpc.dt)
    table = tick_kernel.tick_table(bipeds, mpc, GAIT, x_cmd, per_env)
    before = _launches()
    out, e = tick_kernel.fused_tick(MODEL, bt.BipedParams(), mpc, GAIT, w.sim, u0, c0, t0,
                                    cmd_yaw, v_int, Minv, N_LL, N_SUB, x_cmd=x_cmd,
                                    per_env=per_env, bipeds=bipeds, table=table)
    assert _launches() == before
    assert _equal(out, want) and torch.equal(e, energy)
    if geometry == "two":
        nominal, _ = tick_kernel.fused_tick(
            MODEL, bt.BipedParams(), mpc, GAIT, w.sim, u0, c0, t0, cmd_yaw, v_int, Minv,
            N_LL, N_SUB, x_cmd=x_cmd, per_env=per_env, bipeds=bt.BipedParams().expand(N))
        # the nominal robot's Jacobian geometry is the FK one (BipedParams().leg)
        assert torch.equal(out.q[0::2], nominal.q[0::2])
        assert not torch.equal(out.q[1::2], nominal.q[1::2])


@pytest.mark.parametrize("preset", ["walk", "loaded", "compat"])
def test_table_without_differing_fields_is_the_shared_buffer(preset):
    """(b) With no field that differs (``x_cmd`` None, ``per_env`` empty)
    every row of the table is the shared tick buffer's control block, bit
    for bit. With every field per env at the config's own value, the columns
    that take one value are still the buffer's; the five products round in
    f32 where the buffer rounds a double product once: within 2 ulps (each
    operand's rounding and the product's)."""
    mpc, gait = _tick_config(preset), bt.GaitConfig(steps_per_phase=5)
    bipeds = bt.BipedParams().expand(N)
    shared = tick_kernel.tick_constants(MODEL, bt.BipedParams(), mpc, gait, "cpu")
    block = shared[-len(tick_kernel.CONTROL_NAMES):]
    table = tick_kernel.tick_table(bipeds, mpc, gait, None, {})
    assert table.shape == (N, len(tick_kernel.CONTROL_NAMES)) and table.dtype == torch.float32
    assert torch.equal(table, block.expand(N, -1))
    fields = [f for f in tick_kernel.TABLE_FIELDS if f not in ("Q", "R")]
    same = {f: torch.full((N,), float(getattr(mpc, f))) for f in fields}
    x_cmd = torch.tensor(mpc.x_cmd).expand(N, 12).clone()
    per_env = tick_kernel.tick_table(bipeds, mpc, gait, x_cmd, same)
    for i, name in enumerate(tick_kernel.CONTROL_NAMES):
        col, want = per_env[:, i], block[i].expand(N)
        if name in PRODUCTS:
            ulps = 2 * torch.finfo(torch.float32).eps * want.abs()
            assert bool(((col - want).abs() <= ulps).all()), name
        else:
            assert torch.equal(col, want), name


def test_table_columns_are_the_plain_chains_expressions():
    """Each product column of a per-env table is the plain chain's own
    tensor expression of the env's values (``control/swing.py``,
    ``control/reference.py``), bit for bit, and the other columns the
    env's values."""
    mpc, x_cmd, per_env = _sweep()
    table = tick_kernel.tick_table(bt.BipedParams().expand(N), mpc, GAIT, x_cmd, per_env)
    col = dict(zip(tick_kernel.CONTROL_NAMES, table.T))
    t_p = GAIT.steps_per_phase * mpc.dt
    rate = np.pi / t_p
    kp = per_env["kp_swing"]
    assert torch.equal(col["H_rate"], per_env["swing_height"] * rate)
    assert torch.equal(col["kp_over"], kp * per_env["swing_td_overdrive"])
    assert torch.equal(col["ff"], 0.5 * t_p * per_env["raibert_ff_scale"])
    assert torch.equal(col["yaw_lead"], x_cmd[:, 8] * 0.5 * t_p)
    assert torch.equal(col["kc_base"], torch.sqrt(torch.clamp(x_cmd[:, 5], min=0.0) / 9.81))
    for name, field in (("kp", "kp_swing"), ("H", "swing_height"),
                        ("capture_gain", "raibert_capture_gain"),
                        ("kp_hipyaw", "kp_hipyaw"), ("kd_hipyaw", "kd_hipyaw")):
        assert torch.equal(col[name], per_env[field]), name
    for i in (2, 3, 4, 8, 9, 10):
        assert torch.equal(col[f"xc{i}"], x_cmd[:, i])
    assert torch.equal(col["kd"], torch.full((N,), np.float32(mpc.kd_swing)))


# One env of the sweep against its own config through the tick path (the
# MPC stage, the per-env periods, the post stage), 2 ticks. The shared path
# forms the products of two config values (the swing rate times the apex,
# the capture root of the commanded height, ...) from Python floats and
# rounds once; the per-env path forms them in f32 from f32 values, a
# rounding apart (1 ulp), which the tick then carries: at most a few ulps of
# the state's scale. Measured 0 on these inputs (the roundings agree here).
ONE_ENV_TOL = {"pos": 1e-6, "quat": 1e-6, "q": 1e-5, "v_base": 1e-4, "qd": 1e-3, "t": 0.0,
               "u0": 1e-3}


def test_one_env_of_a_sweep_is_its_own_config_run():
    """(c)"""
    mpc, x_cmd, per_env = _sweep()
    w, b = _world(), bt.BipedParams().expand(N)
    sweep = w
    for _ in range(2):
        sweep = tra._tick_kernel_tick(sweep, b, mpc, GAIT, MODEL, bt.BipedParams(), N_LL,
                                      N_SUB, x_cmd=x_cmd, per_env=per_env)
    for i, config in enumerate(_configs()):
        alone = w
        for _ in range(2):
            alone = tra._tick_kernel_tick(alone, b, config, GAIT, MODEL, bt.BipedParams(),
                                          N_LL, N_SUB)
        for name, tol in ONE_ENV_TOL.items():
            a = alone.ctrl.qp.controls[:, 0] if name == "u0" else getattr(alone.sim, name)
            s = sweep.ctrl.qp.controls[:, 0] if name == "u0" else getattr(sweep.sim, name)
            assert float((a[i] - s[i]).abs().max()) <= tol, (i, name)
    # the configs were felt: each env walks apart from env 0's config run on it
    assert float((sweep.sim.q[1:] - w.sim.q[1:]).abs().max()) > 1e-3


# --- against the benchmark's reference ---------------------------------------

# The reference is frozen from the port's plain code, so on the CPU the two
# run the same f32 arithmetic and agree to the bit today; each tolerance
# (tests/test_torch_terrain_entry.py's) leaves room for f32 roundoff a
# reordered sum would carry through 2 ticks of 40 substeps, and is far below
# what the planted fault moves on these inputs (pose 0.143, velocity 2.07,
# force 26.7 N; the sound run reads 0 in each).
TOL = {"pose": 1e-5, "velocity": 1e-3, "force": 1e-2}


@functools.cache
def _cell_inputs():
    """The sweep cell's traffic at 4 envs: robots, starts and configs drawn
    from a seed by its generator (``benchmark/traffic/sweep.py``), and the
    reference's and the port's configs."""
    cfg = json.loads((ROOT / "benchmark/configs/hector_art_sweep.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/sweep_p2_fast.json").read_text())
    traffic = {**traffic, "envs": N}
    mpc_kw = {**cfg["mpc"], **traffic["budget"]}
    rmpc, rgait = rconfig.MpcConfig(**mpc_kw), rconfig.GaitConfig(**cfg["gait"])
    bipeds, world, per_env = sweep_traffic.inputs(traffic, rmpc, ref_init_art_world,
                                                  2**31 + 25, torch.device("cpu"))
    return (cfg["entry"]["sweep"]["kwargs"], rmpc, rgait, bipeds, world, per_env,
            bt.MpcConfig(**mpc_kw), bt.GaitConfig(**cfg["gait"]))


def _env0_below_the_mpc(monkeypatch):
    """The planted fault: the tick kernel gets env 0's command, gains and
    table row for every env (the MPC and post stages keep each env's)."""
    fused = tra.fused_tick

    def row0(t):
        return None if t is None else t[:1].expand_as(t)

    def faulty(*args, x_cmd=None, per_env=None, table=None, **kw):
        per_env = None if per_env is None else {k: row0(v) for k, v in per_env.items()}
        return fused(*args, x_cmd=row0(x_cmd), per_env=per_env, table=row0(table), **kw)

    monkeypatch.setattr(tra, "fused_tick", faulty)


def _program():
    kw, _, _, bipeds, world, per_env, mpc, gait = _cell_inputs()
    reg = common.port_classes()
    w, b = tree.rebuild(world, reg), tree.rebuild(bipeds, reg)
    return bt.batched_art_rollout_tick_kernel(
        w, b, 2, mpc, gait, n_lowlevel=kw["n_lowlevel"], n_substeps=kw["n_substeps"],
        per_env={k: v.clone() for k, v in per_env.items()})


@functools.cache
def _reference():
    kw, rmpc, rgait, bipeds, world, per_env, _, _ = _cell_inputs()
    values = dict(per_env)
    x_cmd = values.pop("x_cmd")
    w = world
    with matmul(), torch.no_grad():
        for _ in range(2):
            w = entries_sweep.art_sweep_tick(w, bipeds, rmpc, rgait, x_cmd, per_env=values, **kw)
    return w


def _gaps(a, b) -> dict:
    def gap(fields):
        return max(float((getattr(a.sim, f) - getattr(b.sim, f)).abs().max()) for f in fields)

    force = float((a.ctrl.qp.controls[:, 0] - b.ctrl.qp.controls[:, 0]).abs().max())
    return {"pose": gap(("pos", "quat", "q")), "velocity": gap(("v_base", "qd")),
            "force": force}


@pytest.mark.parametrize("fault", [False, True], ids=["sweep", "env0_row_fault"])
def test_tick_path_matches_the_sweep_reference(fault, monkeypatch):
    """(d)"""
    per_env = _cell_inputs()[5]
    assert {"x_cmd", "Q", "R", "admm_rho", "admm_alpha", "kp_swing"} <= set(per_env)
    if fault:
        _env0_below_the_mpc(monkeypatch)
    gaps = _gaps(_program(), _reference())
    within = {k: v <= TOL[k] for k, v in gaps.items()}
    assert all(v != fault for v in within.values()), gaps


# --- the path and its stages ---------------------------------------------------

def test_per_env_tick_records_the_table_stage():
    mpc, x_cmd, per_env = _sweep()
    with profiling.tracing() as spans:
        tra._tick_kernel_tick(_world(), bt.BipedParams().expand(N), mpc, GAIT, MODEL,
                              bt.BipedParams(), N_LL, N_SUB, x_cmd=x_cmd, per_env=per_env)
    assert [s.name for s in spans] == ["art.feedback", "mpc.build", "qp.ruiz", "qp.kernel",
                                       "qp.unscale", "art.minv", "art.tick_table",
                                       "art.tick_kernel", "tick.post"]


def _plain_tick(w, mpc, gait, terrain, hold, x_cmd=None, per_env=None):
    """The plain chain's tick, written out: ``_art_tick`` with each period's
    physics ``art_step``'s."""

    def physics(sim, tau, Minv, dt):
        return tra.art_step(MODEL, sim, tau, dt, N_SUB, terrain, Minv=Minv)

    return tra._art_tick(w, bt.BipedParams().expand(N), mpc, gait, MODEL, N_LL, hold, physics,
                         terrain, x_cmd, per_env)


def _case(case):
    """(mpc, gait, terrain, minv_ll_hold, x_cmd, per_env, takes the path)."""
    mpc, x_cmd, per_env = _sweep()
    if case == "sweep":
        return mpc, GAIT, None, N_LL, x_cmd, per_env, True
    if case == "x_cmd_only":
        return _base(), GAIT, None, N_LL, x_cmd, None, True
    if case == "per_env_dt":
        mm, pe = stack_configs([dataclasses.replace(c, dt=0.035 + 0.0025 * i)
                                for i, c in enumerate(_configs())], device="cpu")
        x, f = tra.split_per_env(pe)
        return mm, GAIT, None, N_LL, x, f, False
    if case == "running_gait":
        mm, pe = stack_configs([dataclasses.replace(tra.art_config_for_run(0.3, **FAST)[0],
                                                    kp_hipyaw=k) for k in (0.0, 1.2, 2.4, 3.6)],
                               device="cpu")
        return mm, bt.GaitConfig(steps_per_phase=2, flight_steps=1), None, N_LL, None, pe, False
    if case == "minv_hold_4":
        return mpc, GAIT, None, 4, x_cmd, per_env, False
    fields = bt.Terrain.rough_batch(torch.Generator().manual_seed(22), N, amplitude=0.04,
                                    res=16, device="cpu")
    return mpc, GAIT, fields, N_LL, x_cmd, per_env, False


@pytest.mark.parametrize("case", ["sweep", "x_cmd_only", "per_env_dt", "running_gait",
                                  "minv_hold_4", "field"])
def test_path_choice_and_the_cpu_keep_the_plain_chain(case):
    """The card's choice of the per-env tick path, and on the CPU every
    input, the path's own included, runs the plain chain, bit for bit."""
    mpc, gait, terrain, hold, x_cmd, per_env, takes = _case(case)
    assert tra._tick_table_path(terrain, gait, N_LL, hold, x_cmd, per_env) == takes
    w = _world()
    want = _plain_tick(w, mpc, gait, terrain, hold, x_cmd, per_env)
    before = _launches()
    got = tra.art_closed_loop_tick(w, mpc, gait, bt.BipedParams().expand(N), MODEL, N_LL,
                                   N_SUB, terrain, hold, x_cmd=x_cmd, per_env=per_env)
    assert _launches() == before
    assert _equal(got, want)


@pytest.mark.parametrize("fault", ["dt", "field", "unknown", "no_robots", "table_shape",
                                   "table_alone"])
def test_fused_tick_refuses_what_the_table_cannot_hold(fault):
    mpc, x_cmd, per_env = _sweep()
    w = _world()
    kw = dict(x_cmd=x_cmd, per_env=dict(per_env), bipeds=bt.BipedParams().expand(N))
    match = {"dt": "plain chain", "field": "plain chain", "unknown": "no per-env",
             "no_robots": "bipeds", "table_shape": "table has shape",
             "table_alone": "per-env variant"}[fault]
    if fault == "dt":
        kw["per_env"]["dt"] = torch.full((N,), 0.035)
    elif fault == "field":
        kw["terrain"] = bt.Terrain.rough_batch(torch.Generator().manual_seed(2), N, res=16,
                                               device="cpu")
    elif fault == "unknown":
        kw["per_env"]["h"] = torch.full((N,), 10.0)
    elif fault == "no_robots":
        kw["bipeds"] = None
    elif fault == "table_shape":
        kw["table"] = torch.zeros(N, len(tick_kernel.CONTROL_NAMES) - 1)
    else:
        kw = dict(table=torch.zeros(N, len(tick_kernel.CONTROL_NAMES)))
    before = _launches()
    with pytest.raises(ValueError, match=match):
        tick_kernel.fused_tick(MODEL, bt.BipedParams(), mpc, GAIT, w.sim,
                               *_tick_args(w, mpc, x_cmd, per_env), N_LL, N_SUB, **kw)
    assert _launches() == before

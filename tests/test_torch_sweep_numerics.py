"""Every dynamic config field per env: the MPC stage, the gait clock and the
solver numerics of the torch port against the JAX package, where the same
configs are stacked by ``stack_configs`` and vmapped.

Inputs come from numpy with a seed. Tolerances:
- (a) the QP with per-env ``admm_rho``, ``admm_sigma``, ``admm_alpha``,
  ``Q``, ``R`` and line-foot margins, 16 envs at the bench budget, against
  ``jax.vmap(solve_qp)``: controls 0.1 N, states 2e-2, res_prim 5e-3, the
  whole-solve bounds of ``tests/test_qp_kernel.py`` (f32 roundoff through
  the ADMM iterations; measured 7.0e-3 N, 5.7e-5, 2.7e-4);
- (b) the gait clock with per-env ``dt`` over 3,000 accumulated ticks:
  ``phase_index``, ``contact_sequence`` and ``advance_gait_clock``'s steps
  and holds equal, its times bit-equal; per env the port divides ``t / dt``
  as the vmapped JAX program does, and with one shared ``dt`` it multiplies
  by the reciprocal that XLA folds a constant divisor into;
- (c) ``solve_mpc`` with all 22 fields per env, 8 envs at the bench budget:
  the contact windows equal, controls 0.1 N, states 2e-2 (measured 2.3e-3
  N, 4.7e-5); two ``control_tick`` calls on the contact-sensed clock from
  a per-env ``ControllerState.init``: the gait clock and holds equal,
  torques 1e-2 N m (the first control's roundoff through the leg
  Jacobians; measured 1.2e-3), the carried pitch reference, command anchor
  and velocity integral 1e-5 (measured 3.7e-9);
- (d) ``art_sweep``, 3 configs x 2 ticks with all 22 fields differing,
  against ``art_sweep_fn`` with the configs carried across by
  ``utils/convert.py::config_batch_from_numpy``: ``CHAIN_BOUNDS`` of
  ``tests/test_torch_rollout_art.py`` (measured pos 1.6e-7, quat 5.9e-7,
  v_base 2.8e-5, q 6.2e-6, qd 2.2e-4), each env's clock ``t`` bit-equal
  (each env steps its own ``dt`` in f32, as JAX does), the controller
  state within 1e-4;
- (e) nothing per env: an empty ``per_env`` is bit-equal to none, and (N,)
  tensors all equal to the scalar numerics are bit-equal to the scalar
  call of ``fused_qp_solve_reference`` (the plain version runs the same f32
  arithmetic for both).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control import gait as jgait
from biped_mpc_py_tpu.control import mpc as jmpc
from biped_mpc_py_tpu.models import biped as jbiped
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.parallel import sweep as jsweep
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import gait as tgait
from biped_mpc_py_torch.control import mpc as tmpc
from biped_mpc_py_torch.models.biped import HECTOR_LEG_JAC, BipedParams
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.ops.cuda import qp_kernel, substep_kernel
from biped_mpc_py_torch.parallel import sweep as tsweep
from biped_mpc_py_torch.sim.engine import mass_matrix_inv
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils.convert import config_batch_from_numpy, from_numpy, to_numpy
from torch_threads import one_torch_thread  # noqa: F401

CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}
# the bench budget with the JAX bf16 knobs off: both packages in f32
BENCH = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
SOLVE_BOUNDS = {"controls": 0.1, "states": 2e-2, "res_prim": 5e-3}
TICK_BOUNDS = {"tau": 1e-2, "state": 1e-5}


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _port(cls, obj):
    return from_numpy(cls, _fields(obj))


def _per_env_configs(base, n, seed, names=tcfg.MPC_PER_ENV_FIELDS):
    """n configs with every field of ``names`` drawn per env around
    ``base``'s operating point."""
    rng = np.random.default_rng(seed)
    draws = {
        "dt": lambda: rng.uniform(0.03, 0.045),
        "Q": lambda: np.asarray(base.Q) * rng.uniform(0.5, 2.0, 13),
        "R": lambda: np.asarray(base.R) * rng.uniform(0.5, 2.0, 12),
        "kv": lambda: rng.uniform(0.0, 0.03),
        "lf_toe_shrink": lambda: rng.uniform(0.005, 0.02),
        "lf_heel_shrink": lambda: rng.uniform(0.005, 0.025),
        "raibert_capture_gain": lambda: rng.uniform(0.3, 0.6),
        "raibert_am_x": lambda: rng.uniform(0.0, 0.03),
        "raibert_am_y": lambda: rng.uniform(0.0, 0.03),
        "raibert_pitch_place": lambda: rng.uniform(0.0, 0.25),
        "raibert_pitch_nom": lambda: rng.uniform(0.0, 0.15),
        "raibert_ff_scale": lambda: rng.uniform(0.75, 1.0),
        "raibert_vint": lambda: rng.uniform(0.0, 0.1),
        "capture_sched": lambda: rng.uniform(0.0, 0.3),
        "pitch_ref_leak": lambda: rng.choice([0.0, rng.uniform(0.05, 0.3)]),
        "cmd_leak_yaw": lambda: rng.uniform(0.02, 0.12),
        "cmd_v_int_gain": lambda: rng.uniform(0.0, 0.1),
        "cmd_v_int_max": lambda: rng.uniform(0.2, 0.4),
        "cmd_v_int_ref_scale": lambda: rng.uniform(0.0, 1.0),
        "admm_rho": lambda: 10 ** rng.uniform(-1.0, 0.5),
        "admm_sigma": lambda: 10 ** rng.uniform(-6.0, -4.0),
        "admm_alpha": lambda: rng.uniform(1.2, 1.8),
    }
    out = []
    for _ in range(n):
        kw = {}
        for name in names:
            v = draws[name]()
            kw[name] = jnp.asarray(v, jnp.float32) if np.ndim(v) else float(v)
        out.append(dataclasses.replace(base, **kw))
    return out


def _stack(configs):
    """(JAX stacked config, axes, port config, per_env on the CPU)."""
    jm, axes = jsweep.stack_configs(configs)
    tm, per_env = tsweep.stack_configs([_port(tcfg.MpcConfig, c) for c in configs],
                                       device="cpu")
    return jm, axes, tm, per_env


def _mpc_inputs(n, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.normal(size=(n, 12)) * [0.05, 0.05, 0.2, 0.05, 0.05, 0.02, 0.2, 0.2, 0.2,
                                     0.2, 0.2, 0.05]
         + [0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0.2, 0, 0]).astype(f32)
    foot = (np.tile([-0.02, 0.09, 0, -0.02, -0.09, 0], (n, 1))
            + rng.normal(size=(n, 6)) * 0.02).astype(f32)
    foot[:, [2, 5]] = 0.0
    return dict(
        x=x, foot=foot, t=rng.uniform(0.0, 2.0, n).astype(f32),
        cmd_ref=(rng.normal(size=(n, 3)) * 0.1).astype(f32),
        v_int=(rng.normal(size=(n, 2)) * 0.05).astype(f32),
        pitch_ref=(rng.normal(size=n) * 0.05).astype(f32),
    )


def _leaves(sol):
    return [getattr(sol, f.name) for f in dataclasses.fields(sol)]


def _close_solution(sol_t, sol_j):
    for key, tol in SOLVE_BOUNDS.items():
        err = float(np.abs(getattr(sol_t, key).numpy() - np.asarray(getattr(sol_j, key))).max())
        assert err <= tol, (key, err, tol)


def test_qp_per_env_numerics_matches_jax():
    """(a) The plain ``solve_qp`` with per-env numerics, weights and
    margins against ``jax.vmap(solve_qp)``; the per-env values reach the
    solve (it differs from the first config's)."""
    n = 16
    names = ("admm_rho", "admm_sigma", "admm_alpha", "Q", "R", "lf_toe_shrink",
             "lf_heel_shrink")
    base, gait = jcfg.default_mpc_config(**BENCH), jcfg.GaitConfig()
    jm, axes, tm, per_env = _stack(_per_env_configs(base, n, 0, names))
    assert set(per_env) == set(names)
    a = _mpc_inputs(n, 1)
    jb = jax.tree.map(lambda v: jnp.broadcast_to(v, (n,) + jnp.shape(v)), jbiped.BipedParams())

    def one(m, x, t, foot, b):
        c = jgait.contact_sequence(t, m, gait)
        return jqp.solve_qp(jmpc.build_mpc_qp(x, t, foot, m, b, c, gait), m)

    sol_j = jax.jit(jax.vmap(one, in_axes=(axes, 0, 0, 0, 0)))(
        jm, a["x"], a["t"], a["foot"], jb)
    tg = _port(tcfg.GaitConfig, gait)
    x, t, foot = (torch.from_numpy(a[k]) for k in ("x", "t", "foot"))
    tb = BipedParams().expand(n)
    qp = tmpc.build_mpc_qp(x, t, foot, tm, tb, tgait.contact_sequence(t, tm, tg), tg,
                           per_env=per_env)
    sol_t = tqp.solve_qp(qp, tm, per_env=per_env)
    _close_solution(sol_t, sol_j)
    shared = tqp.solve_qp(tmpc.build_mpc_qp(x, t, foot, tm, tb,
                                            tgait.contact_sequence(t, tm, tg), tg), tm)
    assert float((sol_t.controls - shared.controls).abs().max()) > 1.0


def _clock_case(shared):
    dts = np.full(8, 0.04) if shared else np.array(
        [0.03, 0.035, 0.04, 0.045, 0.025, 0.05, 0.0333, 0.041])
    base = jcfg.default_mpc_config()
    configs = [dataclasses.replace(base, dt=float(d)) for d in dts]
    if shared:
        # one config closed over: a trace-time constant, as in the rollouts
        jm, axes, tm, per_env = base, None, _port(tcfg.MpcConfig, base), {}
    else:
        jm, axes, tm, per_env = _stack(configs)
    return dts.astype(np.float32), jm, axes, tm, per_env


def _jax_clock(fn, jm, axes, *args):
    """``fn(m, *args)`` vmapped over the envs (the last axis of each
    argument row) with the config batched on ``axes`` or closed over."""
    if axes is None:
        return jax.jit(jax.vmap(lambda *a: fn(jm, *a)))(*args)
    return jax.jit(jax.vmap(fn, in_axes=(axes,) + (0,) * len(args)))(jm, *args)


@pytest.mark.parametrize("shared", [False, True], ids=["per_env_dt", "shared_dt"])
def test_gait_clock_per_env_dt_matches_jax(shared):
    """(b) 3,000 ticks of ``t + dt`` accumulated in f32 per env:
    ``phase_index`` and ``contact_sequence`` on every tick, and a
    contact-sensed clock fed the same random touchdowns, equal to JAX's."""
    n_ticks = 3000
    dts, jm, axes, tm, per_env = _clock_case(shared)
    gait = jcfg.GaitConfig(steps_per_phase=3)
    tg = _port(tcfg.GaitConfig, gait)
    T = np.zeros((n_ticks, dts.size), np.float32)
    for k in range(1, n_ticks):
        T[k] = T[k - 1] + dts
    k_t = tgait.phase_index(torch.from_numpy(T), tm, per_env).numpy()
    k_j = jax.vmap(lambda t: _jax_clock(lambda m, ti: jgait.phase_index(ti, m), jm, axes, t))(T)
    np.testing.assert_array_equal(k_t, np.asarray(k_j))
    # the two roundings of t / dt differ on these clocks: the test tells
    # the true division from the folded reciprocal
    inv = (np.float32(1.0) / dts).astype(np.float32)
    assert (np.floor(T / dts) != np.floor(T * inv)).any()
    c_t = tgait.contact_sequence(torch.from_numpy(T), tm, tg, per_env).numpy()
    c_j = jax.vmap(lambda t: _jax_clock(
        lambda m, ti: jgait.contact_sequence(ti, m, gait), jm, axes, t))(T)
    np.testing.assert_array_equal(c_t, np.asarray(c_j))

    rng = np.random.default_rng(3)
    down = rng.random((n_ticks, dts.size, 2)) < 0.8
    t_g = torch.from_numpy(-dts)
    hold = torch.zeros(dts.size, dtype=torch.int32)
    ts, holds = [], []
    for k in range(n_ticks):
        t_g, hold = tgait.advance_gait_clock(t_g, hold, torch.from_numpy(down[k]), tm, tg,
                                             per_env)
        ts.append(t_g.numpy())
        holds.append(hold.numpy())

    def step(carry, d):
        t_prev, h_prev = carry
        t_new, h_new = _jax_clock(
            lambda m, ti, hi, di: jgait.advance_gait_clock(ti, hi, di, m, gait),
            jm, axes, t_prev, h_prev, d)
        return (t_new, h_new), (t_new, h_new)

    _, (ts_j, holds_j) = jax.lax.scan(
        step, (jnp.asarray(-dts), jnp.zeros(dts.size, jnp.int32)), jnp.asarray(down))
    np.testing.assert_array_equal(np.stack(ts), np.asarray(ts_j))
    np.testing.assert_array_equal(np.stack(holds), np.asarray(holds_j))
    assert np.stack(holds).max() > 0  # the clock held somewhere


def test_solve_mpc_every_field_per_env_matches_jax():
    """(c) ``solve_mpc`` with all 22 fields per env (the references, the
    linearization, the condensed QP and the solver numerics)."""
    n = 8
    base, gait = jra.art_config_for_speed(0.3, **BENCH)
    jm, axes, tm, per_env = _stack(_per_env_configs(base, n, 4))
    assert set(per_env) == set(tcfg.MPC_PER_ENV_FIELDS)
    a = _mpc_inputs(n, 5)
    jb = jax.tree.map(lambda v: jnp.broadcast_to(v, (n,) + jnp.shape(v)), jbiped.BipedParams())

    def one(m, x, t, foot, cmd_ref, v_int, pitch_ref, b):
        c = jgait.contact_sequence(t, m, gait)
        sol = jmpc.solve_mpc(x, t, foot, m, b, c, gait=gait, cmd_ref=cmd_ref,
                             v_int=v_int, pitch_ref=pitch_ref)
        return c, sol

    keys = ("x", "t", "foot", "cmd_ref", "v_int", "pitch_ref")
    c_j, sol_j = jax.jit(jax.vmap(one, in_axes=(axes,) + (0,) * 7))(
        jm, *[a[k] for k in keys], jb)
    tg = _port(tcfg.GaitConfig, gait)
    t = {k: torch.from_numpy(a[k]) for k in keys}
    contact = tgait.contact_sequence(t["t"], tm, tg, per_env)
    np.testing.assert_array_equal(contact.numpy(), np.asarray(c_j))
    sol_t = tmpc.solve_mpc(t["x"], t["t"], t["foot"], tm, BipedParams().expand(n), contact,
                           gait=tg, cmd_ref=t["cmd_ref"], v_int=t["v_int"],
                           pitch_ref=t["pitch_ref"], per_env=per_env)
    _close_solution(sol_t, sol_j)


def test_control_tick_every_field_per_env_matches_jax():
    """(c) Two ``control_tick`` calls on the contact-sensed clock from a
    cold ``ControllerState.init``, all 22 fields per env: the second tick
    reads the first's per-env clock, pitch reference and warm start."""
    from biped_mpc_py_tpu.control import controller as jctrl
    from biped_mpc_py_torch.control import controller as tctrl

    n = 8
    base, _ = jra.art_config_for_speed(0.3, **BENCH)
    gait = jcfg.GaitConfig(steps_per_phase=3, contact_clock=True)
    jm, axes, tm, per_env = _stack(_per_env_configs(base, n, 9))
    a = _mpc_inputs(n, 10)
    rng = np.random.default_rng(11)
    q = (np.array([0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2)
         + 0.1 * rng.normal(size=(n, 10))).astype(np.float32)
    qd = rng.normal(size=(n, 10)).astype(np.float32)
    down = rng.random((n, 2)) < 0.7
    jb = jbiped.BipedParams(leg_jac=jbiped.HECTOR_LEG_JAC)

    def one(m, x, qi, qdi, t, d):
        s0 = jctrl.ControllerState.init(m)
        tau1, s1, _ = jctrl.control_tick(x, qi, qdi, t, m, gait, jb, s0, d)
        tau2, s2, sol = jctrl.control_tick(x, qi, qdi, t, m, gait, jb, s1, d)
        return tau1, tau2, s2, sol.controls

    tau1_j, tau2_j, s2_j, u_j = jax.jit(jax.vmap(one, in_axes=(axes,) + (0,) * 5))(
        jm, a["x"], q, qd, a["t"], down)
    tg = _port(tcfg.GaitConfig, gait)
    tb = BipedParams(leg_jac=HECTOR_LEG_JAC).expand(n)
    x, qt, qdt, t = (torch.from_numpy(v) for v in (a["x"], q, qd, a["t"]))
    d = torch.from_numpy(down)
    s0 = tctrl.ControllerState.init(tm, n, device="cpu", per_env=per_env)
    tau1, s1, _ = tctrl.control_tick(x, qt, qdt, t, tm, tg, tb, s0, d, per_env=per_env)
    tau2, s2, sol = tctrl.control_tick(x, qt, qdt, t, tm, tg, tb, s1, d, per_env=per_env)
    for name, port, ref, tol in (("tau1", tau1, tau1_j, TICK_BOUNDS["tau"]),
                                 ("tau2", tau2, tau2_j, TICK_BOUNDS["tau"]),
                                 ("u0", sol.controls, u_j, SOLVE_BOUNDS["controls"])):
        err = float(np.abs(port.numpy() - np.asarray(ref)).max())
        assert err <= tol, (name, err, tol)
    j2 = _fields(s2_j)
    np.testing.assert_array_equal(s2.t_gait.numpy(), j2["t_gait"])
    np.testing.assert_array_equal(s2.hold_count.numpy(), j2["hold_count"])
    for key in ("pitch_ref", "cmd_ref", "v_int"):
        err = float(np.abs(getattr(s2, key).numpy() - j2[key]).max())
        assert err <= TICK_BOUNDS["state"], (key, err)


def test_art_sweep_every_field_per_env_matches_jax():
    """(d) 3 configs x 2 ticks, all 22 fields differing, at the bench
    budget and physics, from perturbed worlds carried to JAX."""
    base, jg = jra.art_config_for_speed(0.3, **BENCH)
    jcfgs = [base] + _per_env_configs(base, 2, 6)
    jm, axes = jsweep.stack_configs(jcfgs)
    tm, per_env = config_batch_from_numpy(_fields(jm), dataclasses.asdict(axes))
    tm_s, per_env_s = tsweep.stack_configs([_port(tcfg.MpcConfig, c) for c in jcfgs],
                                           device="cpu")
    assert set(per_env) == set(per_env_s) == set(tcfg.MPC_PER_ENV_FIELDS)
    # the batched fields' config entries are JAX's f32 first rows, never read
    assert dataclasses.replace(tm, **{k: getattr(tm_s, k) for k in per_env}) == tm_s
    for k, v in per_env.items():
        assert torch.equal(v, per_env_s[k]), k
    tg = _port(tcfg.GaitConfig, jg)
    worlds = tsweep.perturbed_worlds(tm, 3, torch.Generator().manual_seed(1), device="cpu")
    tick = dict(n_substeps=5, minv_ll_hold=8)
    out = tsweep.art_sweep(worlds, BipedParams().expand(3), 2, tm, tg, per_env, **tick)
    assert np.isfinite(out.sim.q.numpy()).all()

    jw = jax.vmap(lambda _: jra.init_art_world(base))(jnp.arange(3))
    jw = dataclasses.replace(jw, sim=dataclasses.replace(
        jw.sim, q=jnp.asarray(worlds.sim.q.numpy())))
    out_j = jax.jit(jsweep.art_sweep_fn(2, jg, axes, model=jsweep.hector_model(), **tick))(
        jw, jbiped.BipedParams(), jm)
    j, t = _fields(out_j), to_numpy(out)
    for key, tol in CHAIN_BOUNDS.items():
        err = float(np.abs(t["sim"][key] - j["sim"][key]).max())
        assert err < tol, (key, err)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    assert len(set(t["sim"]["t"].tolist())) == 3  # each env on its own clock
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    for key in ("t_gait", "pitch_ref", "cmd_ref", "v_int"):
        np.testing.assert_allclose(t["ctrl"][key], j["ctrl"][key], atol=1e-4)


def test_empty_per_env_is_bit_equal():
    """(e) ``per_env={}`` changes nothing in ``solve_mpc``."""
    n = 4
    base, gait = jra.art_config_for_speed(0.3, **BENCH)
    tm, tg = _port(tcfg.MpcConfig, base), _port(tcfg.GaitConfig, gait)
    a = {k: torch.from_numpy(v) for k, v in _mpc_inputs(n, 7).items()}
    contact = tgait.contact_sequence(a["t"], tm, tg)
    args = (a["x"], a["t"], a["foot"], tm, BipedParams().expand(n), contact)
    kw = dict(gait=tg, cmd_ref=a["cmd_ref"], v_int=a["v_int"], pitch_ref=a["pitch_ref"])
    for u, v in zip(_leaves(tmpc.solve_mpc(*args, **kw)),
                    _leaves(tmpc.solve_mpc(*args, **kw, per_env={}))):
        assert torch.equal(u, v)


@pytest.mark.parametrize("budget", ["bench", "default"])
def test_plain_solve_per_env_equal_values_bit_equal(budget):
    """(e) (N,) tensors all equal to the scalar numerics: bit-equal to the
    scalar call of the plain version (the polish at the default budget
    included)."""
    n = 8
    base = jcfg.default_mpc_config(**(BENCH if budget == "bench" else {}))
    tm, tg = _port(tcfg.MpcConfig, base), _port(tcfg.GaitConfig, jcfg.GaitConfig())
    a = {k: torch.from_numpy(v) for k, v in _mpc_inputs(n, 8).items()}
    qp = tmpc.build_mpc_qp(a["x"], a["t"], a["foot"], tm, BipedParams().expand(n),
                           tgait.contact_sequence(a["t"], tm, tg), tg)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, tm.ruiz_iters, tm.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    kw = tqp.solver_args(tm)
    per_env = {k: torch.full((n,), kw[k]) for k in ("rho", "sigma", "alpha")}
    for u, v in zip(qp_kernel.fused_qp_solve_reference(*args, **kw),
                    qp_kernel.fused_qp_solve_reference(*args, **{**kw, **per_env})):
        assert torch.equal(u, v)
    # and through solve_qp, with the config's numerics handed per env
    named = {f"admm_{k}": v for k, v in per_env.items()}
    for u, v in zip(_leaves(tqp.solve_qp(qp, tm)),
                    _leaves(tqp.solve_qp(qp, tm, per_env=named))):
        assert torch.equal(u, v)


@pytest.mark.parametrize("fault", ["shape", "dtype", "device", "strided"])
def test_qp_wrapper_rejects_bad_per_env_numerics(fault):
    n = 4
    tm = tcfg.fast_mpc_config()
    P = torch.eye(120).expand(n, 120, 120).contiguous()
    Ah = torch.zeros(n, 10, 24, 12)
    q, l, u = torch.zeros(n, 120), -torch.ones(n, 10, 24), torch.ones(n, 10, 24)
    args = (P, Ah, q, l, u, torch.zeros(n, 120), torch.zeros(n, 10, 24),
            torch.zeros(n, 10, 24))
    bad = {"shape": torch.full((n + 1,), 0.3), "dtype": torch.full((n,), 0.3, dtype=torch.float64),
           "device": torch.full((n,), 0.3, device="meta"),
           "strided": torch.full((2 * n,), 0.3)[::2]}[fault]
    kw = {**tqp.solver_args(tm), "sigma": bad}
    with pytest.raises((ValueError, TypeError), match="sigma"):
        qp_kernel.fused_qp_solve(*args, **kw)


def test_physics_kernels_refuse_a_per_env_dt():
    """The substep kernel takes one ``dt`` per launch and the tick kernel
    one config: a per-env ``dt`` raises before it reaches a device, and is
    never read as env 0's."""
    from biped_mpc_py_torch.ops.cuda import tick_kernel
    from biped_mpc_py_torch.parallel import rollout_art as tra

    mpc, gait = tra.art_config_for_speed(0.3, **BENCH)
    model = hector_model(device="cpu")
    w = tra.init_art_world(mpc, 2, device="cpu")
    Minv = mass_matrix_inv(model, w.sim.q)
    with pytest.raises(ValueError, match="one dt"):
        substep_kernel.fused_substeps(model, w.sim, torch.zeros(2, 10), Minv,
                                      torch.tensor([0.005, 0.006]), 5)
    _, per_env = tsweep.stack_configs([mpc, dataclasses.replace(mpc, dt=0.035)], device="cpu")
    z2, z = torch.zeros(2, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="per-env"):
        tick_kernel.fused_tick(model, BipedParams(), mpc, gait, w.sim, torch.zeros(2, 12), z2,
                               z, z, z2, Minv, per_env=per_env)


@pytest.mark.parametrize("fault", ["static", "axis", "length"])
def test_config_batch_from_numpy_raises_where_axes_disagree(fault):
    base = jra.art_mpc_config()
    jm, axes = jsweep.stack_configs([base, dataclasses.replace(base, kv=0.02, dt=0.035)])
    fields, ax = _fields(jm), dataclasses.asdict(axes)
    if fault == "static":
        fields["n_admm_iters"] = np.array([60, 40])
    elif fault == "axis":
        ax["kv"] = 1
    else:
        fields["kv"] = np.array([0.01, 0.02, 0.03], np.float32)
    with pytest.raises(ValueError):
        config_batch_from_numpy(fields, ax)

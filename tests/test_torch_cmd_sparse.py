"""The torch port against the JAX package: per-env commands on the SRB path
(``batched_cmd_rollout`` and the optional ``x_cmd`` tensor of the functions
that read ``mpc.x_cmd``), the reference script's sparse QP form
(``sparse_qp_matrices``), and three small functions (``cost_of_transport``,
``advance_gait_clock_host``, ``xform_identity``).

The JAX package swaps ``mpc.x_cmd`` for a traced per-env array
(``dataclasses.replace(mpc, x_cmd=x)`` under vmap); the port hands the
per-env commands beside the unchanged config. Inputs are made with numpy
from a seed.

Tolerances:
- functions with a per-env command: 1e-5 absolute (f32 roundoff of the same
  closed forms); with ``x_cmd=None`` bit-equal to a call without the
  argument, and with the config's own command as a tensor within 1e-6;
- ``batched_cmd_rollout``, 4 envs x 20 ticks: x_fb and feet 2e-3, the clock
  and the fall counts equal (``tests/test_torch_rollout.py``'s bounds);
- the sparse matrices: 1e-5 relative to each matrix's largest entry; the
  sparse form's optimum against the condensed form's, both by the f64
  oracle ``tests/oracle_qp.py``: controls 2e-3 N (the bound of
  ``tests/test_qp.py::test_condensation_equivalent_to_reference_qp``) plus
  1e-4 of the entry (both QPs are assembled in f32; measured 2.7e-3 on a
  53 N force), states 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control import controller as jctrl
from biped_mpc_py_tpu.control import gait as jgait
from biped_mpc_py_tpu.control import reference as jref
from biped_mpc_py_tpu.control import swing as jswing
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.models.srb import linearize_horizon as j_linearize
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.parallel import rollout as jroll
from biped_mpc_py_tpu.sim import spatial as jspatial
from biped_mpc_py_tpu.utils import metrics as jmetrics
from biped_mpc_py_tpu.utils.precision import f32_precision
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import controller as tctrl
from biped_mpc_py_torch.control import gait as tgait
from biped_mpc_py_torch.control import mpc as tmpc
from biped_mpc_py_torch.control import reference as tref
from biped_mpc_py_torch.control import swing as tswing
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.models.srb import linearize_horizon as t_linearize
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.sim import spatial as tspatial
from biped_mpc_py_torch.utils import metrics as tmetrics
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from tests.oracle_qp import solve_qp_ipm
from torch_threads import one_torch_thread  # noqa: F401

N = 6
ATOL = 1e-5


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _commands(n, seed, turn=False):
    """Per-env commands (n,12): height 0.5-0.6 m, forward 0-0.4 m/s, some
    envs with a lateral command, one at rest; with ``turn`` a yaw rate too
    (one env below the small-rate limit)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 12), np.float32)
    x[:, 5] = rng.uniform(0.5, 0.6, n)
    x[:, 9] = rng.uniform(0.0, 0.4, n)
    x[::2, 10] = rng.uniform(-0.1, 0.1, (n + 1) // 2)
    x[0, 9:11] = 0.0
    x[:, 3:5] = rng.normal(size=(n, 2)) * 0.1
    x[:, 1] = rng.normal(size=n) * 0.02
    if turn:
        x[:, 8] = rng.uniform(-0.5, 0.5, n)
        x[1, 8] = 1e-8
    return x


def _feedback(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 12)) * 0.05).astype(np.float32)
    x[:, 3:5] += rng.normal(size=(n, 2)).astype(np.float32)
    x[:, 5] += 0.53
    x[:, 9] += 0.2
    foot = np.tile(np.array([-0.02, 0.09, 0, -0.02, -0.09, 0], np.float32), (n, 1))
    foot += (rng.normal(size=(n, 6)) * 0.05).astype(np.float32)
    return x, foot, {
        "cmd_ref": (rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
        "v_int": (rng.normal(size=(n, 2)) * 0.1).astype(np.float32),
        "pitch_ref": (rng.normal(size=(n,)) * 0.05).astype(np.float32),
    }


CASES = {
    "world_frame": {"raibert_capture_gain": 0.5, "cmd_v_int_gain": 0.1, "raibert_vint": 0.2},
    "body_frame_turn": {"cmd_body_frame": True, "raibert_capture_gain": 1.0,
                        "capture_sched": 0.5},
    "reference_compat": {"compat": True},
    "pitch_leak": {"pitch_ref_leak": 0.05},
}


def _configs(name):
    over = dict(CASES[name])
    make = jcfg.reference_compat_config if over.pop("compat", False) else jcfg.default_mpc_config
    jm = make(**over)
    return jm, from_numpy(tcfg.MpcConfig, _fields(jm))


def _close(t_val, j_val, atol=ATOL):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functions_with_per_env_command_match_jax(name):
    """com_reference, foot_reference, swing_target_xy, advance_cmd_ref,
    advance_v_int and ControllerState.init with a command per env against
    the JAX functions under vmap with ``mpc.x_cmd`` replaced per env."""
    jm, tm = _configs(name)
    jg, tg = jcfg.GaitConfig(steps_per_phase=3), tcfg.GaitConfig(steps_per_phase=3)
    xc = _commands(N, 1, turn=name == "body_frame_turn")
    x, foot, ex = _feedback(N, 2)
    t = (np.arange(N) * np.float32(0.04)).astype(np.float32)
    T = {k: torch.from_numpy(v) for k, v in ex.items()}
    tx, txc, tt = torch.from_numpy(x), torch.from_numpy(xc), torch.from_numpy(t)

    def per_env(fn):
        return jax.jit(jax.vmap(lambda c, *a: fn(dataclasses.replace(jm, x_cmd=c), *a)))

    xr_j = per_env(lambda m, x, r, vi, pr: jref.com_reference(
        x, m, r, z_ground=0.01, v_int=vi, pitch_ref=pr))(
            xc, x, ex["cmd_ref"], ex["v_int"], ex["pitch_ref"])
    xr_t = tref.com_reference(tx, tm, T["cmd_ref"], z_ground=0.01, v_int=T["v_int"],
                              pitch_ref=T["pitch_ref"], x_cmd=txc)
    _close(xr_t, xr_j)

    fr_j = per_env(lambda m, x, t, f, vi: jref.foot_reference(
        x, t, f, m, jgait.contact_sequence(t, m, jg), jg, v_int=vi))(xc, x, t, foot, ex["v_int"])
    fr_t = tref.foot_reference(tx, tt, torch.from_numpy(foot), tm,
                               tgait.contact_sequence(tt, tm, tg), tg, v_int=T["v_int"],
                               x_cmd=txc)
    _close(fr_t, fr_j)

    for side in (1.0, -1.0):
        fx_j, fy_j = per_env(lambda m, x, vi: jswing.swing_target_xy(x, m, side, jg, vi))(
            xc, x, ex["v_int"])
        fx_t, fy_t = tswing.swing_target_xy(tx, tm, side, tg, T["v_int"], x_cmd=txc)
        _close(fx_t, fx_j)
        _close(fy_t, fy_j)

    _close(tctrl.advance_cmd_ref(T["cmd_ref"], tx, tm, txc),
           per_env(lambda m, r, x: jctrl.advance_cmd_ref(r, x, m))(xc, ex["cmd_ref"], x))
    _close(tctrl.advance_v_int(T["v_int"], tx, tm, txc),
           per_env(lambda m, v, x: jctrl.advance_v_int(v, x, m))(xc, ex["v_int"], x))
    init_j = per_env(lambda m: jctrl.ControllerState.init(m))(xc)
    init_t = tctrl.ControllerState.init(tm, N, x_cmd=txc)
    _close(init_t.pitch_ref, init_j.pitch_ref, 0.0)
    _close(init_t.t_gait, init_j.t_gait, 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_command_override_reduces_to_config(name):
    """``x_cmd=None`` is bit-equal to a call without the argument, and the
    config's own command handed over as a (12,) or (N,12) tensor gives the
    same values to roundoff."""
    _, tm = _configs(name)
    tm = dataclasses.replace(tm, x_cmd=tuple(_commands(3, 3, turn=True)[2]))
    tg = tcfg.GaitConfig(steps_per_phase=3)
    x, foot, ex = _feedback(N, 4)
    T = {k: torch.from_numpy(v) for k, v in ex.items()}
    tx, tf = torch.from_numpy(x), torch.from_numpy(foot)
    tt = torch.arange(N, dtype=torch.float32) * 0.04
    c = tgait.contact_sequence(tt, tm, tg)
    cmd = torch.tensor(tm.x_cmd)

    calls = {
        "com_reference": lambda **k: tref.com_reference(
            tx, tm, T["cmd_ref"], v_int=T["v_int"], pitch_ref=T["pitch_ref"], **k),
        "foot_reference": lambda **k: tref.foot_reference(
            tx, tt, tf, tm, c, tg, v_int=T["v_int"], **k),
        "swing_target_x": lambda **k: tswing.swing_target_xy(tx, tm, 1.0, tg, T["v_int"], **k)[0],
        "swing_target_y": lambda **k: tswing.swing_target_xy(tx, tm, -1.0, tg, T["v_int"], **k)[1],
        "advance_cmd_ref": lambda **k: tctrl.advance_cmd_ref(T["cmd_ref"], tx, tm, **k),
        "advance_v_int": lambda **k: tctrl.advance_v_int(T["v_int"], tx, tm, **k),
        "init.pitch_ref": lambda **k: tctrl.ControllerState.init(tm, N, **k).pitch_ref,
        "build_mpc_qp.q": lambda **k: tmpc.build_mpc_qp(
            tx, tt, tf, tm, BipedParams().expand(N), c, tg, T["cmd_ref"], v_int=T["v_int"],
            **k).q,
    }
    for label, call in calls.items():
        base = call()
        assert torch.equal(call(x_cmd=None), base), label
        scale = max(1.0, float(base.abs().max()))
        for form in (cmd, cmd.expand(N, 12)):
            got = call(x_cmd=form)
            assert got.shape == base.shape, label
            assert float((got - base).abs().max()) <= 2e-6 * scale, label


def test_metrics_update_with_per_env_command():
    rng = np.random.default_rng(5)
    xc = _commands(N, 6)
    x, _, _ = _feedback(N, 7)
    u0 = (rng.normal(size=(N, 12)) * 30).astype(np.float32)
    res = rng.random(N).astype(np.float32)
    fell = (rng.random(N) < 0.3).astype(np.float32)
    m_j = jax.vmap(lambda x, c, u, r, f: jmetrics.RolloutMetrics.zeros().update(
        x, c, u, r, f, energy=0.5))(x, xc, u0, res, fell)
    m_t = tmetrics.RolloutMetrics.zeros(N).update(
        torch.from_numpy(x), torch.from_numpy(xc), torch.from_numpy(u0), torch.from_numpy(res),
        torch.from_numpy(fell), energy=0.5)
    j, t = _fields(m_j), to_numpy(m_t)
    for key in j:
        np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-7, err_msg=key)
    # a config's tuple and the same command as a tensor agree
    tup = tuple(float(v) for v in xc[0])
    a = tmetrics.RolloutMetrics.zeros(N).update(
        torch.from_numpy(x), tup, torch.from_numpy(u0), torch.from_numpy(res),
        torch.from_numpy(fell))
    b = tmetrics.RolloutMetrics.zeros(N).update(
        torch.from_numpy(x), torch.from_numpy(xc[0]), torch.from_numpy(u0),
        torch.from_numpy(res), torch.from_numpy(fell))
    for f in dataclasses.fields(a):
        assert torch.allclose(getattr(a, f.name), getattr(b, f.name), rtol=1e-6, atol=1e-7)


def _matched(jm):
    """The JAX config at the port's precision (bf16 knobs off)."""
    return dataclasses.replace(
        jm, kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False)


def _cmd_start(n, seed):
    jm = _matched(jcfg.fast_mpc_config())
    rng = np.random.default_rng(seed)
    jw = jroll.batch_worlds(jm, n)
    x0 = np.array(jw.sim.x_fb) + (rng.normal(size=(n, 12)) * 0.01).astype(np.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, x_fb=jnp.asarray(x0)))
    jb = jroll.randomize_params(jax.random.PRNGKey(seed), n)
    xc = np.zeros((n, 12), np.float32)
    xc[:, 5] = 0.55
    xc[:, 9] = np.linspace(0.0, 0.4, n)
    xc[1, 10] = 0.1
    return jm, jw, jb, xc


def test_cmd_rollout_matches_jax():
    """4 envs x 20 ticks, each env at its own speed, against
    ``batched_cmd_rollout_fn`` from the same perturbed worlds and
    randomized robots."""
    n, ticks = 4, 20
    jm, jw, jb, xc = _cmd_start(n, 0)
    jg = jcfg.GaitConfig()
    out_j = jax.jit(f32_precision(jroll.batched_cmd_rollout_fn(ticks, jm, jg)))(
        jw, jb, jnp.asarray(xc))
    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    tw, tb = from_numpy(troll.World, _fields(jw)), from_numpy(BipedParams, _fields(jb))
    out_t = troll.batched_cmd_rollout(tw, tb, torch.from_numpy(xc), ticks, tm, tcfg.GaitConfig())
    j, t = _fields(out_j), to_numpy(out_t)
    np.testing.assert_allclose(t["sim"]["x_fb"], j["sim"]["x_fb"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(t["sim"]["foot"], j["sim"]["foot"], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_allclose(t["metrics"]["vel_err_sq"], j["metrics"]["vel_err_sq"],
                               rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(t["metrics"]["height_err_sq"], j["metrics"]["height_err_sq"],
                               rtol=1e-2, atol=1e-5)
    # the envs went at their own speeds
    x = t["sim"]["x_fb"][:, 3]
    assert np.all(np.diff(x) > 0.02), x


def test_cmd_rollout_against_plain_rollout():
    """Every env commanded as the config commands: the per-env rollout
    repeats ``batched_rollout`` to roundoff; ``batched_rollout`` itself is
    unchanged by the new argument (x_cmd=None inside)."""
    n, ticks = 3, 10
    x_cmd = (0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0)
    mpc, gait = tcfg.fast_mpc_config(x_cmd=x_cmd), tcfg.GaitConfig()
    w = troll.batch_worlds(mpc, n, device="cpu")
    b = troll.randomize_params(torch.Generator().manual_seed(1), n, device="cpu")
    plain = troll.batched_rollout(w, b, ticks, mpc, gait)
    cmd = troll.batched_cmd_rollout(w, b, torch.tensor(x_cmd).expand(n, 12), ticks, mpc, gait)
    assert float((cmd.sim.x_fb - plain.sim.x_fb).abs().max()) < 1e-4
    assert torch.equal(cmd.metrics.falls, plain.metrics.falls)
    tick = w
    for _ in range(ticks):
        tick = troll.batched_closed_loop_tick(tick, mpc, gait, b, x_cmd=None)
    assert torch.equal(tick.sim.x_fb, plain.sim.x_fb)
    with pytest.raises(ValueError, match="x_cmd"):
        troll.batched_cmd_rollout(w, b, torch.zeros(n + 1, 12), 1, mpc, gait)


def _horizon(name, n, seed):
    """The horizon linearization of ``n`` perturbed envs in both packages:
    (jm, tm, JAX inputs, port inputs) for ``sparse_qp_matrices``."""
    jm, tm = _configs(name)
    jg, tg = jcfg.GaitConfig(), tcfg.GaitConfig()
    x, foot, _ = _feedback(n, seed)
    x[:, 3:5] *= 0.1
    x[:, 9] -= 0.2
    t = (np.arange(n) * np.float32(0.04) * 3).astype(np.float32)
    jb = jroll.randomize_params(jax.random.PRNGKey(seed), n)
    tb = from_numpy(BipedParams, _fields(jb))

    def jone(x, t, f, b):
        c = jgait.contact_sequence(t, jm, jg)
        x_ref = jref.com_reference(x, jm)
        A, B = j_linearize(jm, b, x_ref, jref.foot_reference(x, t, f, jm, c, jg))
        return x_ref, A, B, c

    xr_j, A_j, B_j, c_j = jax.jit(jax.vmap(jone))(x, t, foot, jb)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    c_t = tgait.contact_sequence(tt, tm, tg)
    xr_t = tref.com_reference(tx, tm)
    A_t, B_t = t_linearize(tm, tb, xr_t, tref.foot_reference(tx, tt, torch.from_numpy(foot), tm,
                                                              c_t, tg))
    return (jm, tm, (jb, jnp.asarray(x), xr_j, A_j, B_j, c_j), (tb, tx, xr_t, A_t, B_t, c_t),
            (tt, torch.from_numpy(foot), tg))


NAMES = ("H", "f", "Aeq", "beq", "G", "h_vec")


@pytest.mark.parametrize("name", ["world_frame", "reference_compat"])
def test_sparse_qp_matrices_match_jax(name):
    n, h = 4, 10
    jm, tm, j_in, t_in, _ = _horizon(name, n, 8)
    out_j = jax.jit(jax.vmap(lambda b, x, xr, A, B, c: jqp.sparse_qp_matrices(
        jm, b, x, xr, A, B, c)))(*j_in)
    out_t = tqp.sparse_qp_matrices(tm, *t_in)
    shapes = {"H": (25 * h, 25 * h), "f": (25 * h,), "Aeq": (13 * h, 25 * h), "beq": (13 * h,),
              "G": (36 * h, 25 * h), "h_vec": (36 * h,)}
    for label, a, b in zip(NAMES, out_t, out_j):
        b = np.asarray(b)
        assert a.shape == (n,) + shapes[label], label
        tol = 1e-5 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0, err_msg=label)


def _expand_condensed(qp, env):
    """CondensedQp rows of one env -> stacked one-sided (G, h) for the
    oracle, free bounds dropped (tests/test_qp.py)."""
    A_step = qp.A_step[env].double().numpy()
    l, u = qp.l[env].double().numpy(), qp.u[env].double().numpy()
    h_, m = l.shape
    G_rows, h_rows = [], []
    for k in range(h_):
        blk = np.zeros((m, 12 * h_))
        blk[:, 12 * k: 12 * (k + 1)] = A_step
        upper, lower = u[k] < 1e19, l[k] > -1e19
        G_rows += [blk[upper], -blk[lower]]
        h_rows += [u[k][upper], -l[k][lower]]
    return np.vstack(G_rows), np.concatenate(h_rows)


@pytest.mark.parametrize("env", [0, 1])
def test_sparse_optimum_equals_condensed_optimum(env):
    """The 250-variable sparse QP and the 120-variable condensed QP of the
    same tick have the same optimum (the f64 oracle solves both)."""
    h = 10
    _, tm, _, t_in, (tt, foot, tg) = _horizon("world_frame", 2, 9)
    tb, tx, xr_t, A_t, B_t, c_t = t_in
    H, f, Aeq, beq, G, h_vec = (m[env].double().numpy()
                                for m in tqp.sparse_qp_matrices(tm, *t_in))
    z, info = solve_qp_ipm(H, f, G=G, h=h_vec, A=Aeq, b=beq)
    assert info["status"] == "optimal"
    states_s, controls_s = z[:13 * h].reshape(h, 13), z[13 * h:].reshape(h, 12)

    qp = tmpc.build_mpc_qp(tx, tt, foot, tm, tb, c_t, tg)
    Gc, hc = _expand_condensed(qp, env)
    U, info = solve_qp_ipm(qp.P[env].double().numpy(), qp.q[env].double().numpy(), G=Gc, h=hc)
    assert info["status"] == "optimal"
    np.testing.assert_allclose(U.reshape(h, 12), controls_s, atol=2e-3, rtol=1e-4)
    states_c = (np.einsum("kij,j->ki", qp.Sx[env].double().numpy(), qp.x0[env].double().numpy())
                + qp.Su[env].double().numpy() @ U)
    np.testing.assert_allclose(states_c, states_s, atol=1e-4)
    assert controls_s[0, [2, 5]].max() > 10.0  # a stance foot carries load


def test_cost_of_transport():
    e = np.array([10.0, 0.0, 3.0], np.float32)
    d = np.array([2.0, -1.5, 0.0], np.float32)
    want = np.asarray(jmetrics.cost_of_transport(jnp.asarray(e), 12.0, jnp.asarray(d)))
    got = tmetrics.cost_of_transport(torch.from_numpy(e), 12.0, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert tmetrics.cost_of_transport(10.0, 12.0, -2.0) == pytest.approx(10.0 / (12 * 9.81 * 2))
    assert tmetrics.cost_of_transport(1.0, 1.0, 0.0, g=1.0) == pytest.approx(1e9)


@pytest.mark.parametrize("flight", [0, 1])
def test_advance_gait_clock_host(flight):
    """The host clock against the JAX host clock (equal floats) and against
    the port's tensor clock, through holds and releases."""
    jm, tm = jcfg.MpcConfig(), tcfg.MpcConfig()
    kw = dict(steps_per_phase=2, flight_steps=flight, contact_clock=True, clock_max_hold=2)
    jg, tg = jcfg.GaitConfig(**kw), tcfg.GaitConfig(**kw)
    rng = np.random.default_rng(10 + flight)
    t_j = t_t = -tm.dt
    h_j = h_t = 0
    t_dev, h_dev = torch.tensor([-tm.dt]), torch.zeros(1, dtype=torch.int32)
    held = 0
    for _ in range(60):
        down = [bool(v) for v in rng.random(2) < 0.5]
        t_j, h_j = jgait.advance_gait_clock_host(t_j, h_j, down, jm, jg)
        t_t, h_t = tgait.advance_gait_clock_host(t_t, h_t, down, tm, tg)
        assert (t_t, h_t) == (t_j, h_j)
        t_dev, h_dev = tgait.advance_gait_clock(t_dev, h_dev, torch.tensor([down]), tm, tg)
        assert float(t_dev[0]) == pytest.approx(t_t, abs=1e-6) and int(h_dev[0]) == h_t
        held += h_t > 0
    assert 0 < held < 60
    standing = tcfg.GaitConfig(gait_mode=0, contact_clock=True)
    assert tgait.advance_gait_clock_host(-tm.dt, 0, (False, False), tm, standing)[1] == 0


def test_xform_identity():
    X, JX = tspatial.xform_identity(), jspatial.xform_identity()
    np.testing.assert_array_equal(X.R.numpy(), np.asarray(JX.R))
    np.testing.assert_array_equal(X.p.numpy(), np.asarray(JX.p))
    assert X.R.dtype == torch.float32 and tspatial.xform_identity(torch.float64).p.dtype == torch.float64
    v = torch.arange(6, dtype=torch.float32)
    assert torch.equal(tspatial.xform_motion(X, v), v) and torch.equal(tspatial.xform_force(X, v), v)
    Y = tspatial.SpatialTransform(torch.tensor([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]]),
                                  torch.tensor([0.1, 0.2, 0.3]))
    for Z in (tspatial.xform_compose(X, Y), tspatial.xform_compose(Y, X)):
        assert torch.equal(Z.R, Y.R) and torch.equal(Z.p, Y.p)

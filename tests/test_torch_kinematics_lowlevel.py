"""The torch port's leg kinematics, swing force, low-level control, contact
clock and control tick against the JAX package, and the control tick
against the frozen golden tick (``tests/golden/tick_t0_walking.npz``), the
first check of the port against the reference itself.

Inputs come from numpy with a seed. Tolerances:
- kinematics and Jacobians, both leg presets: 1e-5 absolute (f32
  roundoff; the port's Jacobian is the closed form of the JAX jacfwd);
- swing force [N] and joint torques [N m]: 1e-3 absolute at gains of
  hundreds (kp_swing 500 times ~1e-6 m roundoff);
- contact clock: flags, held times and hold counts equal, tick by tick;
- the golden tick: controls 0.05, states 1e-3, tau 0.02, the tolerances of
  ``tests/test_golden_standalone.py:40-42``; the JAX ``control_tick`` at
  the same tolerances.
"""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control import controller as jctl
from biped_mpc_py_tpu.control import gait as jgait
from biped_mpc_py_tpu.control import lowlevel as jll
from biped_mpc_py_tpu.control import swing as jswing
from biped_mpc_py_tpu.models import biped as jbiped
from biped_mpc_py_tpu.models import kinematics as jkin
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import controller as tctl
from biped_mpc_py_torch.control import gait as tgait
from biped_mpc_py_torch.control import lowlevel as tll
from biped_mpc_py_torch.control import swing as tswing
from biped_mpc_py_torch.models import biped as tbiped
from biped_mpc_py_torch.models import kinematics as tkin
from biped_mpc_py_torch.utils.convert import from_numpy
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tick_t0_walking.npz")
PRESETS = {"fk": (jbiped.HECTOR_LEG_FK, tbiped.HECTOR_LEG_FK),
           "jac": (jbiped.HECTOR_LEG_JAC, tbiped.HECTOR_LEG_JAC)}


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _port(cls, obj):
    return from_numpy(cls, _fields(obj))


def _close(port, ref, atol, name=""):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= atol, (name, err, atol)


def _batch(tree, n):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), tree)


def _states(n, seed):
    """(x_fb (N,12), q (N,10), qd (N,10)) near a walking stance."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 12))
    x[:, 5] = 0.55
    x += rng.normal(size=(n, 12)) * [0.05, 0.05, 0.3, 0.1, 0.1, 0.02, 0.3, 0.3, 0.3, 0.3, 0.3, 0.1]
    q0 = np.array([0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2)
    q = q0 + 0.2 * rng.normal(size=(n, 10))
    qd = rng.normal(size=(n, 10))
    return tuple(a.astype(np.float32) for a in (x, q, qd))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_leg_kinematics(preset):
    jgeom, tgeom = PRESETS[preset]
    _, q, qd = _states(64, 0)
    for leg, side in enumerate((1.0, -1.0)):
        q5 = q[:, 5 * leg:5 * leg + 5]
        tq5 = torch.tensor(q5)
        fk_j = jax.vmap(lambda a: jkin.leg_fk_body(a, side, jgeom))(q5)
        _close(tkin.leg_fk_body(tq5, side, tgeom), fk_j, 1e-5, "leg_fk_body")
        jm_j, jf_j = jax.vmap(lambda a: jkin.leg_jacobians(a, side, jgeom))(q5)
        jm_t, jf_t = tkin.leg_jacobians(tq5, side, tgeom)
        _close(jm_t, jm_j, 1e-5, "Jm")
        _close(jf_t, jf_j, 1e-5, "Jf")
        _close(tkin.leg_joint_axes(tq5), jax.vmap(jkin.leg_joint_axes)(q5), 1e-6, "axes")
    x, _, _ = _states(64, 1)
    jb = jbiped.BipedParams(leg=jgeom, leg_jac=jgeom)
    tb = _port(tbiped.BipedParams, _batch(jb, 64))
    _close(tkin.foot_positions_world(torch.tensor(x), torch.tensor(q), tb),
           jax.vmap(lambda a, b: jkin.foot_positions_world(a, b, jb))(x, q), 1e-5, "feet")
    _close(tkin.foot_velocities_world(torch.tensor(x), torch.tensor(q), torch.tensor(qd), tb),
           jax.vmap(lambda a, b, c: jkin.foot_velocities_world(a, b, c, jb))(x, q, qd),
           1e-5, "foot velocities")


def _configs():
    run_m, run_g = jra.art_config_for_run(1.0, stabilized=True)
    return {
        "art": (jra.art_mpc_config(x_cmd=jnp.zeros(12).at[5].set(0.55).at[9].set(0.3)),
                jcfg.GaitConfig(steps_per_phase=3)),
        "art_knobs": (jra.art_mpc_config(swing_retract=0.02, swing_track_ff=0.5,
                                         swing_td_overdrive=0.1, cmd_v_int_gain=0.1,
                                         raibert_vint=0.2), jcfg.GaitConfig()),
        "run": (run_m, run_g),
        "turn_body_frame": jra.art_config_for_turn(0.3),
        "compat": (jcfg.reference_compat_config(), jcfg.GaitConfig()),
    }


@pytest.mark.parametrize("name", sorted(_configs()))
def test_swing_leg_force(name):
    jm, jg = _configs()[name]
    tm, tg = _port(tcfg.MpcConfig, jm), _port(tcfg.GaitConfig, jg)
    n = 64
    x, _, _ = _states(n, 2)
    rng = np.random.default_rng(3)
    t = (rng.uniform(0, 2.0, size=n)).astype(np.float32)
    pf = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    vf = rng.normal(size=(n, 3)).astype(np.float32)
    v_int = (rng.normal(size=(n, 2)) * 0.1).astype(np.float32)
    for side in (1.0, -1.0):
        f_j = jax.vmap(lambda a, b, c, d, e: jswing.swing_leg_force(
            a, b, c, d, jm, side, jg, v_int=e))(x, t, pf, vf, v_int)
        f_t = tswing.swing_leg_force(
            torch.tensor(x), torch.tensor(t), torch.tensor(pf), torch.tensor(vf), tm,
            side, tg, v_int=torch.tensor(v_int))
        _close(f_t, f_j, 1e-3, f"swing force side {side}")


@pytest.mark.parametrize("name", sorted(_configs()))
@pytest.mark.parametrize("frame_bug", [False, True])
def test_low_level_control(name, frame_bug):
    jm, jg = _configs()[name]
    jm = dataclasses.replace(jm, compat_swing_frame_bug=frame_bug, flight_yaw_kd=0.5,
                             kp_pivot=3.0, kd_pivot=0.2, hipyaw_rate_lead=0.1)
    tm, tg = _port(tcfg.MpcConfig, jm), _port(tcfg.GaitConfig, jg)
    n = 64
    x, q, qd = _states(n, 4)
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 2.0, size=n).astype(np.float32)
    pf = (rng.normal(size=(n, 6)) * 0.1).astype(np.float32)
    contact = rng.integers(0, 2, size=(n, jm.h, 2)).astype(np.float32)  # incl. flight
    u0 = (rng.normal(size=(n, 12)) * 30).astype(np.float32)
    cmd_ref = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    v_int = (rng.normal(size=(n, 2)) * 0.1).astype(np.float32)
    jb = jbiped.BipedParams(leg_jac=jbiped.HECTOR_LEG_JAC)
    tb = _port(tbiped.BipedParams, _batch(jb, n))
    tau_j = jax.vmap(lambda *a: jll.low_level_control(
        a[0], a[1], a[2], a[3], a[4], jm, jb, a[5], a[6], gait=jg, cmd_ref=a[7],
        v_int=a[8]))(x, t, pf, q, qd, contact, u0, cmd_ref, v_int)
    args = [torch.tensor(a) for a in (x, t, pf, q, qd)]
    tau_t = tll.low_level_control(
        *args, tm, tb, torch.tensor(contact), torch.tensor(u0), gait=tg,
        cmd_ref=torch.tensor(cmd_ref), v_int=torch.tensor(v_int))
    _close(tau_t, tau_j, 1e-3, "tau")


@pytest.mark.parametrize("gait", ["walk", "run", "stand"])
def test_contact_clock(gait):
    """measured_contact and advance_gait_clock over 60 ticks of random
    touchdown reports: the same held times and hold counts as JAX."""
    jg = {"walk": jcfg.GaitConfig(steps_per_phase=3, contact_clock=True),
          "run": jcfg.GaitConfig(steps_per_phase=2, flight_steps=1, contact_clock=True),
          "stand": jcfg.GaitConfig(gait_mode=0, contact_clock=True)}[gait]
    jm = jcfg.MpcConfig()
    tm, tg = _port(tcfg.MpcConfig, jm), _port(tcfg.GaitConfig, jg)
    n, rng = 16, np.random.default_rng(6)
    t_j = np.full(n, -jm.dt, np.float32)
    hold_j = np.zeros(n, np.int32)
    t_t, hold_t = torch.tensor(t_j), torch.tensor(hold_j)
    step = jax.jit(jax.vmap(lambda t, h, d: jgait.advance_gait_clock(t, h, d, jm, jg)))
    for _ in range(60):
        pf = (rng.normal(size=(n, 6)) * 0.01 + 0.006).astype(np.float32)
        down_j = jax.vmap(lambda p: jgait.measured_contact(p, None, jg))(pf)
        down_t = tgait.measured_contact(torch.tensor(pf), None, tg)
        np.testing.assert_array_equal(down_t.numpy(), np.asarray(down_j))
        t_j, hold_j = step(t_j, hold_j, down_j)
        t_t, hold_t = tgait.advance_gait_clock(t_t, hold_t, down_t, tm, tg)
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        np.testing.assert_array_equal(hold_t.numpy(), np.asarray(hold_j))
    if gait != "stand":
        assert int(np.asarray(hold_j).max()) > 0  # the hold was exercised


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="golden file missing")
def test_control_tick_matches_golden_and_jax():
    g = np.load(GOLDEN)
    x, q, qd = (np.asarray(g[k], np.float32)[None] for k in ("x_fb", "q", "qd"))
    tau_t, state_t, sol_t = tctl.control_tick(
        torch.tensor(x), torch.tensor(q), torch.tensor(qd), 0.0,
        tcfg.reference_compat_config(), tcfg.GaitConfig(),
        tbiped.BipedParams(leg=tbiped.HECTOR_LEG_FK, leg_jac=tbiped.HECTOR_LEG_JAC),
    )
    _close(sol_t.controls[0], g["controls"], 0.05, "golden controls")
    _close(sol_t.states[0], g["states"], 1e-3, "golden states")
    _close(tau_t[0], g["tau"], 0.02, "golden tau")
    jb = jbiped.BipedParams(leg=jbiped.HECTOR_LEG_FK, leg_jac=jbiped.HECTOR_LEG_JAC)
    tau_j, state_j, sol_j = jax.jit(lambda a, b, c: jctl.control_tick(
        a, b, c, 0.0, jcfg.reference_compat_config(), jcfg.GaitConfig(), jb))(x[0], q[0], qd[0])
    _close(sol_t.controls[0], sol_j.controls, 0.05, "JAX controls")
    _close(sol_t.states[0], sol_j.states, 1e-3, "JAX states")
    _close(tau_t[0], tau_j, 0.02, "JAX tau")
    _close(state_t.cmd_ref[0], state_j.cmd_ref, 1e-6, "cmd_ref")
    assert float(state_t.t_gait[0]) == 0.0 and int(state_t.hold_count[0]) == 0


def test_control_tick_warm_contact_clock():
    """A second, warm-started tick on the contact-sensed clock, batched over
    4 envs, against JAX at the golden tolerances."""
    jm = jra.art_mpc_config(x_cmd=jnp.zeros(12).at[5].set(0.55).at[9].set(0.2),
                            n_admm_iters=40, admm_rho_phases=1, admm_polish=False,
                            kinv_ns_iters=10)
    jg = jcfg.GaitConfig(steps_per_phase=3, contact_clock=True)
    tm, tg = _port(tcfg.MpcConfig, jm), _port(tcfg.GaitConfig, jg)
    n = 4
    x, q, qd = _states(n, 7)
    down = np.array([[True, False], [False, True], [True, True], [False, False]])
    jb = jbiped.BipedParams()
    tb = tbiped.BipedParams().expand(n)
    jtick = jax.jit(jax.vmap(lambda a, b, c, s, d: jctl.control_tick(
        a, b, c, 0.0, jm, jg, jb, ctrl_state=s, contact_meas=d)))
    js = jax.vmap(lambda _: jctl.ControllerState.init(jm))(jnp.arange(n))
    ts = _port(tctl.ControllerState, js)
    for _ in range(2):
        tau_j, js, sol_j = jtick(x, q, qd, js, down)
        tau_t, ts, sol_t = tctl.control_tick(
            torch.tensor(x), torch.tensor(q), torch.tensor(qd), 0.0, tm, tg, tb,
            ctrl_state=ts, contact_meas=torch.tensor(down))
        _close(sol_t.controls, sol_j.controls, 0.05, "controls")
        _close(tau_t, tau_j, 0.02, "tau")
        np.testing.assert_array_equal(ts.t_gait.numpy(), np.asarray(js.t_gait))
        np.testing.assert_array_equal(ts.hold_count.numpy(), np.asarray(js.hold_count))
    with pytest.raises(ValueError, match="contact_meas"):
        tctl.control_tick(torch.tensor(x), torch.tensor(q), torch.tensor(qd), 0.0, tm, tg, tb,
                          ctrl_state=ts)

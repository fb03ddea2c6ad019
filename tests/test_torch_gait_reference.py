"""Torch port vs JAX package: contact schedule, CoM and foot references and
swing targets, at every tick of two gait cycles on the exact f32 clock a
rollout builds by repeated ``t + dt``.

Tolerances: contact flags and phase indices must be EQUAL (a flipped phase
makes closed loops diverge); references and swing targets atol 1e-5 (f32
roundoff of the same closed forms on O(1) values). The JAX side is jitted
with the configs closed over, as its rollouts run it, so that XLA's
constant folding (``t / dt`` -> ``t * f32(1/dt)``) is the one the port must
reproduce.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control import gait as jgait
from biped_mpc_py_tpu.control import reference as jref
from biped_mpc_py_tpu.control import swing as jswing
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import gait as tgait
from biped_mpc_py_torch.control import reference as tref
from biped_mpc_py_torch.control import swing as tswing
from biped_mpc_py_torch.utils.convert import from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
XC_WALK = np.array([0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0], np.float32)
XC_TURN = np.array([0, 0, 0, 0, 0, 0.55, 0, 0, 0.5, 0.2, 0.05, 0], np.float32)

# (MpcConfig overrides, GaitConfig overrides) per case
CASES = {
    "default": ({}, {}),
    "walk_cmd": ({"x_cmd": XC_WALK}, {}),
    "fast_cadence": ({"x_cmd": XC_WALK}, {"steps_per_phase": 2}),
    "reference_compat": ({"compat": True, "x_cmd": XC_WALK}, {}),
    "body_frame_turn": (
        {"x_cmd": XC_TURN, "cmd_body_frame": True, "raibert_capture_gain": 1.0,
         "capture_sched": 0.5, "raibert_am_y": 0.14, "raibert_am_x": 0.14},
        {"steps_per_phase": 3},
    ),
    "running": (
        {"x_cmd": XC_WALK, "swing_z_sin2": True, "swing_land_frac": 0.8,
         "pitch_ref_leak": 0.05, "raibert_vint": 0.2, "raibert_pitch_place": 0.1,
         "raibert_ff_scale": 0.8},
        {"steps_per_phase": 3, "flight_steps": 1},
    ),
    "standing": ({}, {"gait_mode": 0}),
}


def _configs(name):
    m_over, g_over = CASES[name]
    m_over = dict(m_over)
    compat = m_over.pop("compat", False)
    if "x_cmd" in m_over:
        m_over["x_cmd"] = jnp.asarray(m_over["x_cmd"])
    make = jcfg.reference_compat_config if compat else jcfg.default_mpc_config
    jm, jg = make(**m_over), jcfg.GaitConfig(**g_over)
    tm = from_numpy(tcfg.MpcConfig, dataclasses.asdict(jax.tree.map(np.asarray, jm)))
    tg = from_numpy(tcfg.GaitConfig, dataclasses.asdict(jax.tree.map(np.asarray, jg)))
    return jm, jg, tm, tg


def _rollout_clock(n_ticks, dt=0.04):
    """t_k as a rollout builds it: t_{k+1} = t_k + dt in f32."""
    t = np.zeros(n_ticks, np.float32)
    for k in range(1, n_ticks):
        t[k] = t[k - 1] + np.float32(dt)
    return t


def test_phase_index_on_rollout_clock():
    """3000 ticks (2 min) of the accumulated f32 clock: the port's phase
    index equals the compiled JAX one at every tick."""
    jm, tm = jcfg.MpcConfig(), tcfg.MpcConfig()
    t = _rollout_clock(3000)
    k_j = np.asarray(jax.jit(lambda t: jgait.phase_index(t, jm))(jnp.asarray(t)))
    k_t = tgait.phase_index(torch.from_numpy(t), tm).numpy()
    np.testing.assert_array_equal(k_t, k_j)


@pytest.mark.parametrize("name", sorted(CASES))
def test_contact_sequence_equal(name):
    jm, jg, tm, tg = _configs(name)
    t = _rollout_clock(3000)
    c_j = jax.jit(jax.vmap(lambda t: jgait.contact_sequence(t, jm, jg)))(jnp.asarray(t))
    c_t = tgait.contact_sequence(torch.from_numpy(t), tm, tg)
    assert c_t.shape == (3000, jm.h, 2)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def _two_cycles(tg):
    """Ticks covering two gait periods, at the start and after 1000 ticks."""
    period = 2 * (tg.steps_per_phase + tg.flight_steps)
    t = _rollout_clock(1000 + 2 * period)
    return np.concatenate([t[: 2 * period], t[1000:]])


def _feedback(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 12)) * 0.05).astype(np.float32)
    x[:, 3:5] += rng.normal(size=(n, 2)).astype(np.float32)
    x[:, 5] += 0.53
    x[:, 9] += 0.3
    foot = np.tile(np.array([-0.02, 0.09, 0, -0.02, -0.09, 0], np.float32), (n, 1))
    foot += (rng.normal(size=(n, 6)) * 0.05).astype(np.float32)
    extra = {
        "cmd_ref": (rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
        "v_int": (rng.normal(size=(n, 2)) * 0.1).astype(np.float32),
        "pitch_ref": (rng.normal(size=(n,)) * 0.05).astype(np.float32),
    }
    return x, foot, extra


def _close(t_val, j_val):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_references_match_jax(name):
    """com_reference and foot_reference at every tick of two cycles."""
    jm, jg, tm, tg = _configs(name)
    t = _two_cycles(tg)
    n = t.shape[0]
    x, foot, ex = _feedback(n, seed=len(name))
    J = {k: jnp.asarray(v) for k, v in ex.items()}
    T = {k: torch.from_numpy(v) for k, v in ex.items()}

    xr_j = jax.jit(jax.vmap(
        lambda x, r, vi, pr: jref.com_reference(x, jm, r, v_int=vi, pitch_ref=pr)
    ))(jnp.asarray(x), J["cmd_ref"], J["v_int"], J["pitch_ref"])
    xr_t = tref.com_reference(
        torch.from_numpy(x), tm, T["cmd_ref"], v_int=T["v_int"], pitch_ref=T["pitch_ref"]
    )
    _close(xr_t, xr_j)

    def jfoot(x, t, f, vi):
        c = jgait.contact_sequence(t, jm, jg)
        return jref.foot_reference(x, t, f, jm, c, jg, v_int=vi)

    fr_j = jax.jit(jax.vmap(jfoot))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(foot), J["v_int"]
    )
    t_t = torch.from_numpy(t)
    c_t = tgait.contact_sequence(t_t, tm, tg)
    fr_t = tref.foot_reference(
        torch.from_numpy(x), t_t, torch.from_numpy(foot), tm, c_t, tg, v_int=T["v_int"]
    )
    _close(fr_t, fr_j)


@pytest.mark.parametrize("name", sorted(CASES))
def test_swing_targets_match_jax(name):
    """swing_target_xy, swing_phase_z(+_vel) and swing_clock per leg."""
    jm, jg, tm, tg = _configs(name)
    t = _two_cycles(tg)
    x, _, ex = _feedback(t.shape[0], seed=7)
    t_t, x_t, vi_t = torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(ex["v_int"])
    for side in (1.0, -1.0):
        fx_j, fy_j = jax.jit(jax.vmap(
            lambda x, vi: jswing.swing_target_xy(x, jm, side, jg, vi)
        ))(jnp.asarray(x), jnp.asarray(ex["v_int"]))
        fx_t, fy_t = tswing.swing_target_xy(x_t, tm, side, tg, vi_t)
        _close(fx_t, fx_j)
        _close(fy_t, fy_j)
        for jfn, tfn in (
            (jswing.swing_phase_z, tswing.swing_phase_z),
            (jswing.swing_phase_z_vel, tswing.swing_phase_z_vel),
        ):
            v_j = jax.jit(jax.vmap(
                lambda t: jfn(t, jm, jg, jnp.float32, side=side)
            ))(jnp.asarray(t))
            _close(tfn(t_t, tm, tg, torch.float32, side=side), v_j)
        fr_j = jax.jit(jax.vmap(
            lambda t: jgait.swing_clock(t, jm, jg, side, jnp.float32)[0]
        ))(jnp.asarray(t))
        fr_t, T_sw = tgait.swing_clock(t_t, tm, tg, side, torch.float32)
        _close(fr_t, fr_j)
        assert T_sw == pytest.approx(jgait.swing_clock(0.0, jm, jg, side, jnp.float32)[1])


def test_gait_helpers_match_jax():
    jm, tm = jcfg.MpcConfig(), tcfg.MpcConfig()
    for speed in (0.0, 0.1, 0.15, 0.25, 0.5, -0.8):
        j, t = jgait.gait_for_speed(speed), tgait.gait_for_speed(speed)
        assert (t.steps_per_phase, t.gait_mode) == (j.steps_per_phase, j.gait_mode)
    for g in (None, jcfg.GaitConfig(steps_per_phase=3)):
        tg = None if g is None else tcfg.GaitConfig(steps_per_phase=3)
        assert tgait.phase_time(tm, tg) == jgait.phase_time(jm, g)

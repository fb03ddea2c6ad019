"""The slice: the torch port's articulated closed loop against the JAX
package's ``batched_art_rollout_fn`` (the XLA path), from the same seeded
worlds, at the bench solver budget (40 iterations, 1 rho phase, no polish,
10 Newton-Schulz steps) and walking at 0.3 m/s (p = 3).

Tolerances:
- the plain chain (``batched_art_rollout``, and its compiled form
  ``batched_art_rollout_fn``) against the same JAX path:
  pos 1e-4, quat 1e-4, v_base 2e-3, q 1e-3, qd 2e-2 (f32 roundoff grown
  through 2-3 ticks of stiff contact; measured pos 8e-7, qd 3e-4), the
  clock and the fall counts equal;
- the kernel entry point (``batched_art_rollout_kernel``, the plain
  substeps on CPU tensors) against the same JAX path: the bounds of
  ``tests/test_substep_kernel.py::test_kernel_rollout_matches_xla``
  (pos 2e-2, qd 2.0, t_gait 1e-5, zero falls). The two differ by design:
  the kernel path advances ``t`` once per low-level period and the chain
  once per substep, so the f32 clocks differ in the last bits and a swing
  clock near a phase boundary can read the other phase (measured here:
  pos 1.1e-3, qd 1.7);
- the same chain at four more operating points (a run and a walk on the
  contact-sensed clock, a turn in place, foot-frame wrench rows): the same
  bounds, the gait clock and its hold counts equal;
- the port alone, 50 ticks standing: the bounds of
  ``tests/test_rollout_art.py::test_articulated_standing``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import substep_kernel
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from torch_threads import one_torch_thread  # noqa: F401

CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _setup(n=4, seed=0):
    """JAX config, gait, worlds (qd desynced by 0.01 rad/s) and robots."""
    jm, jg = jra.art_config_for_speed(
        0.3, n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10
    )
    rng = np.random.default_rng(seed)
    jw = jax.vmap(lambda _: jra.init_art_world(jm))(jnp.arange(n))
    qd = jw.sim.qd + jnp.asarray(0.01 * rng.normal(size=(n, 10)), jnp.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, qd=qd))
    jb = jax.vmap(lambda _: JBipedParams())(jnp.arange(n))
    return jm, jg, jw, jb


def _port(jm, jg, jw, jb):
    return (from_numpy(tcfg.MpcConfig, _fields(jm)), from_numpy(tcfg.GaitConfig, _fields(jg)),
            from_numpy(tra.ArtWorld, _fields(jw)), from_numpy(BipedParams, _fields(jb)))


def _diff(t, j, key):
    return float(np.abs(np.asarray(t["sim"][key]) - np.asarray(j["sim"][key])).max())


@functools.cache
def _jax_plain_chain(ticks, n_substeps, hold):
    """``jax.jit(batched_art_rollout_fn)`` from :func:`_setup`'s worlds, once
    per module for each physics (the eager and the compiled plain chain and
    the substep-kernel entry point use it)."""
    jm, jg, jw, jb = _setup()
    return jax.jit(jra.batched_art_rollout_fn(
        ticks, jm, jg, n_substeps=n_substeps, minv_ll_hold=hold))(jw, jb)


def _assert_plain_chain(out_t, out_j):
    j, t = _fields(out_j), to_numpy(out_t)
    for key, tol in CHAIN_BOUNDS.items():
        assert _diff(t, j, key) < tol, (key, _diff(t, j, key))
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["ctrl"]["t_gait"], j["ctrl"]["t_gait"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_allclose(t["metrics"]["energy"], j["metrics"]["energy"], rtol=1e-3)
    np.testing.assert_allclose(t["ctrl"]["qp"]["controls"], j["ctrl"]["qp"]["controls"],
                               atol=0.1, rtol=0)


@pytest.mark.parametrize("ticks,n_substeps,hold", [(3, 5, 8), (2, 10, 1)])
def test_plain_chain_matches_jax(ticks, n_substeps, hold):
    """``batched_art_rollout`` at the bench physics (5 substeps, Minv held
    all tick) and at the default (10 substeps, Minv every period)."""
    tm, tg, tw, tb = _port(*_setup())
    out_t = tra.batched_art_rollout(tw, tb, ticks, tm, tg, n_substeps=n_substeps,
                                    minv_ll_hold=hold)
    _assert_plain_chain(out_t, _jax_plain_chain(ticks, n_substeps, hold))


def test_plain_chain_fn_matches_jax():
    """The compiled plain chain, ``batched_art_rollout_fn`` (on the CPU its
    static buffers step eagerly), 4 envs x 2 ticks at the default physics
    against ``jax.jit(batched_art_rollout_fn)``: ``CHAIN_BOUNDS``, the clock
    bit-equal; no physics kernel in the tick."""
    tm, tg, tw, tb = _port(*_setup())
    before = substep_kernel.fused_substeps.launches
    out_t = tra.batched_art_rollout_fn(2, tm, tg, n_substeps=10, minv_ll_hold=1)(tw, tb)
    assert substep_kernel.fused_substeps.launches == before
    _assert_plain_chain(out_t, _jax_plain_chain(2, 10, 1))


OPERATING_POINTS = {
    # the running gait (p = 2, one flight step) on the contact-sensed clock
    "run_contact_clock": lambda kw: _with_gait(jra.art_config_for_run(1.0, **kw),
                                               contact_clock=True),
    # the turn in place: body-frame commands, the unified heading point
    "turn_in_place": lambda kw: jra.art_config_for_turn(0.3, **kw),
    # foot-frame wrench rows: the measured foot headings enter the QP
    "foot_frame_wrench": lambda kw: jra.art_config_for_speed(0.3, foot_frame_wrench=True, **kw),
    # the walk on the contact-sensed clock
    "walk_contact_clock": lambda kw: _with_gait(jra.art_config_for_speed(0.3, **kw),
                                                contact_clock=True),
}


def _with_gait(configs, **gait_overrides):
    jm, jg = configs
    return jm, dataclasses.replace(jg, **gait_overrides)


@pytest.mark.parametrize("point", sorted(OPERATING_POINTS))
def test_plain_chain_operating_points_match_jax(point):
    """3 ticks of ``batched_art_rollout`` against ``batched_art_rollout_fn``
    away from the 0.3 m/s walk on the fixed clock: each operating point
    turns on a branch of the closed loop (the gait clock and its holds, the
    command anchor, the foot headings) that the walk leaves off. Bench
    budget and physics, ``CHAIN_BOUNDS``."""
    ticks = 3
    jm, jg = OPERATING_POINTS[point](dict(
        n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10))
    _, _, jw, jb = _setup()
    jw = dataclasses.replace(
        jw, ctrl=jax.vmap(lambda _: jra.init_art_world(jm).ctrl)(jnp.arange(4)))
    out_j = jax.jit(jra.batched_art_rollout_fn(ticks, jm, jg, n_substeps=5, minv_ll_hold=8))(
        jw, jb)
    tm, tg, tw, tb = _port(jm, jg, jw, jb)
    out_t = tra.batched_art_rollout(tw, tb, ticks, tm, tg, n_substeps=5, minv_ll_hold=8)
    j, t = _fields(out_j), to_numpy(out_t)
    for key, tol in CHAIN_BOUNDS.items():
        assert _diff(t, j, key) < tol, (key, _diff(t, j, key))
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["ctrl"]["t_gait"], j["ctrl"]["t_gait"])
    np.testing.assert_array_equal(t["ctrl"]["hold_count"], j["ctrl"]["hold_count"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_allclose(t["ctrl"]["cmd_ref"], j["ctrl"]["cmd_ref"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t["metrics"]["energy"], j["metrics"]["energy"], rtol=1e-3)
    np.testing.assert_allclose(t["ctrl"]["qp"]["controls"], j["ctrl"]["qp"]["controls"],
                               atol=0.1, rtol=0)


def test_kernel_entry_point_matches_jax():
    """4 envs x 3 ticks of ``batched_art_rollout_kernel`` (on the CPU: the
    kernel's plain version) against ``batched_art_rollout_fn(n_substeps=5,
    minv_ll_hold=8)``."""
    ticks = 3
    out_j = _jax_plain_chain(ticks, 5, 8)
    tm, tg, tw, tb = _port(*_setup())
    before = substep_kernel.fused_substeps.launches
    out_t = tra.batched_art_rollout_kernel(tw, tb, ticks, tm, tg)
    assert substep_kernel.fused_substeps.launches == before  # CPU: no launch
    j, t = _fields(out_j), to_numpy(out_t)
    assert float(t["metrics"]["falls"].sum()) == 0 and float(j["metrics"]["falls"].sum()) == 0
    assert _diff(t, j, "pos") < 2e-2, _diff(t, j, "pos")
    assert _diff(t, j, "qd") < 2.0, _diff(t, j, "qd")
    d_tg = float(np.abs(t["ctrl"]["t_gait"] - j["ctrl"]["t_gait"]).max())
    assert d_tg < 1e-5, d_tg
    np.testing.assert_allclose(t["sim"]["t"], j["sim"]["t"], atol=1e-6, rtol=0)


def test_fall_reset_matches_jax():
    """An env outside the fall band resets in-batch as in JAX: the standing
    pose, a cold controller, its clock kept, the fall counted."""
    jm, jg, jw, jb = _setup(3, seed=1)
    pos = jw.sim.pos.at[1, 2].set(1.2)  # above the fall band
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, pos=pos))
    out_j = jax.jit(jra.batched_art_rollout_fn(1, jm, jg, n_substeps=5, minv_ll_hold=8))(jw, jb)
    tm, tg, tw, tb = _port(jm, jg, jw, jb)
    out_t = tra.batched_art_rollout(tw, tb, 1, tm, tg, n_substeps=5, minv_ll_hold=8)
    j, t = _fields(out_j), to_numpy(out_t)
    np.testing.assert_array_equal(t["metrics"]["falls"], [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_array_equal(t["sim"]["pos"][1], j["sim"]["pos"][1])  # the reset pose
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    for key in ("cmd_ref", "t_gait", "hold_count"):
        np.testing.assert_array_equal(t["ctrl"][key][1], j["ctrl"][key][1])


def test_standing_50_ticks():
    """The port alone: 50 ticks (2 s) standing on the default physics, the
    bounds of tests/test_rollout_art.py::test_articulated_standing."""
    mpc = tra.art_mpc_config()
    w = tra.batched_art_rollout(tra.init_art_world(mpc, device="cpu"), BipedParams(), 50, mpc,
                                tcfg.GaitConfig(gait_mode=0))
    x = w.sim.torso_state()[0]
    assert float(w.metrics.falls[0]) == 0
    assert abs(float(x[5]) - 0.55) < 0.02
    assert float(x[0:2].abs().max()) < 0.05
    assert bool(torch.isfinite(w.sim.qd).all())

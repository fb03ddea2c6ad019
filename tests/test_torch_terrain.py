"""The torch port's height-field terrain against the JAX package: the
``Terrain`` sampler, terrain contact, the terrain-adaptive references, and
the rough-terrain articulated closed loop.

Inputs are made with numpy from a seed; height fields are carried from the
JAX side through ``utils/convert.py`` (``Terrain.rough`` draws with
``jax.random``, which no torch generator reproduces, so draws are never
compared). A field per env is a vmapped ``Terrain`` in JAX and a leading
axis on ``heights`` in the port.

Tolerances:
- ``height`` 1e-6, ``normal`` 1e-5 absolute (the half-cell step of the
  central difference straddles a knot of the bilinear patch, and f32
  roundoff in the cell fraction moves the result by ~1e-6);
- contact force: 1e-5 relative to the largest entry; a flat field is
  bit-equal to ``terrain=None``;
- references, the QP's linear term and the swing force: 1e-5 absolute
  (relative to the largest entry for the QP's q and the swing force, whose
  entries are O(100));
- one substep on a field: the bounds of ``tests/test_torch_sim.py``;
- 3 ticks of the closed loop: ``tests/test_torch_rollout_art.py``'s
  ``CHAIN_BOUNDS``, the clock and the fall counts equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.control import gait as jgait
from biped_mpc_py_tpu.control import mpc as jmpc
from biped_mpc_py_tpu.control import reference as jref
from biped_mpc_py_tpu.control import swing as jswing
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.sim import contact as jcontact
from biped_mpc_py_tpu.sim import engine as jeng
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import gait as tgait
from biped_mpc_py_torch.control import mpc as tmpc
from biped_mpc_py_torch.control import reference as tref
from biped_mpc_py_torch.control import swing as tswing
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import substep_kernel, tick_kernel
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim import contact as tcontact
from biped_mpc_py_torch.sim import engine as teng
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from tests.test_torch_rollout_art import CHAIN_BOUNDS
from tests.test_torch_sim import JM, SUBSTEP_BOUNDS, TM, _close, _fields, _perturbed
from torch_threads import one_torch_thread  # noqa: F401

N, RES, EXTENT = 6, 12, 4.0


def _terrains(per_env, seed=0, amplitude=0.05, n=N, res=RES, extent=EXTENT):
    """(JAX Terrain, port Terrain) with the same seeded heights: one field,
    or one per env (a vmapped JAX Terrain, whose extent carries the env
    axis)."""
    rng = np.random.default_rng(seed)
    shape = (n, res, res + 3) if per_env else (res, res + 3)  # H != W
    h = jnp.asarray(amplitude * rng.normal(size=shape), jnp.float32)
    if per_env:
        jt = jax.vmap(lambda h: jcontact.Terrain(heights=h, extent=extent))(h)
    else:
        jt = jcontact.Terrain(heights=h, extent=extent)
    return jt, from_numpy(tcontact.Terrain, _fields(jt))


def _queries(shape, seed, res=RES, extent=EXTENT):
    """World (x, y) of ``shape``: a third inside the grid, a third exactly
    on knots, a third beyond the edge (and some on it)."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    kind = rng.integers(0, 3, size=size)
    inside = rng.uniform(-0.5 * extent, 0.5 * extent, size=(2, size))
    kx = (rng.integers(0, res + 3, size=size) / (res + 2) - 0.5) * extent
    ky = (rng.integers(0, res, size=size) / (res - 1) - 0.5) * extent
    beyond = rng.uniform(-extent, extent, size=(2, size))
    x = np.where(kind == 0, inside[0], np.where(kind == 1, kx, beyond[0]))
    y = np.where(kind == 0, inside[1], np.where(kind == 1, ky, beyond[1]))
    return x.reshape(shape).astype(np.float32), y.reshape(shape).astype(np.float32)


def _jax_sample(jt, per_env, name, x, y):
    fn = getattr(jcontact.Terrain, name)
    if per_env:
        return jax.jit(jax.vmap(fn))(jt, jnp.asarray(x), jnp.asarray(y))
    return jax.jit(lambda x, y: fn(jt, x, y))(jnp.asarray(x), jnp.asarray(y))


@pytest.mark.parametrize("shape", [(N,), (N, 2), (N, 2, 2), (N, 10)], ids=str)
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_height_and_normal_match_jax(per_env, shape):
    """Every query shape the closed loop uses: (N,) swing targets, (N,2)
    sole pairs, (N,2,2) toe/heel points, (N,h) reference rows."""
    jt, tt = _terrains(per_env)
    x, y = _queries(shape, seed=len(shape))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    h_t = tt.height(tx, ty)
    assert h_t.shape == shape and h_t.dtype == torch.float32
    _close(h_t, _jax_sample(jt, per_env, "height", x, y), 1e-6, name="height")
    n_t = tt.normal(tx, ty)
    assert n_t.shape == shape + (3,)
    _close(n_t, _jax_sample(jt, per_env, "normal", x, y), 1e-5, name="normal")
    np.testing.assert_allclose(torch.linalg.norm(n_t, dim=-1).numpy(), 1.0, atol=1e-6)
    # the contact law's one-call form: the five samples on a trailing axis
    h_2, n_2 = tt.height_and_normal(tx, ty)
    assert torch.equal(h_2, h_t) and torch.equal(n_2, n_t)


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_nan_query_reads_nan_on_the_grid(per_env):
    """A query that is not a number (a sole point of an env whose state
    diverged) reads NaN, as JAX's clamped gathers give it, and indexes
    nothing off the grid; the other queries of the call read as JAX."""
    jt, tt = _terrains(per_env)
    nan, inf = float("nan"), float("inf")
    x = np.array([[nan, 0.3], [0.1, inf], [nan, -inf], [0.2, -0.4], [nan, 1.0], [0.0, 0.0]],
                 np.float32)
    y = np.array([[0.0, nan], [0.1, 0.2], [nan, 0.5], [inf, 0.3], [-1.0, nan], [0.0, 0.0]],
                 np.float32)
    assert x.shape == (N, 2)
    h_t = tt.height(torch.from_numpy(x), torch.from_numpy(y))
    h_j = np.asarray(_jax_sample(jt, per_env, "height", x, y))
    assert np.array_equal(np.isnan(h_t.numpy()), np.isnan(x) | np.isnan(y))
    assert np.array_equal(np.isnan(h_j), np.isnan(x) | np.isnan(y))
    _close(h_t.nan_to_num(), np.nan_to_num(h_j), 1e-6, name="height")


def test_height_edges_and_broadcast():
    """Beyond the grid the ground is flat at the edge value, a shared field
    broadcasts x against y, and a per-env field refuses queries that do not
    lead with its envs."""
    _, tt = _terrains(False)
    far = torch.tensor([10.0, -10.0])
    edge = torch.tensor([0.5 * EXTENT, -0.5 * EXTENT])
    assert torch.allclose(tt.height(far, far), tt.height(edge, edge), atol=1e-4)
    assert tt.height(torch.zeros(3, 1), torch.zeros(4)).shape == (3, 4)
    _, tb = _terrains(True)
    with pytest.raises(ValueError, match="envs"):
        tb.height(torch.zeros(N + 1), torch.zeros(N + 1))
    with pytest.raises(ValueError, match="envs"):
        tb.height(torch.tensor(0.0), torch.tensor(0.0))


def test_flat_constructor():
    flat = tcontact.Terrain.flat(device="cpu")
    assert flat.heights.shape == (2, 2) and not flat.batched and flat.extent == 8.0
    x = torch.tensor([0.3, -7.0])
    assert torch.equal(flat.height(x, x), torch.zeros(2))
    assert torch.equal(flat.normal(x, x), torch.tensor([[0.0, 0.0, 1.0]] * 2))
    per_env = tcontact.Terrain.flat(res=4, n=3, device="cpu")
    assert per_env.heights.shape == (3, 4, 4) and per_env.batched
    with pytest.raises(RuntimeError, match="device"):
        tcontact.Terrain.flat()  # the card by default, and there is none here


def test_slope_contact_force_is_slope_normal():
    """tests/test_sim.py::test_slope_contact_force_is_slope_normal on the
    port, with its bounds: on a linear ramp the resting reaction is along
    the slope normal and friction stays in the tangent plane."""
    slope, res, extent = 0.2, 33, 8.0
    xs = np.linspace(-extent / 2, extent / 2, res)
    terr = tcontact.Terrain(
        heights=torch.tensor(np.tile(slope * xs, (res, 1)), dtype=torch.float32), extent=extent)
    n_true = np.array([-slope, 0.0, 1.0])
    n_true /= np.linalg.norm(n_true)
    n = terr.normal(torch.tensor(0.3), torch.tensor(-0.2)).numpy()
    np.testing.assert_allclose(n, n_true, atol=1e-3)

    x, y = 0.5, 0.1
    h = float(terr.height(torch.tensor(x), torch.tensor(y)))
    p = torch.tensor([x, y, h - 0.01])
    f = tcontact.contact_force_world(TM, p, torch.zeros(3), terr).numpy().astype(np.float64)
    fn = float(f @ n_true)
    np.testing.assert_allclose(f, fn * n_true, atol=1e-3 * abs(fn) + 1e-6)
    np.testing.assert_allclose(fn, TM.contact_stiffness * 0.01 * n_true[2], rtol=2e-2)

    v = n_true[2] * np.array([1.0, 0, slope])  # a tangent direction
    f_slide = tcontact.contact_force_world(
        TM, p, torch.tensor(v, dtype=torch.float32), terr).numpy().astype(np.float64)
    assert abs(float(f_slide @ n_true) - fn) < 1e-2 * abs(fn) + 1e-6
    f_t = f_slide - (f_slide @ n_true) * n_true
    assert f_t @ v < 0  # opposes the slip
    f_flat = tcontact.contact_force_world(
        TM, torch.tensor([0.0, 0, -0.01]), torch.tensor([0.1, 0, 0.0]), None).numpy()
    assert f_flat[2] > 0 and f_flat[0] < 0 and abs(f_flat[1]) < 1e-8


def _points(seed, n=N):
    """Toe/heel-shaped contact points (N,2,2,3), half of them below a rough
    field of amplitude 0.05, and their velocities."""
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(n, 2, 2, 3)) * [1.0, 1.0, 0.05]).astype(np.float32)
    return p, rng.normal(size=(n, 2, 2, 3)).astype(np.float32)


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_contact_force_on_rough_field_matches_jax(per_env):
    jt, tt = _terrains(per_env, seed=1)
    p, v = _points(2)
    if per_env:
        f_j = jax.jit(jax.vmap(lambda p, v, t: jcontact.contact_force_world(JM, p, v, t)))(p, v, jt)
    else:
        f_j = jax.jit(lambda p, v: jcontact.contact_force_world(JM, p, v, jt))(p, v)
    f_t = tcontact.contact_force_world(TM, torch.tensor(p), torch.tensor(v), tt)
    assert float(f_t.abs().max()) > 10.0  # some points are in contact
    _close(f_t, f_j, rel=1e-5, name="contact force")


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_flat_field_contact_bit_equal_to_none(per_env):
    p, v = _points(3)
    p[..., 2] *= 0.2
    flat = tcontact.Terrain.flat(res=5, n=N if per_env else None, device="cpu")
    f_none = tcontact.contact_force_world(TM, torch.tensor(p), torch.tensor(v))
    f_flat = tcontact.contact_force_world(TM, torch.tensor(p), torch.tensor(v), flat)
    assert float(f_none.abs().max()) > 1.0
    assert torch.equal(f_flat, f_none)


def test_measured_contact_flat_and_terrain():
    """tests/test_contact_clock.py::test_measured_contact_flat_and_terrain
    on the port, then random soles over per-env fields against JAX."""
    gait = tcfg.GaitConfig(contact_clock=True)
    pf = torch.tensor([[0.0, 0.09, 0.005, 0.0, -0.09, 0.08]])
    assert tgait.measured_contact(pf, None, gait).tolist() == [[True, False]]
    terr = tcontact.Terrain(heights=torch.full((8, 8), 0.05), extent=4.0)
    pf2 = torch.tensor([[0.0, 0.09, 0.055, 0.0, -0.09, 0.10]])
    assert tgait.measured_contact(pf2, terr, gait).tolist() == [[True, False]]

    jt, tt = _terrains(True, seed=4)
    rng = np.random.default_rng(5)
    pf = (rng.normal(size=(N, 6)) * ([1, 1, 0.04] * 2)).astype(np.float32)
    jg = jgait.GaitConfig(contact_clock=True)
    down_j = jax.vmap(lambda p, t: jgait.measured_contact(p, t, jg))(jnp.asarray(pf), jt)
    down_t = tgait.measured_contact(torch.tensor(pf), tt, gait)
    np.testing.assert_array_equal(down_t.numpy(), np.asarray(down_j))
    assert down_t.any() and not down_t.all()


def _mpc_inputs(n, seed):
    """Perturbed walking feedback, feet, gait times and robots for ``n``
    envs, with the JAX and port configs of a 0.3 m/s walk."""
    rng = np.random.default_rng(seed)
    jm, jg = jra.art_config_for_speed(0.3)
    x = (rng.normal(size=(n, 12)) * 0.05).astype(np.float32)
    x[:, 3:5] += rng.normal(size=(n, 2)).astype(np.float32)
    x[:, 5] += 0.55
    x[:, 9] += 0.3
    foot = np.tile(np.array([-0.02, 0.09, 0, -0.02, -0.09, 0], np.float32), (n, 1))
    foot[:, [0, 1, 3, 4]] += x[:, [3, 4, 3, 4]]
    foot += (rng.normal(size=(n, 6)) * 0.03).astype(np.float32)
    t = (np.arange(n) * np.float32(0.04)).astype(np.float32)
    v_int = (rng.normal(size=(n, 2)) * 0.05).astype(np.float32)
    tm, tg = from_numpy(tcfg.MpcConfig, _fields(jm)), from_numpy(tcfg.GaitConfig, _fields(jg))
    return jm, jg, tm, tg, x, foot, t, v_int


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_foot_reference_lands_on_field(per_env):
    jm, jg, tm, tg, x, foot, t, v_int = _mpc_inputs(N, 6)
    jt, tt = _terrains(per_env, seed=7)

    def jfoot(x, t, f, vi, terr):
        c = jgait.contact_sequence(t, jm, jg)
        return jref.foot_reference(x, t, f, jm, c, jg, terr, v_int=vi)

    axes = (0, 0, 0, 0, 0 if per_env else None)
    fr_j = jax.jit(jax.vmap(jfoot, in_axes=axes))(x, t, foot, v_int, jt)
    t_t = torch.tensor(t)
    c_t = tgait.contact_sequence(t_t, tm, tg)
    fr_t = tref.foot_reference(torch.tensor(x), t_t, torch.tensor(foot), tm, c_t, tg, tt,
                               v_int=torch.tensor(v_int))
    _close(fr_t, fr_j, 1e-5, name="foot_reference")
    flat = tref.foot_reference(torch.tensor(x), t_t, torch.tensor(foot), tm, c_t, tg,
                               v_int=torch.tensor(v_int))
    assert float((fr_t - flat)[:, [2, 5]].abs().max()) > 1e-3  # the targets left z = 0
    assert torch.equal(fr_t[:, [0, 1, 3, 4]], flat[:, [0, 1, 3, 4]])


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_build_mpc_qp_rides_the_field(per_env):
    """z_ground (the held z row of the CoM reference) and the QP's linear
    term with a field under the feet."""
    jm, jg, tm, tg, x, foot, t, v_int = _mpc_inputs(N, 8)
    jt, tt = _terrains(per_env, seed=9, amplitude=0.1)
    jb = jax.vmap(lambda _: JBipedParams())(jnp.arange(N))

    def jbuild(x, t, f, b, vi, terr):
        c = jgait.contact_sequence(t, jm, jg)
        return jmpc.build_mpc_qp(x, t, f, jm, b, c, jg, terrain=terr, v_int=vi)

    axes = (0, 0, 0, 0, 0, 0 if per_env else None)
    qp_j = jax.jit(jax.vmap(jbuild, in_axes=axes))(x, t, foot, jb, v_int, jt)
    t_t = torch.tensor(t)
    args = (torch.tensor(x), t_t, torch.tensor(foot), tm, BipedParams().expand(N),
            tgait.contact_sequence(t_t, tm, tg), tg)
    qp_t = tmpc.build_mpc_qp(*args, terrain=tt, v_int=torch.tensor(v_int))
    _close(qp_t.q, qp_j.q, rel=1e-5, name="q")
    _close(qp_t.P, qp_j.P, rel=1e-5, name="P")
    qp_flat = tmpc.build_mpc_qp(*args, v_int=torch.tensor(v_int))
    assert float((qp_t.q - qp_flat.q).abs().max()) > 0.1  # the field moved the cost

    ft = torch.tensor(foot)
    z_ground = 0.5 * (tt.height(ft[:, 0], ft[:, 1]) + tt.height(ft[:, 3], ft[:, 4]))
    x_ref = tref.com_reference(torch.tensor(x), tm, z_ground=z_ground,
                               v_int=torch.tensor(v_int))
    z_j = jax.vmap(lambda f, terr: 0.5 * (terr.height(f[0], f[1]) + terr.height(f[3], f[4])),
                   in_axes=(0, 0 if per_env else None))(jnp.asarray(foot), jt)
    _close(z_ground, z_j, 1e-6, name="z_ground")
    _close(x_ref[:, 5, 0], 0.55 + np.asarray(z_j), 1e-6, name="held z row")


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_swing_leg_force_apex_rides_field(per_env):
    jm, jg, tm, tg, x, foot, t, v_int = _mpc_inputs(N, 10)
    jt, tt = _terrains(per_env, seed=11)
    rng = np.random.default_rng(12)
    vf = rng.normal(size=(N, 3)).astype(np.float32)
    t = (t + np.float32(0.013)).astype(np.float32)
    axes = (0, 0, 0, 0, 0, 0 if per_env else None)
    for leg, side in enumerate((1.0, -1.0)):
        pf = foot[:, 3 * leg:3 * leg + 3]
        f_j = jax.jit(jax.vmap(
            lambda x, t, p, v, vi, terr: jswing.swing_leg_force(x, t, p, v, jm, side, jg, terr, vi),
            in_axes=axes))(x, t, pf, vf, v_int, jt)
        f_t = tswing.swing_leg_force(torch.tensor(x), torch.tensor(t), torch.tensor(pf),
                                     torch.tensor(vf), tm, side, tg, tt, torch.tensor(v_int))
        _close(f_t, f_j, rel=1e-5, name=f"swing force, side {side}")
        f_flat = tswing.swing_leg_force(torch.tensor(x), torch.tensor(t), torch.tensor(pf),
                                        torch.tensor(vf), tm, side, tg, None, torch.tensor(v_int))
        assert torch.equal(f_t[:, :2], f_flat[:, :2])
        assert float((f_t - f_flat)[:, 2].abs().max()) > 1.0  # kp x the height under the target


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_art_substep_on_field(per_env):
    n = 32
    js, ts, tau = _perturbed(n, 13)
    jt, tt = _terrains(per_env, seed=14, amplitude=0.01, n=n)
    Minv = jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q))(js.q)
    out_j = jax.jit(jax.vmap(
        lambda s, tq, terr, mi: jeng.art_substep(JM, s, tq, 0.001, terr, Minv=mi),
        in_axes=(0, 0, 0 if per_env else None, 0)))(js, tau, jt, Minv)
    out_t = teng.art_substep(TM, ts, torch.tensor(tau), 0.001, tt,
                             Minv=torch.tensor(np.asarray(Minv)))
    for name, tol in SUBSTEP_BOUNDS.items():
        _close(getattr(out_t, name), getattr(out_j, name), tol, name=name)
    flat = teng.art_substep(TM, ts, torch.tensor(tau), 0.001, Minv=torch.tensor(np.asarray(Minv)))
    assert float((out_t.qd - flat.qd).abs().max()) > 1e-3  # the field changed the contact
    # a whole period passes the field down to every substep
    step_j = jax.jit(jax.vmap(
        lambda s, tq, terr, mi: jeng.art_step(JM, s, tq, 0.005, 3, terr, Minv=mi),
        in_axes=(0, 0, 0 if per_env else None, 0)))(js, tau, jt, Minv)
    step_t = teng.art_step(TM, ts, torch.tensor(tau), 0.005, 3, tt,
                           Minv=torch.tensor(np.asarray(Minv)))
    for name, tol in SUBSTEP_BOUNDS.items():
        _close(getattr(step_t, name), getattr(step_j, name), 3 * tol, name=f"art_step {name}")


def _walk_setup(n, seed=0):
    """JAX walking config at the bench budget in f32, worlds with joint
    velocities desynced by 0.01 rad/s, robots; and their port copies."""
    jm, jg = jra.art_config_for_speed(
        0.3, n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
    rng = np.random.default_rng(seed)
    jw = jax.vmap(lambda _: jra.init_art_world(jm))(jnp.arange(n))
    qd = jw.sim.qd + jnp.asarray(0.01 * rng.normal(size=(n, 10)), jnp.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, qd=qd))
    jb = jax.vmap(lambda _: JBipedParams())(jnp.arange(n))
    port = (from_numpy(tcfg.MpcConfig, _fields(jm)), from_numpy(tcfg.GaitConfig, _fields(jg)),
            from_numpy(tra.ArtWorld, _fields(jw)), from_numpy(BipedParams, _fields(jb)))
    return (jm, jg, jw, jb), port


def _assert_chain(out_t, out_j):
    j, t = _fields(out_j), to_numpy(out_t)
    for key, tol in CHAIN_BOUNDS.items():
        err = float(np.abs(np.asarray(t["sim"][key]) - np.asarray(j["sim"][key])).max())
        assert err < tol, (key, err)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_allclose(t["metrics"]["energy"], j["metrics"]["energy"], rtol=1e-3)


@functools.cache
def _terrain_walk():
    """The JAX and port inputs of the per-env terrain walk and
    ``jax.jit(batched_art_rollout_terrain_fn)``'s result, once per module
    (the eager and the compiled port use it): JAX-drawn rough fields
    (``Terrain.rough_batch``, res 16) on a 2 m grid, so that the feet see
    slopes, at the bench physics (5 substeps, Minv held all tick)."""
    n, ticks = 2, 3
    (jm, jg, jw, jb), port = _walk_setup(n)
    jt = jcontact.Terrain.rough_batch(jax.random.PRNGKey(1), n, amplitude=0.06, res=16)
    jt = dataclasses.replace(jt, extent=jnp.full((n,), 2.0, jnp.float32))
    tt = from_numpy(tcontact.Terrain, _fields(jt))
    out_j = jax.jit(jra.batched_art_rollout_terrain_fn(
        ticks, jm, jg, n_substeps=5, minv_ll_hold=8))(jw, jb, jt)
    return port, tt, out_j


def test_terrain_rollout_matches_jax():
    """2 envs x 3 ticks of ``batched_art_rollout_terrain`` against
    ``batched_art_rollout_terrain_fn`` from the same worlds, robots and
    JAX-drawn rough fields (``Terrain.rough_batch``, res 16), at the bench
    physics (5 substeps, Minv held all tick)."""
    n, ticks = 2, 3
    (tm, tg, tw, tb), tt, out_j = _terrain_walk()
    assert tt.heights.shape == (n, 16, 16) and tt.extent == 2.0
    qp_before = (substep_kernel.fused_substeps.launches, tick_kernel.fused_tick.launches)
    out_t = tra.batched_art_rollout_terrain(tw, tb, tt, ticks, tm, tg, n_substeps=5,
                                            minv_ll_hold=8)
    assert (substep_kernel.fused_substeps.launches, tick_kernel.fused_tick.launches) == qp_before
    _assert_chain(out_t, out_j)
    flat = tra.batched_art_rollout(tw, tb, ticks, tm, tg, n_substeps=5, minv_ll_hold=8)
    assert float((out_t.sim.q - flat.sim.q).abs().max()) > 1e-3  # the fields were felt


def test_terrain_fn_matches_jax():
    """The compiled per-env terrain walk, ``batched_art_rollout_terrain_fn``
    (the fields an input of its graph; on the CPU its static buffers step
    eagerly), against the same JAX run; it also refuses fields without the
    worlds' env axis."""
    (tm, tg, tw, tb), tt, out_j = _terrain_walk()
    fn = tra.batched_art_rollout_terrain_fn(3, tm, tg, n_substeps=5, minv_ll_hold=8)
    _assert_chain(fn(tw, tb, tt), out_j)
    with pytest.raises(ValueError, match="env axis"):
        fn(tw, tb, tcontact.Terrain.flat(n=3, device="cpu"))


def test_shared_ramp_single_env_matches_art_rollout_fn():
    """N = 1 with one shared field is the counterpart of the single-env
    ``art_rollout_fn(terrain=)``: the turn in place on a 15 % ramp with
    foot-frame wrench rows (the setting of
    tests/test_rollout_art.py::test_articulated_sloped_turning_foot_frame_wrench),
    2 ticks at the default physics (10 substeps, Minv every period)."""
    ticks = 2
    jm, jg = jra.art_config_for_turn(0.3, foot_frame_wrench=True)
    xs = np.linspace(-4.0, 4.0, 33)
    jt = jcontact.Terrain(heights=jnp.asarray(np.tile(0.15 * xs, (33, 1)), jnp.float32),
                          extent=8.0)
    jw = jra.init_art_world(jm)
    out_j = jax.jit(jra.art_rollout_fn(ticks, jm, jg, model=JM, terrain=jt))(jw, JBipedParams())
    out_j = jax.tree.map(lambda a: jnp.asarray(a)[None], out_j)

    tm, tg = from_numpy(tcfg.MpcConfig, _fields(jm)), from_numpy(tcfg.GaitConfig, _fields(jg))
    tt = from_numpy(tcontact.Terrain, _fields(jt))
    assert not tt.batched
    tw = from_numpy(tra.ArtWorld, _fields(jax.tree.map(lambda a: jnp.asarray(a)[None], jw)))
    out_t = tra.batched_art_rollout(tw, BipedParams(), ticks, tm, tg, model=TM, terrain=tt)
    _assert_chain(out_t, out_j)
    j, t = _fields(out_j), to_numpy(out_t)
    np.testing.assert_allclose(t["ctrl"]["cmd_ref"], j["ctrl"]["cmd_ref"], atol=1e-5)


def test_flat_fields_rollout_bit_equal_to_none():
    _, (tm, tg, tw, tb) = _walk_setup(3, seed=1)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    none = tra.batched_art_rollout(tw, tb, 2, tm, tg, **kw)
    per_env = tra.batched_art_rollout_terrain(
        tw, tb, tcontact.Terrain.flat(n=3, device="cpu"), 2, tm, tg, **kw)
    shared = tra.batched_art_rollout(tw, tb, 2, tm, tg, terrain=tcontact.Terrain.flat(device="cpu"),
                                     **kw)
    for out in (per_env, shared):
        for f in dataclasses.fields(none.sim):
            assert torch.equal(getattr(out.sim, f.name), getattr(none.sim, f.name)), f.name
        assert torch.equal(out.ctrl.qp.controls, none.ctrl.qp.controls)


def test_terrain_entry_points_check_their_fields():
    """``batched_art_rollout_terrain`` wants one field per env; the substep
    kernel's wrapper, which steps a field per env, refuses a shared one."""
    _, (tm, tg, tw, tb) = _walk_setup(2)
    for bad in (tcontact.Terrain.flat(device="cpu"), tcontact.Terrain.flat(n=3, device="cpu")):
        with pytest.raises(ValueError, match="env axis"):
            tra.batched_art_rollout_terrain(tw, tb, bad, 1, tm, tg)
    shared = tcontact.Terrain.flat(device="cpu")
    Minv = teng.mass_matrix_inv(TM, tw.sim.q)
    with pytest.raises(ValueError, match="shared field"):
        substep_kernel.fused_substeps(TM, tw.sim, torch.zeros(2, 10), Minv, 0.005, 5,
                                      terrain=shared)


def test_rough_batch_statistics():
    """Shape, device, seeded repeatability, and the smoothed amplitude
    within 10 % of the JAX field's; no comparison of draws."""
    n, res, amp = 8, 64, 0.03
    a = tcontact.Terrain.rough_batch(torch.Generator().manual_seed(5), n, amplitude=amp,
                                     res=res, device="cpu")
    b = tcontact.Terrain.rough_batch(torch.Generator().manual_seed(5), n, amplitude=amp,
                                     res=res, device="cpu")
    c = tcontact.Terrain.rough_batch(torch.Generator().manual_seed(6), n, amplitude=amp,
                                     res=res, device="cpu")
    assert a.heights.shape == (n, res, res) and a.heights.dtype == torch.float32
    assert a.heights.device.type == "cpu" and a.extent == 8.0 and a.batched
    assert torch.equal(a.heights, b.heights) and not torch.equal(a.heights, c.heights)
    assert not torch.equal(a.heights[0], a.heights[1])  # independent fields
    jt = jcontact.Terrain.rough_batch(jax.random.PRNGKey(0), n, amplitude=amp, res=res)
    std_j = float(np.asarray(jt.heights).std())
    assert abs(float(a.heights.std()) - std_j) < 0.1 * std_j, (float(a.heights.std()), std_j)
    # the same box filter: interior and zero-padded border cells alike
    j_border = float(np.asarray(jt.heights)[:, 0, :].std())
    assert abs(float(a.heights[:, 0, :].std()) - j_border) < 0.2 * j_border
    one = tcontact.Terrain.rough(torch.Generator().manual_seed(5), amplitude=amp, res=res,
                                 smooth=1, device="cpu")
    assert one.heights.shape == (res, res) and not one.batched
    assert abs(float(one.heights.std()) - amp / 3) < 0.1 * amp / 3  # 3 x 3 box of unit normals


def test_box_filter_is_the_zero_padded_mean():
    """``rough`` smooths with the (2 smooth + 1)² box, zero padding, as
    ``convolve2d(mode="same")`` does: checked against a direct sum."""
    gen = torch.Generator().manual_seed(2)
    raw = torch.randn((1, 9, 9), generator=torch.Generator().manual_seed(2))
    got = tcontact.Terrain.rough(gen, amplitude=1.0, res=9, smooth=2, device="cpu").heights
    pad = torch.zeros(13, 13)
    pad[2:11, 2:11] = raw[0]
    want = torch.stack([torch.stack([pad[i:i + 5, j:j + 5].sum() / 25 for j in range(9)])
                        for i in range(9)])
    assert torch.allclose(got, want, atol=1e-6)


def test_convert_terrain_round_trip():
    jt, tt = _terrains(True, seed=15)
    back = to_numpy(tt)
    fields = _fields(jt)
    np.testing.assert_array_equal(back["heights"], fields["heights"])
    np.testing.assert_array_equal(back["extent"], fields["extent"])  # (N,) again
    shared = to_numpy(_terrains(False)[1])
    assert shared["extent"] == EXTENT and isinstance(shared["extent"], float)
    with pytest.raises(ValueError, match="missing"):
        from_numpy(tcontact.Terrain, {"heights": fields["heights"]})
    with pytest.raises(ValueError, match="extra"):
        from_numpy(tcontact.Terrain, dict(fields, slope=1.0))
    uneven = dict(fields, extent=np.arange(N, dtype=np.float32) + 1.0)
    with pytest.raises(ValueError, match="differs between envs"):
        from_numpy(tcontact.Terrain, uneven)

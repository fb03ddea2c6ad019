"""The torch port's articulated engine against the JAX package: the model,
spatial algebra, dynamics (generic and leg-vectorized), flat-ground
contact, and the engine's feedback and substeps (height fields:
``tests/test_torch_terrain.py``).

Inputs are perturbed near-standing states with the soles pushed into the
plane, made with numpy from a seed (``_perturbed`` mirrors
``tests/test_substep_kernel.py::_perturbed_states``).

Tolerances (f32 roundoff; the two packages sum in different orders):
- model constants: exact;
- kinematics, feedback, contact points: 1e-5 absolute (measured ~4e-7);
- M, bias, qdd: 1e-4 relative to the largest entry (measured ~1e-7
  relative), Minv 1e-4 relative (Newton-Schulz, measured 2e-7);
- one substep: the bounds of ``tests/test_substep_kernel.py:73-76`` (pos
  5e-7, quat 1e-6, v_base 5e-6, q 1e-6, qd 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.models import biped as jbiped
from biped_mpc_py_tpu.sim import contact as jcontact
from biped_mpc_py_tpu.sim import dynamics as jdyn
from biped_mpc_py_tpu.sim import engine as jeng
from biped_mpc_py_tpu.sim import model as jmodel
from biped_mpc_py_tpu.sim import spatial as jspatial
from biped_mpc_py_torch.models import biped as tbiped
from biped_mpc_py_torch.sim import contact as tcontact
from biped_mpc_py_torch.sim import dynamics as tdyn
from biped_mpc_py_torch.sim import engine as teng
from biped_mpc_py_torch.sim import model as tmodel
from biped_mpc_py_torch.sim import spatial as tspatial
from biped_mpc_py_torch.utils.convert import from_numpy
from torch_threads import one_torch_thread  # noqa: F401

SUBSTEP_BOUNDS = {"pos": 5e-7, "quat": 1e-6, "v_base": 5e-6, "q": 1e-6, "qd": 1e-4}
JM, TM = jmodel.hector_model(), tmodel.hector_model(device="cpu")


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _perturbed(n, seed):
    """(JAX ArtState, port ArtState, tau (N,10) numpy): near-standing
    states with feet in contact, and random torques."""
    rng = np.random.default_rng(seed)
    base = jeng.ArtState.standing()
    pos = np.asarray(base.pos) + 0.02 * rng.normal(size=(n, 3))
    pos[:, 2] -= 0.03  # push the soles into the plane
    quat = np.asarray(base.quat) + 0.02 * rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    f32 = np.float32
    js = jeng.ArtState(
        pos=jnp.asarray(pos, f32), quat=jnp.asarray(quat, f32),
        v_base=jnp.asarray(0.3 * rng.normal(size=(n, 6)), f32),
        q=jnp.asarray(np.asarray(base.q) + 0.05 * rng.normal(size=(n, 10)), f32),
        qd=jnp.asarray(0.5 * rng.normal(size=(n, 10)), f32),
        t=jnp.zeros(n, f32),
    )
    tau = (5.0 * rng.normal(size=(n, 10))).astype(f32)
    return js, from_numpy(teng.ArtState, _fields(js)), tau


def _close(port, ref, atol=0.0, rel=0.0, name=""):
    port = np.asarray(port.detach().cpu().numpy() if torch.is_tensor(port) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    tol = atol + rel * float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("leg", ["fk", "jac"])
def test_model_constants_exact(leg):
    """hector_model of the port equals the JAX one field by field, for the
    default geometry and for the Jacobian preset."""
    jgeom = jbiped.HECTOR_LEG_FK if leg == "fk" else jbiped.HECTOR_LEG_JAC
    tgeom = tbiped.HECTOR_LEG_FK if leg == "fk" else tbiped.HECTOR_LEG_JAC
    jm = jmodel.hector_model(jbiped.BipedParams(leg=jgeom))
    tm = tmodel.hector_model(tbiped.BipedParams(leg=tgeom), device="cpu")
    for f in dataclasses.fields(jm):
        j, t = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f.name)
            assert t.dtype == torch.float32, f.name
        else:
            assert t == j and isinstance(t, float), (f.name, t, j)
    assert tmodel.PARENT.tolist() == jmodel.PARENT.tolist()
    np.testing.assert_array_equal(tmodel.JOINT_AXES, jmodel.JOINT_AXES)
    assert tmodel.FOOT_BODIES == jmodel.FOOT_BODIES


def test_spatial_algebra():
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(8, 3, 3)))[0].astype(np.float32)
    p, v, f = (rng.normal(size=(8, k)).astype(np.float32) for k in (3, 6, 6))
    I = rng.normal(size=(8, 6, 6)).astype(np.float32)
    JX, TX = jspatial.SpatialTransform(R, p), tspatial.SpatialTransform(
        torch.tensor(R), torch.tensor(p))
    tv, tf = torch.tensor(v), torch.tensor(f)
    for name in ("xform_motion", "xform_force", "xform_motion_inv", "xform_force_inv"):
        _close(getattr(tspatial, name)(TX, tv if "motion" in name else tf),
               getattr(jspatial, name)(JX, v if "motion" in name else f), 1e-5, name=name)
    _close(tspatial.crm(tv, tf), jspatial.crm(v, f), 1e-5, name="crm")
    _close(tspatial.crf(tv, tf), jspatial.crf(v, f), 1e-5, name="crf")
    _close(tspatial.xform_inertia(TX, torch.tensor(I)), jspatial.xform_inertia(JX, I),
           rel=1e-5, name="xform_inertia")
    c = tspatial.xform_compose(TX, TX)
    jc = jspatial.xform_compose(JX, JX)
    _close(c.R, jc.R, 1e-5, name="compose.R")
    _close(c.p, jc.p, 1e-5, name="compose.p")
    _close(tspatial.spatial_inertia(TM.mass, TM.com, TM.inertia),
           jspatial.spatial_inertia(JM.mass, JM.com, JM.inertia), 1e-6, name="I6")


def _jax_f_ext(rng, n):
    return (0.5 * rng.normal(size=(n, 2, 5, 6))).astype(np.float32)


def test_kinematics_and_fk():
    js, ts, _ = _perturbed(64, 1)
    out_j = jax.jit(jax.vmap(lambda s: jdyn.leg_kinematics_lv(JM, s.pos, s.quat, s.q, s.v_base, s.qd)))(js)
    out_t = tdyn.leg_kinematics_lv(TM, ts.pos, ts.quat, ts.q, ts.v_base, ts.qd)
    for name, a, b in zip(("R_w", "p_w", "v", "R0"), out_t, out_j):
        _close(a, b, 1e-5, name=name)
    Rj, pj = jax.jit(jax.vmap(lambda s: jdyn.forward_kinematics(JM, s.pos, s.quat, s.q)))(js)
    Rt, pt = tdyn.forward_kinematics(TM, ts.pos, ts.quat, ts.q)
    for i in range(tmodel.N_BODIES):
        _close(Rt[i], Rj[i], 1e-5, name=f"R_wb[{i}]")
        _close(pt[i], pj[i], 1e-5, name=f"p_w[{i}]")
    # the generic walk and the leg-vectorized form agree on the leg bodies
    for leg, bodies in enumerate((tmodel.LEFT, tmodel.RIGHT)):
        for l, b in enumerate(bodies):
            _close(pt[b], out_t[1][:, leg, l], 1e-6, name=f"generic vs lv {b}")


def test_rnea_crba_forward_dynamics():
    n = 32
    js, ts, tau = _perturbed(n, 2)
    rng = np.random.default_rng(3)
    fl = _jax_f_ext(rng, n)
    fb = (0.5 * rng.normal(size=(n, 6))).astype(np.float32)
    R = jax.jit(jax.vmap(lambda q: jdyn.quat_to_rotm(q)))(js.quat)
    Rt = torch.tensor(np.asarray(R))
    bias_j = jax.jit(jax.vmap(lambda s, R, fl, fb: jdyn.rnea_bias_lv(JM, s.q, s.qd, s.v_base, R, fl, fb)))(
        js, R, fl, fb)
    bias_t = tdyn.rnea_bias_lv(TM, ts.q, ts.qd, ts.v_base, Rt, torch.tensor(fl), torch.tensor(fb))
    _close(bias_t, bias_j, rel=1e-4, name="rnea_bias_lv")
    # generic form: the same forces as a list of 11 body wrenches
    f_list = [fb] + [fl[:, leg, l] for leg in range(2) for l in range(5)]
    bias_gj = jax.jit(jax.vmap(lambda s, R, *f: jdyn.rnea_bias(JM, s.q, s.qd, s.v_base, R, list(f))))(
        js, R, *f_list)
    bias_gt = tdyn.rnea_bias(TM, ts.q, ts.qd, ts.v_base, Rt, [torch.tensor(f) for f in f_list])
    _close(bias_gt, bias_gj, rel=1e-4, name="rnea_bias")
    _close(bias_gt, bias_t.numpy(), rel=1e-5, name="rnea generic vs lv")

    M_j = jax.jit(jax.vmap(lambda q: jdyn.crba_mass_matrix_lv(JM, q)))(js.q)
    M_t = tdyn.crba_mass_matrix_lv(TM, ts.q)
    _close(M_t, M_j, rel=1e-4, name="crba_lv")
    _close(tdyn.crba_mass_matrix(TM, ts.q), jax.jit(jax.vmap(lambda q: jdyn.crba_mass_matrix(JM, q)))(js.q),
           rel=1e-4, name="crba")
    _close(tdyn.crba_mass_matrix(TM, ts.q), M_t.numpy(), rel=1e-6, name="crba generic vs lv")

    qdd_j = jax.jit(jax.vmap(lambda s, t, fl, fb: jdyn.forward_dynamics_lv(
        JM, s.pos, s.quat, s.q, s.v_base, s.qd, t, fl, fb)))(js, tau, fl, fb)
    qdd_t = tdyn.forward_dynamics_lv(TM, ts.pos, ts.quat, ts.q, ts.v_base, ts.qd,
                                     torch.tensor(tau), torch.tensor(fl), torch.tensor(fb))
    _close(qdd_t, qdd_j, rel=1e-4, name="forward_dynamics_lv")
    qdd_gj = jax.jit(jax.vmap(lambda s, t, *f: jdyn.forward_dynamics(
        JM, s.pos, s.quat, s.q, s.v_base, s.qd, t, list(f))))(js, tau, *f_list)
    qdd_gt = tdyn.forward_dynamics(TM, ts.pos, ts.quat, ts.q, ts.v_base, ts.qd,
                                   torch.tensor(tau), [torch.tensor(f) for f in f_list])
    _close(qdd_gt, qdd_gj, rel=1e-4, name="forward_dynamics")
    Minv_j = jax.jit(jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q)))(js.q)
    Minv_t = teng.mass_matrix_inv(TM, ts.q)
    _close(Minv_t, Minv_j, rel=1e-4, name="mass_matrix_inv")
    qdd_h = tdyn.forward_dynamics_lv(TM, ts.pos, ts.quat, ts.q, ts.v_base, ts.qd,
                                     torch.tensor(tau), torch.tensor(fl), torch.tensor(fb),
                                     Minv=Minv_t)
    _close(qdd_h, qdd_j, rel=1e-3, name="forward_dynamics_lv with held Minv")


def test_contact_force_world():
    rng = np.random.default_rng(4)
    p = (rng.normal(size=(256, 3)) * [0.1, 0.1, 0.01]).astype(np.float32)  # half below z=0
    v = rng.normal(size=(256, 3)).astype(np.float32)
    f_j = jcontact.contact_force_world(JM, p, v)
    f_t = tcontact.contact_force_world(TM, torch.tensor(p), torch.tensor(v))
    _close(f_t, f_j, rel=1e-5, name="contact")
    assert float(f_t[torch.tensor(p[:, 2]) > 0].abs().max()) == 0.0


def test_engine_feedback():
    js, ts, _ = _perturbed(64, 5)
    x_j, pf_j = jax.vmap(lambda s: jeng.feedback_and_soles(JM, s))(js)
    x_t, pf_t = teng.feedback_and_soles(TM, ts)
    _close(x_t, x_j, 1e-5, name="x_fb")
    _close(pf_t, pf_j, 1e-5, name="soles")
    _close(teng.sole_positions(TM, ts), pf_j, 1e-5, name="sole_positions")
    _close(teng.com_feedback_state(TM, ts), x_j, 1e-5, name="com_feedback_state")
    _close(ts.torso_state(), jax.vmap(lambda s: s.torso_state())(js), 1e-5, name="torso_state")
    pts_j, vel_j, bodies_j, _ = jax.vmap(lambda s: jeng.contact_point_states(JM, s))(js)
    pts_t, vel_t, bodies_t, _ = teng.contact_point_states(TM, ts)
    _close(pts_t, pts_j, 1e-5, name="contact points")
    _close(vel_t, vel_j, 1e-5, name="contact point velocities")
    assert list(bodies_t) == [int(np.asarray(b)[0]) for b in bodies_j]
    st = teng.ArtState.standing(3, z0=0.53)
    _close(st.q, np.broadcast_to(np.asarray(jeng.ArtState.standing().q), (3, 10)), 0.0, name="standing")


@pytest.mark.parametrize("held", [True, False])
def test_art_substep(held):
    js, ts, tau = _perturbed(64, 6)
    Minv = jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q))(js.q)
    kw_j = {"Minv": Minv} if held else {}
    kw_t = {"Minv": torch.tensor(np.asarray(Minv))} if held else {}
    out_j = jax.jit(jax.vmap(lambda s, t, k: jeng.art_substep(JM, s, t, 0.001, **k)))(js, tau, kw_j)
    out_t = teng.art_substep(TM, ts, torch.tensor(tau), 0.001, **kw_t)
    for name, tol in SUBSTEP_BOUNDS.items():
        _close(getattr(out_t, name), getattr(out_j, name), tol, name=name)
    np.testing.assert_array_equal(out_t.t.numpy(), np.asarray(out_j.t))


@pytest.mark.parametrize("m_refresh", [1, 2])
def test_art_step(m_refresh):
    """A 5 ms period of 4 substeps, factorized per substep or refreshed
    every 2: the substep bounds, compounded over 4 substeps (x4)."""
    js, ts, tau = _perturbed(16, 7)
    out_j = jax.jit(jax.vmap(lambda s, t: jeng.art_step(JM, s, t, 0.005, 4, m_refresh=m_refresh)))(
        js, tau)
    out_t = teng.art_step(TM, ts, torch.tensor(tau), 0.005, 4, m_refresh=m_refresh)
    for name, tol in SUBSTEP_BOUNDS.items():
        _close(getattr(out_t, name), getattr(out_j, name), 4 * tol, name=name)

"""Torch port vs JAX package: QP assembly (condense), Ruiz equilibration and
the Newton-Schulz KKT inverse, on 8 envs of perturbed standing states (the
``tests/test_qp_kernel.py::_scaled_mpc_batch`` workload).

Tolerances: the condensed matrices and the scalings rtol 1e-5 (f32
roundoff relative to each entry's magnitude; an atol of 1e-5 of the largest
entry covers entries that cancel to ~0). The NS inverse is held to the JAX
inverse's own residual floor: ||K X - I||_max of the port within 2x that of
JAX on the same K (both are f32 iterations that stall at roundoff).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control.gait import contact_sequence as j_contact
from biped_mpc_py_tpu.control.mpc import build_mpc_qp as j_build
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.parallel.rollout import randomize_params as j_randomize
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control.gait import contact_sequence as t_contact
from biped_mpc_py_torch.control.mpc import build_mpc_qp as t_build
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.utils.convert import from_numpy

N_ENVS = 8


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


# (MpcConfig overrides, per-env randomized robots, foot-frame headings)
CASES = {
    "default": ({}, False, False),
    "randomized_robots": ({}, True, False),
    "torsional_cone": ({"mu_z": 0.035, "tau_z_max": 4.0}, True, False),
    "reference_compat": ({"compat": True}, False, False),
    "foot_frame": ({"foot_frame_wrench": True}, False, True),
}


@functools.lru_cache(maxsize=None)
def qp_batch(name, n=N_ENVS, seed=0):
    """The same QP batch built by both packages -> (jax CondensedQp,
    torch CondensedQp, jax MpcConfig, torch MpcConfig). Cached: callers
    only read the batches."""
    over, randomized, headings = CASES[name]
    over = dict(over)
    make = jcfg.reference_compat_config if over.pop("compat", False) else jcfg.default_mpc_config
    jm, jg = make(**over), jcfg.GaitConfig()
    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    tg = tcfg.GaitConfig()
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(n, 12)) * 0.05
          + np.array([0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0, 0, 0])).astype(np.float32)
    foot = np.tile(np.array([-0.02, 0.09, 0, -0.02, -0.09, 0], np.float32), (n, 1))
    # several gait phases across the batch
    t = (np.arange(n) * 0.04).astype(np.float32)
    foot_yaw = (rng.normal(size=(n, 2)) * 0.2).astype(np.float32) if headings else None
    if randomized:
        jb = j_randomize(jax.random.PRNGKey(seed), n)
    else:
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), JBipedParams())

    def one(x, ti, f, b, fy):
        c = j_contact(ti, jm, jg)
        return j_build(x, ti, f, jm, b, c, jg, foot_yaw=fy)

    jq = jax.jit(jax.vmap(one))(
        jnp.asarray(xs), jnp.asarray(t), jnp.asarray(foot), jb,
        None if foot_yaw is None else jnp.asarray(foot_yaw),
    )
    tb = from_numpy(BipedParams, _fields(jb))
    t_t = torch.from_numpy(t)
    tq = t_build(
        torch.from_numpy(xs), t_t, torch.from_numpy(foot), tm, tb,
        t_contact(t_t, tm, tg), tg,
        foot_yaw=None if foot_yaw is None else torch.from_numpy(foot_yaw),
    )
    return jq, tq, jm, tm


def _close_rel(t_val, j_val, rtol=1e-5):
    j = np.asarray(j_val)
    atol = 1e-5 * max(np.abs(j).max(), 1e-30)
    np.testing.assert_allclose(t_val.numpy(), j, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_condense_matches_jax(name):
    jq, tq, jm, _ = qp_batch(name)
    m = jqp.m_step(jm)
    assert tq.A_step.shape == (N_ENVS, m, 12) and tq.l.shape == (N_ENVS, jm.h, m)
    for f in ("P", "q", "A_step", "Sx", "Su", "x0"):
        _close_rel(getattr(tq, f), getattr(jq, f))
    # bounds hold +-1e20 sentinels: compare exactly
    np.testing.assert_array_equal(tq.l.numpy(), np.asarray(jq.l))
    np.testing.assert_array_equal(tq.u.numpy(), np.asarray(jq.u))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ruiz_matches_jax(name):
    jq, tq, jm, tm = qp_batch(name)
    out_j = jax.jit(jax.vmap(lambda q: jqp.ruiz_equilibrate(q, jm.ruiz_iters)))(jq)
    out_t = tqp.ruiz_equilibrate(tq, tm.ruiz_iters)
    for label, a, b in zip(("Ph", "qh", "Ah", "lh", "uh", "D", "E", "c"), out_t, out_j):
        assert np.isfinite(a.numpy()).all(), label
        _close_rel(a, b)


def test_ns_inverse_at_jax_floor():
    """The KKT matrices of a first ADMM phase (rho 0.3, equality rows
    x1e3), at the default 14 steps and the bench's 10."""
    jq, tq, jm, tm = qp_batch("randomized_robots")
    Ph, qh, Ah, lh, uh, *_ = tqp.ruiz_equilibrate(tq, tm.ruiz_iters)
    rho = torch.where((uh - lh) < 1e-6, 0.3 * 1e3, 0.3)
    AtRA = torch.einsum("nkji,nkj,nkjl->nkil", Ah, rho, Ah)
    K = Ph + 1e-6 * torch.eye(120)
    for k in range(10):
        K[:, 12 * k:12 * k + 12, 12 * k:12 * k + 12] += AtRA[:, k]
    K_np = K.numpy()
    eye = np.eye(120)
    for iters in (14, 10):
        X_j = np.asarray(jax.jit(jax.vmap(lambda k: jqp.ns_inverse(k, iters)))(jnp.asarray(K_np)))
        X_t = tqp.ns_inverse(K, iters).numpy()
        res_j = np.abs(K_np.astype(np.float64) @ X_j - eye).max(axis=(1, 2))
        res_t = np.abs(K_np.astype(np.float64) @ X_t - eye).max(axis=(1, 2))
        assert np.all(res_t <= 2 * res_j + 1e-6), (iters, res_t, res_j)


def test_scale_qp_on_the_cpu_is_the_plain_version():
    """``scale_qp`` (the stage ``qp.ruiz`` of ``solve_qp``) runs
    ``ruiz_equilibrate`` and ``scaled_warm_start`` on CPU tensors, bit for
    bit, cold and warm; the Ruiz kernel's wrapper refuses CPU tensors
    before it loads anything."""
    from biped_mpc_py_torch.ops.cuda import ruiz_kernel

    _, tq, _, tm = qp_batch("randomized_robots")
    gen = torch.Generator().manual_seed(0)
    h, m = tq.l.shape[1:]
    warm = tqp.QpSolution(*(torch.randn((N_ENVS,) + s, generator=gen)
                            for s in ((h, 12), (h, 13), (h, m), (h, m), (), ())))
    for w in (None, warm):
        want = tqp.ruiz_equilibrate(tq, tm.ruiz_iters, tm.ruiz_bf16_norms)
        want = want + tqp.scaled_warm_start(w, *want[5:], want[0].shape[-1])
        got = tqp.scale_qp(tq, tm, w)
        assert len(got) == 11 and all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="on the card"):
        ruiz_kernel.fused_ruiz(tq.P, tq.q, tq.A_step, tq.l, tq.u, n_iters=10, bf16_norms=False)
    assert ruiz_kernel._lib is None

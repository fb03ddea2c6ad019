"""The JAX package's three bf16 solver knobs in the torch port, against the
JAX package run as it runs them (``fast_mpc_config()``: 8 of 10
Newton-Schulz steps with bf16 operands, the ADMM steps' K^-1 product from
bf16 operands, the Ruiz norms of |P| in bf16), on the CPU.

(a) ``ns_inverse(K, 10, bf16_iters)`` on real MPC KKT matrices (the one of
    ``tests/test_qp.py::test_ns_inverse_bf16_hybrid`` and a randomized
    robot's) against JAX's: X within 1e-4 of its largest entry with an f32
    tail (measured 1.4e-5), within 1e-2 when every step is bf16 (a bf16
    step is 2^-8 of an entry: the rounding of one entry flips on an f32
    last bit; measured 5e-3); ||I - K X|| within 1.1x of JAX's, and under
    the JAX test's 2e-2 with an f32 tail (JAX's own all-bf16 NS(10) lands
    at 2.02e-2 on the first K). ``bf16_iters=0`` repeats the f32 iteration
    bit for bit.
(b) ``ruiz_equilibrate(bf16_norms=True)`` against JAX's on the same
    condensed QPs: every output within 2e-6 relative. Not bit-equal: the f32
    path is not either (XLA's CPU division and mean round otherwise, up to
    10 ulp); the bf16 roundings (to nearest even in both) add nothing to
    that (at most 9 ulp measured).
(c) ``solve_qp`` at the port's ``fast_mpc_config()`` against JAX
    ``solve_qp_batch(backend="xla")`` at JAX's, 8 randomized-robot QPs, cold
    and warm. With 2 ADMM steps: ``test_torch_qp_kernel.py``'s bench
    tolerances (controls 0.1 N, states 2e-2, res_prim 5e-3), where the
    knobs move the controls ~2 N. With the full 40 steps the bf16 K^-1
    product makes the solve discontinuous in roundoff: every step rounds its
    right-hand side to bf16, and a last-bit difference that flips one
    rounding moves the next iterate by a bf16 step, which the steps carry
    on, so two implementations land apart (port against JAX: median env
    ~0.1 N, the worst a few N). There each env must lie nearer to JAX's
    knobs-on solve than half its distance to JAX's knobs-off one (the
    knobs' effect: 12-35 N an env), and the median env within 1 N.
(d) ``batched_rollout`` at knobs-on against JAX's ``batched_rollout_fn`` at
    knobs-on, 4 randomized robots x 20 ticks. Pointwise states decohere
    from the first tick at knobs-on for the reason of (c) (x_fb 6.5e-3
    apart after one tick, 0.12 after 20, as far as the port's knobs-off run
    is from JAX's knobs-on one), so the walk is held to the bounds of the
    JAX package's ``tests/test_rollout.py::test_bench_budget_accuracy``
    against JAX's walk: zero falls, the same clock and step counts, each
    env's distance within 0.15 m and height within 0.02 m, attitude and
    velocity RMS within 1.2x + 1e-3 / 5e-3, res_prim under 1.0.
(e) A CPU emulation of the CUDA kernel's hybrid (the first 8 steps one
    bf16 m16n8k16 product per tile, accumulated in f32 with the tensor
    cores' truncation at each k-step of 16; the last 2 in 3xTF32 with
    lo*lo: ``tests/test_torch_qp_tf32.py::kernel_ns_inverse``) reaches
    JAX's hybrid's ||I - K X|| band (under 2e-2, within 1.5x of JAX's) on
    (a)'s matrices, and its solve at the bench budget with the bf16 NS
    steps (the K^-1 product in f32) stays within the kernel's bound of
    0.05 N of the plain version.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.parallel import rollout as jroll
from biped_mpc_py_tpu.utils.precision import f32_precision
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.ops.cuda import qp_kernel as tk
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.utils import roofline
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from tests.test_torch_cuda import _mpc_qps
from tests.test_torch_qp import _fields, qp_batch
from tests.test_torch_qp_tf32 import BOUND_CONTROLS, kernel_ns_inverse
from tests.test_torch_rollout import X_CMD, _start
from torch_threads import one_torch_thread  # noqa: F401

OFF = dict(kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False)
N_QPS = 8


def _phase1_kkt(Ph, Ah, lh, uh):
    """K = Ph + 1e-6 I + blkdiag(A_k' rho_k A_k) at rho 0.3 (x1e3 on the
    equality rows), numpy, as tests/test_qp.py:275-281 forms it."""
    Ph, Ah, lh, uh = (np.asarray(a, np.float32) for a in (Ph, Ah, lh, uh))
    rho = np.where((uh - lh) < 1e-6, 0.3e3, 0.3).astype(np.float32)
    K = Ph + np.float32(1e-6) * np.eye(120, dtype=np.float32)
    for k in range(10):
        K[12 * k:12 * k + 12, 12 * k:12 * k + 12] += np.einsum(
            "ji,j,jl->il", Ah[k], rho[k], Ah[k])
    return K


@functools.cache
def kkt(case):
    """A real MPC KKT matrix, built by the JAX package: "golden" is the one
    of tests/test_qp.py::test_ns_inverse_bf16_hybrid (a walking state at
    t = 0.48 s), "randomized" the first env of a randomized-robot batch."""
    if case == "golden":
        from biped_mpc_py_tpu.control.gait import contact_sequence
        from biped_mpc_py_tpu.control.reference import com_reference, foot_reference
        from biped_mpc_py_tpu.models.srb import linearize_horizon

        mpc, biped, gait = jcfg.MpcConfig(), JBipedParams(), jcfg.GaitConfig()

        @jax.jit
        def scaled(x_fb, t, foot):
            contact = contact_sequence(t, mpc, gait)
            x_ref = com_reference(x_fb, mpc)
            A, B = linearize_horizon(mpc, biped, x_ref,
                                     foot_reference(x_fb, t, foot, mpc, contact, gait))
            return jqp.ruiz_equilibrate(jqp.condense(mpc, biped, x_fb, x_ref, A, B, contact))

        Ph, _, Ah, lh, uh, *_ = scaled(
            jnp.asarray([0.02, -0.01, 0.1, 0.05, 0.02, 0.54, 0.1, 0.0, 0.2, 0.25, 0.05, 0.0],
                        jnp.float32),
            jnp.asarray(0.48), jnp.asarray([0.03, 0.09, 0.0, 0.06, -0.09, 0.0], jnp.float32))
        return _phase1_kkt(Ph, Ah, lh, uh)
    jq, *_ = qp_batch("randomized_robots")
    Ph, _, Ah, lh, uh, *_ = jax.jit(jax.vmap(lambda q: jqp.ruiz_equilibrate(q, 10, True)))(jq)
    return _phase1_kkt(Ph[0], Ah[0], lh[0], uh[0])


def _residual(K, X):
    return float(np.abs(np.eye(K.shape[0]) - K.astype(np.float64) @ X).max())


def _ns_inverse_f32(K, n_iters):
    """The f32 Newton-Schulz iteration as the port ran it before the bf16
    knob (every step ``X (2I - Khat X)`` in f32)."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype)
    s = torch.rsqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30))
    Khat = K * s[..., :, None] * s[..., None, :]
    X = eye / torch.amax(torch.sum(torch.abs(Khat), dim=-1), dim=-1)[..., None, None]
    for _ in range(n_iters):
        X = X @ (2.0 * eye - Khat @ X)
    return X * s[..., :, None] * s[..., None, :]


@pytest.mark.parametrize("bf16_iters", [8, 10])
@pytest.mark.parametrize("case", ["golden", "randomized"])
def test_ns_inverse_bf16_matches_jax(case, bf16_iters):
    K = kkt(case)
    X_j = np.asarray(jax.jit(lambda k: jqp.ns_inverse(k, 10, bf16_iters))(jnp.asarray(K)))
    X_t = tqp.ns_inverse(torch.from_numpy(K), 10, bf16_iters).numpy()
    tol = 1e-4 if bf16_iters < 10 else 1e-2
    assert np.abs(X_t - X_j).max() <= tol * np.abs(X_j).max()
    r_t, r_j = _residual(K, X_t), _residual(K, X_j)
    assert r_t <= 1.1 * r_j, (r_t, r_j)
    if bf16_iters < 10:
        assert r_t < 2e-2, r_t
    assert torch.equal(tqp.ns_inverse(torch.from_numpy(K), 10, 0),
                       _ns_inverse_f32(torch.from_numpy(K), 10))


def test_mm_bf16_rounds_operands_to_nearest_even():
    one = 1.0 + 2.0 ** -8  # halfway between two bf16 values: ties to even, 1.0
    a = torch.tensor([[one, 3.0 + 2.0 ** -7]])  # halfway again: ties to even, 3.0
    b = torch.tensor([[1.0], [1.0]])
    assert float(tqp.mm_bf16(a, b)) == 1.0 + 3.0
    assert tqp.mm_bf16(a, b).dtype == torch.float32


@pytest.mark.parametrize("bf16_norms", [False, True])
def test_ruiz_bf16_norms_matches_jax(bf16_norms):
    jq, *_ = qp_batch("randomized_robots")
    tq = from_numpy(tqp.CondensedQp, _fields(jq))  # the same inputs on both sides
    out_j = jax.jit(jax.vmap(lambda q: jqp.ruiz_equilibrate(q, 10, bf16_norms)))(jq)
    out_t = tqp.ruiz_equilibrate(tq, 10, bf16_norms)
    for label, a, b in zip(("Ph", "qh", "Ah", "lh", "uh", "D", "E", "c"), out_t, out_j):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all(), label
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-6, atol=1e-30, err_msg=label)
    f32 = tqp.ruiz_equilibrate(tq, 10)
    D, D_f32 = out_t[5], f32[5]
    assert torch.equal(D, D_f32) != bf16_norms  # the knob moves the scaling, and only it


def _solve_pair(budget, warm):
    """(port solution, JAX knobs-on solution, JAX knobs-off solution) of 8
    randomized-robot QPs at the bench budget as the JAX bench runs it
    (``budget`` "admm2": 2 ADMM steps)."""
    jq, tq, *_ = qp_batch("randomized_robots")
    jm = jcfg.fast_mpc_config()
    if budget == "admm2":
        jm = dataclasses.replace(jm, n_admm_iters=2)
    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    assert (tm.kinv_bf16_iters, tm.admm_bf16_matvec, tm.ruiz_bf16_norms) == (8, True, True)
    j_warm = t_warm = None
    if warm:
        jq_prev, *_ = qp_batch("randomized_robots", seed=5)
        j_warm = jqp.solve_qp_batch(jq_prev, jm, backend="xla")
        t_warm = from_numpy(tqp.QpSolution, _fields(j_warm))
    sol_t = tqp.solve_qp(tq, tm, warm=t_warm)
    sol_j = jqp.solve_qp_batch(jq, jm, warm=j_warm, backend="xla")
    sol_off = jqp.solve_qp_batch(jq, dataclasses.replace(jm, **OFF), warm=j_warm, backend="xla")
    return sol_t, sol_j, sol_off


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("budget", ["admm2", "bench"])
def test_solve_qp_bf16_knobs_match_jax(budget, warm):
    sol_t, sol_j, sol_off = _solve_pair(budget, warm)
    u_t, u_j = sol_t.controls.numpy(), np.asarray(sol_j.controls)
    du = np.abs(u_t - u_j).reshape(N_QPS, -1).max(1)
    effect = np.abs(np.asarray(sol_off.controls) - u_j).reshape(N_QPS, -1).max(1)
    assert np.isfinite(u_t).all() and np.isfinite(sol_t.res_dual.numpy()).all()
    if budget == "admm2":
        assert effect.min() > 1.0, effect  # the knobs' effect, far past the tolerance
        np.testing.assert_allclose(u_t, u_j, atol=0.1, rtol=0)
        np.testing.assert_allclose(sol_t.states.numpy(), np.asarray(sol_j.states), atol=2e-2,
                                   rtol=0)
        np.testing.assert_allclose(sol_t.res_prim.numpy(), np.asarray(sol_j.res_prim),
                                   atol=5e-3, rtol=0)
        return
    assert np.all(du < 0.5 * effect), (du, effect)
    assert np.median(du) < 1.0, du


@functools.cache
def _jax_walk(n, ticks):
    jm = jcfg.fast_mpc_config(x_cmd=jnp.asarray(X_CMD))
    jw, jb = _start(jm, n, True)
    out = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, jm, jcfg.GaitConfig())))(jw, jb)
    return jm, jw, jb, _fields(out)


def _walk_stats(tree, ticks):
    x, m = tree["sim"]["x_fb"], tree["metrics"]
    return (x[:, 3], x[:, 4], x[:, 5], np.sqrt(m["attitude_err_sq"] / ticks).mean(),
            np.sqrt(m["vel_err_sq"] / ticks).mean())


def test_rollout_bf16_knobs_walks_as_jax():
    n, ticks = 4, 20
    jm, jw, jb, j = _jax_walk(n, ticks)
    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    assert tm.kinv_bf16_iters == 8 and tm.admm_bf16_matvec and tm.ruiz_bf16_norms
    out_t = troll.batched_rollout(from_numpy(troll.World, _fields(jw)),
                                  from_numpy(BipedParams, _fields(jb)), ticks, tm,
                                  tcfg.GaitConfig())
    t = to_numpy(out_t)
    assert np.isfinite(t["sim"]["x_fb"]).all()
    assert t["metrics"]["falls"].sum() == 0 and j["metrics"]["falls"].sum() == 0
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["metrics"]["n_steps"], j["metrics"]["n_steps"])
    xt, yt, zt, att_t, vel_t = _walk_stats(t, ticks)
    xj, yj, zj, att_j, vel_j = _walk_stats(j, ticks)
    assert np.abs(xt - xj).max() < 0.15 and np.abs(zt - zj).max() < 0.02
    assert np.abs(yt).max() < 0.3
    assert att_t < 1.2 * att_j + 1e-3, (att_t, att_j)
    assert vel_t < 1.2 * vel_j + 5e-3, (vel_t, vel_j)
    assert t["metrics"]["res_prim_max"].max() < 1.0


@pytest.mark.parametrize("case", ["golden", "randomized"])
def test_kernel_hybrid_emulation_reaches_jax_band(case):
    K = kkt(case)
    X_j = np.asarray(jax.jit(lambda k: jqp.ns_inverse(k, 10, 8))(jnp.asarray(K)))
    X_e = kernel_ns_inverse()(torch.from_numpy(K), 10, 8).numpy()
    r_e, r_j = _residual(K, X_e), _residual(K, X_j)
    assert r_e < 2e-2 and r_e <= 1.5 * r_j, (r_e, r_j)


def test_kernel_bf16_ns_solve_within_kernel_bound(monkeypatch):
    """The chip's ``bench-ns`` check on the CPU: the bench budget with the
    bf16 NS steps and Ruiz norms, the K^-1 product in f32."""
    mpc = dataclasses.replace(tcfg.fast_mpc_config(), admm_bf16_matvec=False)
    qp = _mpc_qps(32, "cpu", mpc)
    base = tqp.solve_qp(qp, mpc)
    monkeypatch.setattr(tqp, "ns_inverse", kernel_ns_inverse())
    sol = tqp.solve_qp(qp, mpc)
    assert float((sol.controls - base.controls).abs().max()) < BOUND_CONTROLS


def test_qp_bound_prices_bf16_steps():
    """7 of the 9 product steps at one bf16 pass (989 TFLOP/s): 49.5 GFLOP
    in 0.050 ms, 14.2 GFLOP of 3xTF32 in 0.086 ms, 1.96 GFLOP of f32 in
    0.029 ms; with the knobs off the count and bound stay the f32 ones."""
    kw = tqp.solver_args(tcfg.fast_mpc_config())
    on = roofline.qp_solve_work(1024, 10, 24, **kw)
    off = roofline.qp_solve_work(1024, 10, 24, **{**kw, "bf16_iters": 0})
    assert on["ns_bf16_flops"] == 1024 * 7 * 4 * 120 ** 3
    assert {k: v for k, v in on.items() if k != "ns_bf16_flops"} == {
        k: v for k, v in off.items() if k != "ns_bf16_flops"}
    assert off["ns_bf16_flops"] == 0
    assert roofline.qp_solve_bound_ms(on) == (pytest.approx(0.16512, abs=1e-5), "operations")
    assert roofline.qp_solve_bound_ms(off) == (pytest.approx(0.41530, abs=1e-5), "operations")


@pytest.mark.parametrize("bad", [-1, 2.5])
def test_wrapper_rejects_bad_bf16_iters(bad):
    n = 2
    args = [torch.eye(120).repeat(n, 1, 1), torch.zeros(n, 10, 24, 12), torch.zeros(n, 120),
            -torch.ones(n, 10, 24), torch.ones(n, 10, 24), torch.zeros(n, 120),
            torch.zeros(n, 10, 24), torch.zeros(n, 10, 24)]
    kw = {**tqp.solver_args(tcfg.fast_mpc_config()), "bf16_iters": bad}
    with pytest.raises(ValueError, match="bf16_iters"):
        tk.fused_qp_solve(*args, **kw)

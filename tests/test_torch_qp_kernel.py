"""The fused ADMM QP solve of the torch port.

On the CPU, the wrapper runs its plain PyTorch version, which is held
against (a) the JAX package's Pallas kernel in interpret mode, fed the dense
block-diagonal built from the same scaled blocks, and (b) the JAX
``solve_qp_batch(backend="xla")``, through the port's whole ``solve_qp``
(Ruiz scaling, warm-start mapping, unscaling), at matched f32 precision
(the JAX bf16 knobs off; see docs/DESIGN_NOTES.md:862-867).

Tolerances, taken from tests/test_qp_kernel.py where the two JAX backends
are held to each other: scaled x 2e-2 and z 5e-2 for the single-phase core
(the per-iteration f32 roundoff compounds over the iterations); unscaled
controls 0.1 N, states 2e-2 and res_prim 5e-3 for whole solves (the rho
re-pick divides by f32 residual maxima, so rho trajectories may differ
slightly on marginal envs).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.ops import qp as jqp
from biped_mpc_py_tpu.ops.pallas.qp_kernel import fused_qp_solve as j_fused
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.ops.cuda import qp_kernel as tk
from biped_mpc_py_torch.utils.convert import from_numpy
from tests.test_torch_qp import qp_batch
from torch_threads import one_torch_thread  # noqa: F401

CORE = dict(n_iters=40, n_phases=1, ns_iters=10, polish=False)
FULL = dict(n_iters=60, n_phases=3, ns_iters=14, polish=True)


def _scaled(name="default", n=8, seed=0):
    """A scaled batch from the JAX Ruiz path, as numpy: (Ph, qh, Ah, lh, uh,
    D) with D the variable scaling."""
    jq, _, jm, _ = qp_batch(name, n, seed)
    Ph, qh, Ah, lh, uh, D, *_ = jax.jit(jax.vmap(jqp.ruiz_equilibrate))(jq)
    return [np.array(a) for a in (Ph, qh, Ah, lh, uh, D)]


def _dense(Ah):
    n, h, m, nu = Ah.shape
    out = np.zeros((n, h * m, h * nu), np.float32)
    for k in range(h):
        out[:, k * m:(k + 1) * m, k * nu:(k + 1) * nu] = Ah[:, k]
    return out


@pytest.mark.parametrize(
    "budget", [dict(n_iters=5, n_phases=1, polish=False), CORE, FULL],
    ids=["core5", "core40", "full"],
)
def test_plain_core_matches_pallas_interpret(budget):
    """Scaled iterates for the single-phase core; unscaled controls (D x)
    for the full budget, whose rho re-pick and polish accept can amplify
    roundoff in the scaled space."""
    Ph, qh, Ah, lh, uh, D = _scaled()
    n, h, m, _ = Ah.shape
    x0, z0 = np.zeros((n, 120), np.float32), np.zeros((n, h, m), np.float32)
    kw = dict(rho=0.3, sigma=1e-6, alpha=1.6, ns_iters=budget.get("ns_iters", 14),
              n_iters=budget["n_iters"], n_phases=budget["n_phases"],
              polish=budget["polish"])
    x_j, z_j, y_j = j_fused(
        jnp.asarray(Ph), jnp.asarray(_dense(Ah)), jnp.asarray(qh),
        jnp.asarray(lh.reshape(n, -1)), jnp.asarray(uh.reshape(n, -1)),
        jnp.asarray(x0), jnp.asarray(z0.reshape(n, -1)), jnp.asarray(z0.reshape(n, -1)),
        interpret=True, **kw,
    )
    T = [torch.from_numpy(a) for a in (Ph, Ah, qh, lh, uh, x0, z0, z0.copy())]
    x_t, z_t, y_t = tk.fused_qp_solve_reference(*T, **kw)
    assert x_t.shape == (n, 120) and z_t.shape == (n, h, m)
    if budget["polish"]:
        D = D.reshape(n, -1)
        np.testing.assert_allclose(D * x_t.numpy(), D * np.asarray(x_j), atol=0.1, rtol=0)
        return
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=2e-2, rtol=0)
    np.testing.assert_allclose(z_t.numpy().reshape(n, -1), np.asarray(z_j), atol=5e-2, rtol=0)


def _jax_mpc(jm, budget):
    return dataclasses.replace(
        jm, n_admm_iters=budget["n_iters"], admm_rho_phases=budget["n_phases"],
        kinv_ns_iters=budget["ns_iters"], admm_polish=budget["polish"],
        kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False,
    )


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize(
    "name,budget",
    [("randomized_robots", CORE), ("randomized_robots", FULL), ("torsional_cone", FULL)],
    ids=["core", "full", "cone_full"],
)
def test_solve_qp_matches_jax_xla(name, budget, warm):
    """The port's whole solve_qp vs JAX solve_qp_batch(backend='xla');
    the warm start is the JAX solution of a different batch of states."""
    jq, tq, jm0, _ = qp_batch(name)
    jm = _jax_mpc(jm0, budget)
    from biped_mpc_py_torch import config as tcfg

    tm = from_numpy(tcfg.MpcConfig, dataclasses.asdict(jax.tree.map(np.asarray, jm)))
    j_warm = t_warm = None
    if warm:
        jq_prev, *_ = qp_batch(name, seed=5)
        j_warm = jqp.solve_qp_batch(jq_prev, jm, backend="xla")
        t_warm = from_numpy(tqp.QpSolution, dataclasses.asdict(jax.tree.map(np.asarray, j_warm)))
    sol_j = jqp.solve_qp_batch(jq, jm, warm=j_warm, backend="xla")
    sol_t = tqp.solve_qp(tq, tm, warm=t_warm)
    np.testing.assert_allclose(sol_t.controls.numpy(), np.asarray(sol_j.controls), atol=0.1, rtol=0)
    np.testing.assert_allclose(sol_t.states.numpy(), np.asarray(sol_j.states), atol=2e-2, rtol=0)
    np.testing.assert_allclose(sol_t.res_prim.numpy(), np.asarray(sol_j.res_prim), atol=5e-3, rtol=0)
    assert np.isfinite(sol_t.res_dual.numpy()).all()


def test_launch_count_stays_zero_on_cpu():
    _, tq, _, tm = qp_batch("default", n=2)
    before = tk.fused_qp_solve.launches
    tqp.solve_qp(tq, tm)
    assert tk.fused_qp_solve.launches == before == 0


def _args(n=2, h=10, m=24):
    P = torch.eye(12 * h).repeat(n, 1, 1)
    return [P, torch.zeros(n, h, m, 12), torch.zeros(n, 12 * h), -torch.ones(n, h, m),
            torch.ones(n, h, m), torch.zeros(n, 12 * h), torch.zeros(n, h, m),
            torch.zeros(n, h, m)]


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity", "device", "phases"])
def test_wrapper_rejects_bad_inputs(fault):
    args = _args()
    kw = dict(rho=0.3, sigma=1e-6, alpha=1.6, **CORE)
    if fault == "dtype":
        args[2] = args[2].double()
    elif fault == "shape":
        args[3] = args[3][:, :, :20]
    elif fault == "contiguity":
        args[0] = torch.eye(120).repeat(2, 1, 1).transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "device":
        args[1] = args[1].to("meta")
    else:
        kw["n_phases"] = 0
    with pytest.raises((ValueError, TypeError)):
        tk.fused_qp_solve(*args, **kw)


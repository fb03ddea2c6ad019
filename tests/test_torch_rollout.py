"""The slice: the torch port's batched SRB closed loop against the JAX
package's batched rollout (``batched_rollout_fn(backend="xla")``: the same
algorithm as the Pallas backend, whose interpret mode is too slow for
multi-tick rollouts here).

Tolerances:
- pointwise, 4 envs x 20 ticks from the same perturbed states: x_fb atol
  2e-3. The f32 reduction order differs between the two packages and
  compounds over warm-started ticks (cf. tests/test_rollout.py:238-241);
  measured here ~3e-5 at the bench budget and ~4e-4 at the default budget,
  whose polish accept/reject and active set are discontinuous in roundoff.
- the 250-tick walking protocol of
  tests/test_rollout.py::test_bench_budget_accuracy, with the port at the
  bench budget in place of the JAX fast budget: same bounds.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.parallel import rollout as jroll
from biped_mpc_py_tpu.utils.precision import f32_precision
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import qp_kernel
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from torch_threads import one_torch_thread  # noqa: F401

X_CMD = np.array([0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0], np.float32)


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _matched(jm):
    """The JAX config at the port's precision (bf16 knobs off)."""
    return dataclasses.replace(
        jm, kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False
    )


def _start(jm, n, randomized, seed=0):
    rng = np.random.default_rng(seed)
    jw = jroll.batch_worlds(jm, n)
    x0 = np.array(jw.sim.x_fb) + (rng.normal(size=(n, 12)) * 0.01).astype(np.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, x_fb=jnp.asarray(x0)))
    if randomized:
        jb = jroll.randomize_params(jax.random.PRNGKey(seed), n)
    else:
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + jnp.shape(x)), JBipedParams())
    return jw, jb


@pytest.mark.parametrize(
    "budget,randomized", [("bench", True), ("default", False)],
)
def test_rollout_matches_jax_pointwise(budget, randomized):
    n, ticks = 4, 20
    base = (jcfg.fast_mpc_config if budget == "bench" else jcfg.default_mpc_config)(
        x_cmd=jnp.asarray(X_CMD)
    )
    jm = _matched(base)
    jw, jb = _start(jm, n, randomized)
    out_j = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, jm, jcfg.GaitConfig())))(jw, jb)

    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    tw = from_numpy(troll.World, _fields(jw))
    tb = from_numpy(BipedParams, _fields(jb))
    out_t = troll.batched_rollout(tw, tb, ticks, tm, tcfg.GaitConfig())

    j, t = _fields(out_j), to_numpy(out_t)
    np.testing.assert_allclose(t["sim"]["x_fb"], j["sim"]["x_fb"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(t["sim"]["foot"], j["sim"]["foot"], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])  # same f32 clock
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_array_equal(t["metrics"]["n_steps"], j["metrics"]["n_steps"])
    np.testing.assert_allclose(
        t["metrics"]["attitude_err_sq"], j["metrics"]["attitude_err_sq"], rtol=1e-2, atol=1e-5
    )
    assert qp_kernel.fused_qp_solve.launches == 0  # CPU tensors: plain version


def test_fall_reset_matches_jax():
    """An env outside the height band resets in-batch exactly as in JAX:
    standing state and cold controller, clock kept, fall counted; the
    other envs run on untouched."""
    n, ticks = 3, 3
    jm = _matched(jcfg.fast_mpc_config())
    jw, jb = _start(jm, n, randomized=False)
    x = np.array(jw.sim.x_fb)
    x[1, 5] = 0.2  # below FALL_Z_MIN
    x[2, 10] += 2.0  # a kick
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, x_fb=jnp.asarray(x)))
    out_j = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, jm, jcfg.GaitConfig())))(jw, jb)
    out_t = troll.batched_rollout(
        from_numpy(troll.World, _fields(jw)), from_numpy(BipedParams, _fields(jb)),
        ticks, from_numpy(tcfg.MpcConfig, _fields(jm)), tcfg.GaitConfig(),
    )
    j, t = _fields(out_j), to_numpy(out_t)
    assert float(t["metrics"]["falls"][1]) >= 1
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    for key in ("x_fb", "foot"):
        np.testing.assert_allclose(t["sim"][key], j["sim"][key], atol=2e-3, rtol=0)
    tc, jc = t["ctrl"], j["ctrl"]
    for key in ("cmd_ref", "v_int", "t_gait", "pitch_ref"):
        np.testing.assert_allclose(tc[key], jc[key], atol=2e-3, rtol=0, err_msg=key)
    np.testing.assert_array_equal(tc["hold_count"], jc["hold_count"])
    # the warm start: QP-solution tolerances (tests/test_torch_qp_kernel.py)
    np.testing.assert_allclose(tc["qp"]["controls"], jc["qp"]["controls"], atol=0.1, rtol=0)
    np.testing.assert_allclose(tc["qp"]["states"], jc["qp"]["states"], atol=2e-2, rtol=0)


def test_bench_budget_walking_statistics():
    """tests/test_rollout.py::test_bench_budget_accuracy with the port at
    the bench budget (40 iters / 1 phase / no polish / NS 10, all f32) in
    place of the JAX fast budget: 250 ticks (10 s) walking at 0.3 m/s,
    zero falls, and the statistics of the validated JAX 60/3/polish
    budget."""
    mpc_full = jcfg.default_mpc_config(x_cmd=jnp.asarray(X_CMD))
    w_full = jax.jit(jroll.rollout_fn(250, mpc_full, jcfg.GaitConfig()))(
        jroll.init_world(mpc_full), JBipedParams()
    )
    # the bf16 knobs off: this is the f32 bench budget's walk (the knobs-on
    # walk against JAX's: tests/test_torch_qp_bf16.py)
    mpc = dataclasses.replace(tcfg.fast_mpc_config(x_cmd=X_CMD), kinv_bf16_iters=0,
                              admm_bf16_matvec=False, ruiz_bf16_norms=False)
    w_fast = troll.batched_rollout(
        troll.init_world(mpc, device="cpu"), BipedParams(), 250, mpc, tcfg.GaitConfig()
    )
    assert float(w_fast.metrics.falls[0]) == 0
    xf_full, xf_fast = np.array(w_full.sim.x_fb), w_fast.sim.x_fb[0].numpy()
    assert abs(xf_fast[3] - xf_full[3]) < 0.15, (xf_fast[3], xf_full[3])
    assert abs(xf_fast[5] - xf_full[5]) < 0.02
    assert abs(xf_fast[4]) < 0.3 and abs(xf_full[4]) < 0.3
    rms_full = float(jnp.sqrt(w_full.metrics.attitude_err_sq / 250))
    rms_fast = float(torch.sqrt(w_fast.metrics.attitude_err_sq[0] / 250))
    assert rms_fast < 1.2 * rms_full + 1e-3, (rms_fast, rms_full)
    v_full = float(jnp.sqrt(w_full.metrics.vel_err_sq / 250))
    v_fast = float(torch.sqrt(w_fast.metrics.vel_err_sq[0] / 250))
    assert v_fast < 1.2 * v_full + 5e-3, (v_fast, v_full)
    assert float(w_fast.metrics.res_prim_max[0]) < 1.0


def test_randomize_params():
    """Per-env robots from a torch.Generator: reproducible, in range, and
    different across envs; the rest of the robot is the base's."""
    n = 64
    a = troll.randomize_params(torch.Generator().manual_seed(3), n, device="cpu")
    b = troll.randomize_params(torch.Generator().manual_seed(3), n, device="cpu")
    for f in dataclasses.fields(a):
        if f.name != "leg":
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if va is not None:
                assert va.shape[0] == n and torch.equal(va, vb), f.name
    base = BipedParams()
    assert ((a.m >= 0.8 * 12.0 - 1e-4) & (a.m <= 1.2 * 12.0 + 1e-4)).all()
    assert ((a.mu >= 0.4) & (a.mu <= 0.7)).all() and float(a.mu.std()) > 0.05
    ratio = a.I_diag / base.I_diag
    assert ((ratio > 0.8 - 1e-6) & (ratio < 1.2 + 1e-6)).all()
    assert torch.equal(a.tau_max, base.tau_max.expand(n, 3))
    assert a.leg.l_thigh.shape == (n,)


def test_import_leaves_jax_out():
    """The package imports without JAX, CUDA, nvcc or triton."""
    code = (
        "import sys, biped_mpc_py_torch, biped_mpc_py_torch.parallel.rollout, "
        "biped_mpc_py_torch.utils.convert, biped_mpc_py_torch.ops.cuda.qp_kernel, "
        "biped_mpc_py_torch.parallel.rollout_art, biped_mpc_py_torch.ops.cuda.substep_kernel, "
        "biped_mpc_py_torch.control.controller, biped_mpc_py_torch.sim.dynamics; "
        "bad = [m for m in ('jax', 'flax', 'triton', 'biped_mpc_py_tpu') if m in sys.modules]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

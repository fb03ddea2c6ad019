"""The fused-substep kernel's wrapper on the CPU: its plain version against
the JAX Pallas kernel (``ops/pallas/substep_kernel.py::fused_substeps``) run
in interpret mode, as ``tests/test_substep_kernel.py`` runs it, and the
wrapper's dispatch and input checks. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the bounds of ``tests/test_substep_kernel.py:73-76`` (pos 5e-7,
quat 1e-6, v_base 5e-6, q 1e-6, qd 1e-4) at 1024 perturbed in-contact envs,
dt 5 ms in 5 substeps; measured well inside them (qd ~2e-5).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.ops.pallas.substep_kernel import fused_substeps as jfused
from biped_mpc_py_tpu.sim import engine as jeng
from biped_mpc_py_torch.ops.cuda import substep_kernel as tk
from biped_mpc_py_torch.sim import engine as teng
from tests.test_torch_sim import JM, SUBSTEP_BOUNDS, TM, _close, _perturbed


def test_fused_substeps_reference_matches_pallas_kernel():
    """1024 perturbed in-contact envs, dt 5 ms in 5 substeps: the port's
    plain version against the JAX Pallas kernel in interpret mode, at the
    bounds of tests/test_substep_kernel.py:73-76."""
    js, ts, tau = _perturbed(1024, 0)
    Minv = jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q))(js.q)
    out_j = jfused(JM, js, jnp.asarray(tau), Minv, 0.005, 5)
    out_t = tk.fused_substeps_reference(
        TM, ts, torch.tensor(tau), torch.tensor(np.asarray(Minv)), 0.005, 5)
    for name, tol in SUBSTEP_BOUNDS.items():
        _close(getattr(out_t, name), getattr(out_j, name), tol, name=name)
    _close(out_t.t, out_j.t, 1e-6, name="t")


def test_fused_substeps_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version, for any number of
    envs (here 7), counts no launch, and checks its inputs."""
    _, ts, tau = _perturbed(7, 8)
    tau = torch.tensor(tau)
    Minv = teng.mass_matrix_inv(TM, ts.q)
    before = tk.fused_substeps.launches
    out = tk.fused_substeps(TM, ts, tau, Minv, 0.005, 5)
    ref = tk.fused_substeps_reference(TM, ts, tau, Minv, 0.005, 5)
    assert tk.fused_substeps.launches == before
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name)), f.name
    assert torch.allclose(out.t, ts.t + 0.005)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_substeps(TM, ts, tau[:, :9], Minv, 0.005, 5)
    with pytest.raises(TypeError, match="float32"):
        tk.fused_substeps(TM, ts, tau.double(), Minv, 0.005, 5)
    with pytest.raises(ValueError, match="n_steps"):
        tk.fused_substeps(TM, ts, tau, Minv, 0.005, 0)
    buf = tk.model_constants(TM, "cpu")
    assert buf.shape == (tk.N_CONSTS,) and buf.dtype == torch.float32

"""The fused-substep kernel's wrapper on the CPU: its plain version against
the JAX Pallas kernel (``ops/pallas/substep_kernel.py::fused_substeps``) run
in interpret mode, as ``tests/test_substep_kernel.py`` runs it, and the
wrapper's dispatch and input checks. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: the bounds of ``tests/test_substep_kernel.py:73-76`` (pos 5e-7,
quat 1e-6, v_base 5e-6, q 1e-6, qd 1e-4) at 1024 perturbed in-contact envs,
dt 5 ms in 5 substeps; measured well inside them (qd ~2e-5).

On a height field per env the wrapper's CPU side is ``art_step`` itself,
so it is held bit for bit, ``t`` and the count of sole points below the
ground included; the rough-ground rollout sends each low-level period
through it and stays bit-equal to the plain chain.
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
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim import engine as teng
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.graphs import leaves
from tests.test_torch_sim import JM, SUBSTEP_BOUNDS, TM, _close, _perturbed
from torch_threads import one_torch_thread  # noqa: F401


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


def _rough(n, seed=3):
    """A 4 cm rough field per env on a 2 m grid, so that the soles see slopes."""
    fields = Terrain.rough_batch(torch.Generator().manual_seed(seed), n, amplitude=0.04,
                                 res=16, device="cpu")
    return dataclasses.replace(fields, extent=2.0)


def test_fused_substeps_field_on_cpu_is_art_step():
    """On a field per env the wrapper on CPU tensors is ``art_step(..., terrain,
    Minv=)``: every field bit-equal, ``t`` (5 additions of dt / 5) included,
    and the same count of sole points below the ground; no launch."""
    _, ts, tau = _perturbed(5, 11)
    tau = torch.tensor(tau)
    Minv = teng.mass_matrix_inv(TM, ts.q)
    fields = _rough(5)
    profiling.start_ground_count("cpu")
    want = teng.art_step(TM, ts, tau, 0.005, 5, fields, Minv=Minv)
    count = profiling._ground[torch.device("cpu")].below.clone()
    share = profiling.terrain_contacts("cpu")
    profiling.start_ground_count("cpu")
    before = tk.fused_substeps.launches
    out = tk.fused_substeps(TM, ts, tau, Minv, 0.005, 5, terrain=fields)
    assert tk.fused_substeps.launches == before
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(want, f.name)), f.name
    assert count.shape == (5, 2, 2) and int(count.sum()) > 0
    assert torch.equal(profiling._ground[torch.device("cpu")].below, count)
    assert profiling.terrain_contacts("cpu") == share


@pytest.mark.parametrize("fault", ["shared", "dt", "envs", "cells", "dtype", "device",
                                   "strided"])
def test_fused_substeps_field_refusals(fault):
    """The wrapper refuses, before anything runs: a shared (H, W) field, a
    per-env ``dt``, heights whose env axis is not the state's or with fewer
    than 2 cells a side, float64 heights, heights on another device, and
    heights that are not contiguous."""
    _, ts, tau = _perturbed(3, 12)
    tau = torch.tensor(tau)
    Minv = teng.mass_matrix_inv(TM, ts.q)
    h, dt = _rough(3).heights, 0.005
    bad = {
        "shared": (h[0], ValueError, "shared"),
        "dt": (h, ValueError, "one dt"),
        "envs": (h[:2], ValueError, "shape"),
        "cells": (h[:, :1], ValueError, "shape"),
        "dtype": (h.double(), TypeError, "float32"),
        "device": (torch.empty(h.shape, device="meta"), ValueError, "meta"),
        "strided": (h.transpose(1, 2), ValueError, "contiguous"),
    }
    heights, exc, match = bad[fault]
    if fault == "dt":
        dt = torch.full((3,), 0.005)
    with pytest.raises(exc, match=match):
        tk.fused_substeps(TM, ts, tau, Minv, dt, 5, terrain=Terrain(heights=heights))


def test_terrain_rollout_steps_each_period_through_the_wrapper(monkeypatch):
    """A tick of ``batched_art_rollout_terrain`` on 3 envs calls
    ``fused_substeps(terrain=)`` once per low-level period (8 a tick), and
    on the CPU gives the plain chain's world bit for bit: the same tick with
    ``art_step`` as the physics."""
    mpc, gait = tra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                         admm_polish=False, kinv_ns_iters=10)
    n, ticks = 3, 1
    fields = _rough(n, seed=4)
    w0 = tra.init_art_world(mpc, n, device="cpu")
    bipeds = tra.BipedParams().expand(n)

    def plain(sim, tau, Minv, dt):
        return teng.art_step(TM, sim, tau, dt, 5, fields, Minv=Minv)

    want = w0
    for _ in range(ticks):
        want = tra._art_tick(want, bipeds, mpc, gait, TM, 8, 8, plain, fields)
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("terrain"))
        return tk.fused_substeps(*args, **kw)

    monkeypatch.setattr(tra, "fused_substeps", spy)
    out = tra.batched_art_rollout_terrain(w0, bipeds, fields, ticks, mpc, gait, model=TM,
                                          n_substeps=5, minv_ll_hold=8)
    assert len(calls) == 8 * ticks and all(c is fields for c in calls)
    for a, b in zip(leaves(out), leaves(want), strict=True):
        assert torch.equal(a, b)

"""The rough-ground tick on the CPU: the path choice of
``parallel/rollout_art.py::art_closed_loop_tick`` and the tick kernel's
field wrapper ``ops/cuda/tick_kernel.py::fused_tick(terrain=)``.

On the card a field per env with one config (no ``x_cmd``, no
``per_env``), a walking gait on the tick's own clock and one mass-matrix
inverse a tick runs the low-level loop as one launch of
``tick_kernel<Field>`` (``tests/test_torch_cuda.py`` holds the kernel
against its plain version); every other input keeps the plain chain. On
the CPU the wrapper runs the plain terrain periods, so here, bit for bit:

- the kernel path's tick (``_tick_kernel_tick`` on a field) equals the
  plain chain's tick on the same input: it shares the plain chain's MPC,
  Minv and post stages and hands the low-level loop the same clock,
  controls, command yaw, ``v_int`` and robots;
- each input that the path refuses (a shared field, a per-env ``dt``,
  per-env gains, ``x_cmd``, a running gait, the contact clock,
  ``minv_ll_hold < n_lowlevel``) runs the plain chain as written out here;
- ``fused_tick(terrain=)`` equals the plain terrain periods
  (``_lowlevel_stage``, then ``sim.engine.art_step(..., terrain, Minv=)``)
  with the ground count, launches nothing, and reads each env's own leg
  geometry;
- the wrapper refuses a shared field, a field of the wrong shape, dtype or
  device, a leg geometry of the wrong length, no robots and the contact
  clock, before it reaches a device.

4 envs on 16 x 16 fields of 0.04 m, the fast budget, 8 periods of 5
substeps.
"""

import dataclasses
import functools

import pytest
import torch

import biped_mpc_py_torch as bt
from biped_mpc_py_torch.models.biped import HECTOR_LEG_FK, HECTOR_LEG_JAC
from biped_mpc_py_torch.ops.cuda import substep_kernel, tick_kernel
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.parallel.sweep import stack_configs
from biped_mpc_py_torch.sim import engine
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.graphs import leaves
from torch_threads import one_torch_thread  # noqa: F401

N, N_LL, N_SUB = 4, 8, 5
FAST = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
MODEL = hector_model(device="cpu")


def _config(**over):
    mpc, gait = tra.art_config_for_speed(0.3, **FAST)
    return dataclasses.replace(mpc, **over), gait


def _fields(n=N, seed=22):
    return bt.Terrain.rough_batch(torch.Generator().manual_seed(seed), n, amplitude=0.04,
                                  res=16, device="cpu")


@functools.cache
def _world(n=N):
    """Perturbed standing envs a tick into a walk on their fields, so that
    the controller's carry (cmd_ref, v_int, the warm start) is not cold."""
    mpc, gait = _config()
    w = bt.perturbed_worlds(mpc, n, torch.Generator().manual_seed(21), device="cpu")
    return tra.art_closed_loop_tick(w, mpc, gait, bt.BipedParams().expand(n), MODEL, N_LL,
                                    N_SUB, _fields(n), N_LL)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


def _plain_tick(w, mpc, gait, bipeds, terrain, hold, x_cmd=None, per_env=None):
    """The plain chain's tick, written out: ``_art_tick`` with each period's
    physics ``art_step``'s."""

    def physics(sim, tau, Minv, dt):
        return tra.art_step(MODEL, sim, tau, dt, N_SUB, terrain, Minv=Minv)

    return tra._art_tick(w, bipeds, mpc, gait, MODEL, N_LL, hold, physics, terrain, x_cmd,
                         per_env)


def test_kernel_path_tick_is_the_plain_chain_on_cpu():
    """The cell's input takes the kernel path, and on the CPU its tick is
    the plain chain's bit for bit, the ground count included."""
    mpc, gait = _config()
    w, bipeds, fields = _world(), bt.BipedParams().expand(N), _fields()
    assert tra._tick_field_path(fields, gait, N_LL, N_LL, None, None)
    want = _plain_tick(w, mpc, gait, bipeds, fields, N_LL)
    count = profiling._ground[torch.device("cpu")].below.clone()
    before = (tick_kernel.fused_tick.launches, substep_kernel.fused_substeps.launches)
    got = tra._tick_kernel_tick(w, bipeds, mpc, gait, MODEL, bt.BipedParams(), N_LL, N_SUB,
                                fields)
    assert (tick_kernel.fused_tick.launches, substep_kernel.fused_substeps.launches) == before
    assert _equal(got, want)
    assert torch.equal(profiling._ground[torch.device("cpu")].below, count)
    assert profiling.terrain_contacts("cpu") > 0


def _fallback(case):
    """(mpc, gait, terrain, minv_ll_hold, x_cmd, per_env) of an input the
    kernel path refuses."""
    mpc, gait = _config()
    fields = _fields()
    if case == "shared_field":
        return mpc, gait, bt.Terrain(heights=fields.heights[0]), N_LL, None, None
    if case == "running_gait":
        mpc, gait = tra.art_config_for_run(0.3, **FAST)
        return mpc, gait, fields, N_LL, None, None
    if case == "contact_clock":
        return mpc, dataclasses.replace(gait, contact_clock=True), fields, N_LL, None, None
    if case == "minv_hold_4":
        return mpc, gait, fields, 4, None, None
    if case == "x_cmd":
        x_cmd = torch.tensor(mpc.x_cmd).expand(N, 12).clone()
        x_cmd[:, 9] = torch.linspace(0.0, 0.3, N)
        return mpc, gait, fields, N_LL, x_cmd, None
    over = {"per_env_dt": dict(dt=0.035), "per_env_gains": dict(kp_hipyaw=0.0)}[case]
    mm, per_env = stack_configs([mpc, dataclasses.replace(mpc, **over)] * (N // 2),
                                device="cpu")
    return mm, gait, fields, N_LL, None, per_env


@pytest.mark.parametrize("case", ["shared_field", "per_env_dt", "per_env_gains", "x_cmd",
                                  "running_gait", "contact_clock", "minv_hold_4"])
def test_fallback_inputs_keep_the_plain_chain(case):
    mpc, gait, terrain, hold, x_cmd, per_env = _fallback(case)
    assert not tra._tick_field_path(terrain, gait, N_LL, hold, x_cmd, per_env)
    w, bipeds = _world(), bt.BipedParams().expand(N)
    want = _plain_tick(w, mpc, gait, bipeds, terrain, hold, x_cmd, per_env)
    before = (tick_kernel.fused_tick.launches, substep_kernel.fused_substeps.launches)
    got = tra.art_closed_loop_tick(w, mpc, gait, bipeds, MODEL, N_LL, N_SUB, terrain, hold,
                                   x_cmd=x_cmd, per_env=per_env)
    assert (tick_kernel.fused_tick.launches, substep_kernel.fused_substeps.launches) == before
    assert _equal(got, want)


def _tick_args(w, mpc, gait):
    """The MPC stage's outputs of ``w`` as ``fused_tick``'s arguments."""
    _, _, _, contact, sol = tra._art_control_stage(w, bt.BipedParams().expand(N), mpc, gait,
                                                   MODEL, _fields())
    Minv = engine.mass_matrix_inv(MODEL, w.sim.q)
    return (sol.controls[:, 0], contact[:, 0, 0:2], w.sim.t, w.ctrl.cmd_ref[:, 2],
            w.ctrl.v_int, Minv)


def _two_geometries(n=N):
    """Even envs on the FK leg geometry, odd envs on the Jacobian one."""
    fk = bt.BipedParams(leg_jac=HECTOR_LEG_FK).expand(n)
    jac = bt.BipedParams(leg_jac=HECTOR_LEG_JAC).expand(n)
    return fk.where(torch.arange(n) % 2 == 1, jac)


@pytest.mark.parametrize("geometry", ["nominal", "two"])
def test_fused_tick_field_on_cpu_is_the_plain_terrain_periods(geometry):
    """On CPU tensors ``fused_tick(terrain=)`` is the plain terrain periods
    of the tick (``_lowlevel_stage``, then ``art_step`` on the field), bit
    for bit with the clock, the energy and the ground count, and launches
    nothing; with two leg geometries each env reads its own."""
    mpc, gait = _config()
    w, fields = _world(), _fields()
    bipeds = bt.BipedParams().expand(N) if geometry == "nominal" else _two_geometries()
    u0, c0, t0, cmd_yaw, v_int, Minv = _tick_args(w, mpc, gait)
    contact = c0[:, None, :]
    sim, energy = w.sim, torch.zeros_like(t0)
    profiling.start_ground_count("cpu")
    for _ in range(N_LL):
        tau = tra._lowlevel_stage(MODEL, sim, sim.t, contact, u0, w, bipeds, mpc, gait, fields)
        energy = energy + torch.sum(torch.clamp(tau * sim.qd, min=0.0), 1) * (mpc.dt / N_LL)
        sim = engine.art_step(MODEL, sim, tau, mpc.dt / N_LL, N_SUB, fields, Minv=Minv)
    count = profiling._ground[torch.device("cpu")].below.clone()
    profiling.start_ground_count("cpu")
    before = tick_kernel.fused_tick.launches
    out, e = tick_kernel.fused_tick(MODEL, bt.BipedParams(), mpc, gait, w.sim, u0, c0, t0,
                                    cmd_yaw, v_int, Minv, N_LL, N_SUB, terrain=fields,
                                    bipeds=bipeds)
    assert tick_kernel.fused_tick.launches == before
    assert _equal(out, sim) and torch.equal(e, energy)
    assert torch.equal(profiling._ground[torch.device("cpu")].below, count)
    if geometry == "two":
        nominal, _ = tick_kernel.fused_tick(
            MODEL, bt.BipedParams(), mpc, gait, w.sim, u0, c0, t0, cmd_yaw, v_int, Minv,
            N_LL, N_SUB, terrain=fields, bipeds=bt.BipedParams().expand(N))
        # the nominal robot's Jacobian geometry is the FK one (BipedParams().leg)
        assert torch.equal(out.q[0::2], nominal.q[0::2])
        assert not torch.equal(out.q[1::2], nominal.q[1::2])


@pytest.mark.parametrize("fault", ["shared", "shape", "dtype", "device", "geometry",
                                   "no_robots", "contact_clock"])
def test_fused_tick_refuses_bad_fields(fault):
    mpc, gait = _config()
    w, fields, bipeds = _world(), _fields(), bt.BipedParams().expand(N)
    kw = dict(terrain=fields, bipeds=bipeds)
    err, match = ValueError, {
        "shared": "shared field", "shape": "shape", "dtype": "float32", "device": "is on",
        "geometry": "leg geometry", "no_robots": "bipeds", "contact_clock": "contact_clock",
    }[fault]
    if fault == "shared":
        kw["terrain"] = bt.Terrain(heights=fields.heights[0])
    elif fault == "shape":
        kw["terrain"] = _fields(N - 1)
    elif fault == "dtype":
        err, kw["terrain"] = TypeError, bt.Terrain(heights=fields.heights.double())
    elif fault == "device":
        kw["terrain"] = bt.Terrain(heights=torch.empty((N, 16, 16), device="meta"))
    elif fault == "geometry":
        kw["bipeds"] = bt.BipedParams().expand(N + 1)
    elif fault == "no_robots":
        kw["bipeds"] = None
    else:
        gait = dataclasses.replace(gait, contact_clock=True)
    before = tick_kernel.fused_tick.launches
    with pytest.raises(err, match=match):
        tick_kernel.fused_tick(MODEL, bt.BipedParams(), mpc, gait, w.sim,
                               *_tick_args(w, mpc, gait), N_LL, N_SUB, **kw)
    assert tick_kernel.fused_tick.launches == before

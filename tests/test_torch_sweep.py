"""The torch port's config sweeps (``parallel/sweep.py``) and the per-env
values they ride on (``config.config_value``, the ``x_cmd`` and
``per_env`` arguments of the articulated low-level control, the swing
force and the tick stages) against the JAX package, where the same configs
are stacked by ``stack_configs`` and vmapped.

Inputs come from numpy with a seed. Tolerances:
- the joint torques with per-env gains and commands against JAX's vmap
  over the stacked configs: 1e-5 N m (measured 7.6e-6); the swing force:
  2e-5 N (f32 roundoff of ~2e-8 m at swing gains up to 500 N/m; measured
  1.1e-5);
- no per-env argument, or an empty dict: bit-equal to the call without;
- ``stack_configs``: the same fields batched as JAX's ``in_axes``, equal
  values, for every dynamic field of the config, and ``ValueError`` on a
  static field and on differing gait configs;
- ``art_sweep``, 3 configs x 2 ticks at the bench budget and physics (5
  substeps, the mass-matrix inverse held all tick) from perturbed worlds
  carried to JAX: ``CHAIN_BOUNDS`` of ``tests/test_torch_rollout_art.py``
  against ``art_sweep_fn``, two equal configs on equal worlds bit-equal,
  the zero-gain config apart, and each row within ``CHAIN_BOUNDS`` of the
  same config run alone (the batched and the single-env solve sum in other
  orders; measured v_base 4.4e-5).
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu import config as jcfg
from biped_mpc_py_tpu.control import lowlevel as jll
from biped_mpc_py_tpu.control import swing as jswing
from biped_mpc_py_tpu.models import biped as jbiped
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.parallel import sweep as jsweep
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control import lowlevel as tll
from biped_mpc_py_torch.control import swing as tswing
from biped_mpc_py_torch.models import biped as tbiped
from biped_mpc_py_torch.ops.cuda import tick_kernel
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.parallel import sweep as tsweep
from biped_mpc_py_torch.sim import contact as tterrain
from biped_mpc_py_torch.sim.engine import mass_matrix_inv
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from torch_threads import one_torch_thread  # noqa: F401

CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}
BENCH = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)


def _fields(tree):
    return dataclasses.asdict(jax.tree.map(np.asarray, tree))


def _port(cls, obj):
    return from_numpy(cls, _fields(obj))


def test_art_sweep_fn_matches_jax():
    """The compiled sweep, ``art_sweep_fn`` (the per-env values an input of
    its graph; on the CPU its static buffers step eagerly), against the same
    JAX run at ``CHAIN_BOUNDS``, the clock bit-equal; called again with the
    configs' rows swapped (the same shapes, other values), it gives the
    eager sweep of the swapped values."""
    _, tm, per_env, tg, worlds, out_j = _gain_sweep()
    bipeds = tbiped.BipedParams().expand(3)
    fn = tsweep.art_sweep_fn(2, tm, tg, **TICK)
    _assert_sweep_chain(fn(worlds, bipeds, per_env), out_j)
    swapped = {k: v.flip(0) for k, v in per_env.items()}
    again = fn(worlds, bipeds, swapped)
    assert len(fn.graphs) == 1
    want = tsweep.art_sweep(worlds, bipeds, 2, tm, tg, swapped, **TICK)
    assert torch.equal(again.sim.q, want.sim.q) and torch.equal(again.sim.qd, want.sim.qd)


def _gait(name):
    if name == "run":
        return jra.art_config_for_run(1.0)
    return jra.art_mpc_config(), jcfg.GaitConfig(steps_per_phase=3)


def _sweep_configs(base, n, seed):
    """n configs: every per-env field and the command drawn per env."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kw = {name: float(rng.uniform(0.2, 1.0)) * max(abs(getattr(base, name)), 0.5)
              for name in tcfg.PER_ENV_FIELDS}
        kw["swing_land_frac"] = float(rng.uniform(0.6, 1.0))
        x_cmd = np.zeros(12, np.float32)
        x_cmd[[2, 5, 8, 9]] = rng.normal(size=4) * [0.3, 0.0, 0.3, 0.3] + [0, 0.55, 0, 0]
        out.append(dataclasses.replace(base, x_cmd=jnp.asarray(x_cmd), **kw))
    return out


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 12))
    x[:, 5] = 0.55
    x += rng.normal(size=(n, 12)) * [0.05, 0.05, 0.3, 0.1, 0.1, 0.02, 0.3, 0.3, 0.3, 0.3,
                                     0.3, 0.1]
    q = np.array([0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2) + 0.2 * rng.normal(size=(n, 10))
    f32 = np.float32
    return dict(
        x=x.astype(f32), q=q.astype(f32), qd=rng.normal(size=(n, 10)).astype(f32),
        t=rng.uniform(0, 2.0, size=n).astype(f32),
        pf=(rng.normal(size=(n, 6)) * 0.1).astype(f32),
        vf=rng.normal(size=(n, 3)).astype(f32),
        contact=rng.integers(0, 2, size=(n, 10, 2)).astype(f32),  # flight rows too
        u0=(rng.normal(size=(n, 12)) * 30).astype(f32),
        cmd_ref=(rng.normal(size=(n, 3)) * 0.2).astype(f32),
        v_int=(rng.normal(size=(n, 2)) * 0.1).astype(f32),
    )


def _close(port, ref, atol, name):
    err = float(np.abs(port.detach().numpy() - np.asarray(ref)).max())
    assert err <= atol, (name, err, atol)


@pytest.fixture(scope="module", params=["walk", "run"])
def per_env_case(request):
    """(JAX stacked config and axes, JAX gait, port config, gait, per-env
    dict, inputs) for 16 envs under 16 configs."""
    base, jg = _gait(request.param)
    base = dataclasses.replace(base, flight_yaw_kd=0.5, kp_pivot=3.0, kd_pivot=0.2,
                               hipyaw_rate_lead=0.1, swing_retract=0.02,
                               swing_track_ff=0.5, swing_td_overdrive=0.1)
    configs = _sweep_configs(base, 16, 1)
    jm, axes = jsweep.stack_configs(configs)
    tm, per_env = tsweep.stack_configs([_port(tcfg.MpcConfig, c) for c in configs],
                                       device="cpu")
    return jm, axes, jg, tm, _port(tcfg.GaitConfig, jg), per_env, _inputs(16, 2)


def test_swing_leg_force_per_env_matches_jax(per_env_case):
    jm, axes, jg, tm, tg, per_env, a = per_env_case
    assert set(per_env) == set(tcfg.PER_ENV_FIELDS) | {"x_cmd"}
    x_cmd = per_env["x_cmd"]
    gains = {k: v for k, v in per_env.items() if k != "x_cmd"}
    for side in (1.0, -1.0):
        f_j = jax.vmap(lambda m, x, t, p, v, vi: jswing.swing_leg_force(
            x, t, p, v, m, side, jg, v_int=vi), in_axes=(axes, 0, 0, 0, 0, 0))(
            jm, a["x"], a["t"], a["pf"][:, :3], a["vf"], a["v_int"])
        f_t = tswing.swing_leg_force(
            torch.tensor(a["x"]), torch.tensor(a["t"]), torch.tensor(a["pf"][:, :3]),
            torch.tensor(a["vf"]), tm, side, tg, v_int=torch.tensor(a["v_int"]),
            x_cmd=x_cmd, per_env=gains)
        _close(f_t, f_j, 2e-5, f"swing force side {side}")


@pytest.mark.parametrize("frame_bug", [False, True])
def test_low_level_control_per_env_matches_jax(per_env_case, frame_bug):
    jm, axes, jg, tm, tg, per_env, a = per_env_case
    jm, axes, tm = (dataclasses.replace(c, compat_swing_frame_bug=frame_bug)
                    for c in (jm, axes, tm))
    jb = jbiped.BipedParams(leg_jac=jbiped.HECTOR_LEG_JAC)
    tb = tbiped.BipedParams(leg_jac=tbiped.HECTOR_LEG_JAC).expand(16)
    keys = ("x", "t", "pf", "q", "qd", "contact", "u0", "cmd_ref", "v_int")
    tau_j = jax.vmap(lambda m, *b: jll.low_level_control(
        b[0], b[1], b[2], b[3], b[4], m, jb, b[5], b[6], gait=jg, cmd_ref=b[7], v_int=b[8]),
        in_axes=(axes,) + (0,) * len(keys))(jm, *[a[k] for k in keys])
    t = {k: torch.tensor(a[k]) for k in keys}
    gains = {k: v for k, v in per_env.items() if k != "x_cmd"}
    tau_t = tll.low_level_control(
        t["x"], t["t"], t["pf"], t["q"], t["qd"], tm, tb, t["contact"], t["u0"], gait=tg,
        cmd_ref=t["cmd_ref"], v_int=t["v_int"], x_cmd=per_env["x_cmd"], per_env=gains)
    _close(tau_t, tau_j, 1e-5, "tau")


def test_no_per_env_values_is_bit_equal():
    """``x_cmd=None`` and an empty dict change nothing: the low-level
    control and a whole articulated tick are bit-equal to the calls
    without them."""
    jm, jg = _gait("walk")
    tm, tg = _port(tcfg.MpcConfig, jm), _port(tcfg.GaitConfig, jg)
    a = _inputs(8, 3)
    t = {k: torch.tensor(v) for k, v in a.items()}
    tb = tbiped.BipedParams().expand(8)
    args = (t["x"], t["t"], t["pf"], t["q"], t["qd"], tm, tb, t["contact"], t["u0"])
    kw = dict(gait=tg, cmd_ref=t["cmd_ref"], v_int=t["v_int"])
    assert torch.equal(tll.low_level_control(*args, **kw),
                       tll.low_level_control(*args, **kw, x_cmd=None, per_env={}))
    model, b2 = hector_model(device="cpu"), tbiped.BipedParams().expand(2)
    w = tra.init_art_world(tm, 2, device="cpu")
    tick = dict(n_substeps=5, minv_ll_hold=8)
    w1 = tra.art_closed_loop_tick(w, tm, tg, b2, model, **tick)
    w2 = tra.art_closed_loop_tick(w, tm, tg, b2, model, x_cmd=None, per_env={}, **tick)
    for k, v in to_numpy(w1.sim).items():
        np.testing.assert_array_equal(v, to_numpy(w2.sim)[k])


def test_stack_configs_batches_only_differing_fields():
    """``tests/test_sweep.py``'s first case, and the same batched fields
    and values as JAX's."""
    base = jra.art_mpc_config()
    cfgs = [dataclasses.replace(base, kp_hipyaw=k, x_cmd=base.x_cmd.at[9].set(v))
            for k, v in ((1.0, 0.1), (2.0, 0.2), (3.0, 0.2))]
    jm, axes = jsweep.stack_configs(cfgs)
    tm, per_env = tsweep.stack_configs([_port(tcfg.MpcConfig, c) for c in cfgs], device="cpu")
    batched = {p[0].name for p, _ in jax.tree_util.tree_flatten_with_path(axes)[0]}
    assert batched == set(per_env) == {"kp_hipyaw", "x_cmd"}
    assert per_env["kp_hipyaw"].shape == (3,) and per_env["x_cmd"].shape == (3, 12)
    np.testing.assert_array_equal(per_env["kp_hipyaw"].numpy(), np.asarray(jm.kp_hipyaw))
    np.testing.assert_array_equal(per_env["x_cmd"].numpy(), np.asarray(jm.x_cmd))
    # equal fields stay in the config (JAX keeps them unbatched)
    assert tm == _port(tcfg.MpcConfig, cfgs[0])
    assert tm.kd_hipyaw == float(np.asarray(jm.kd_hipyaw))


@pytest.mark.parametrize("field", tcfg.MPC_PER_ENV_FIELDS)
def test_stack_configs_batches_every_dynamic_field(field):
    """A difference in any of the MPC-stage, clock and solver fields lands
    in ``per_env`` with JAX's values, and JAX's ``in_axes`` batches the same
    field."""
    base = jra.art_mpc_config()
    v = np.asarray(getattr(base, field), np.float32)
    cfgs = [base, dataclasses.replace(base, **{field: jnp.asarray(v * 1.5 + 0.01)
                                               if v.ndim else float(v * 1.5 + 0.01)})]
    jm, axes = jsweep.stack_configs(cfgs)
    tm, per_env = tsweep.stack_configs([_port(tcfg.MpcConfig, c) for c in cfgs], device="cpu")
    batched = {p[0].name for p, _ in jax.tree_util.tree_flatten_with_path(axes)[0]}
    assert batched == set(per_env) == {field}
    assert per_env[field].dtype == torch.float32
    np.testing.assert_array_equal(per_env[field].numpy(), np.asarray(getattr(jm, field)))
    assert tm == _port(tcfg.MpcConfig, base)


@pytest.mark.parametrize("field,value", [
    ("cmd_body_frame", True),  # static in JAX: one program per value
    ("n_admm_iters", 20),
])
def test_stack_configs_rejects_mismatch(field, value):
    base = tra.art_mpc_config()
    with pytest.raises(ValueError, match=field):
        tsweep.stack_configs([base, dataclasses.replace(base, **{field: value})],
                             device="cpu")
    if field == "cmd_body_frame":
        with pytest.raises(ValueError):
            jsweep.stack_configs([jra.art_mpc_config(),
                                  jra.art_mpc_config(cmd_body_frame=True)])


def test_stack_configs_rejects_gait_mismatch():
    with pytest.raises(ValueError, match="clock_z_tol"):
        tsweep.stack_configs([tcfg.GaitConfig(), tcfg.GaitConfig(clock_z_tol=0.02)],
                             device="cpu")


def test_fused_tick_raises_on_per_env_values():
    """The tick kernel takes per-env gains and commands on flat ground (its
    per-env variant, ``tests/test_torch_sweep_kernel.py``) but holds one
    ``dt`` and, on a field, one config: the wrapper refuses a per-env
    ``dt`` and per-env values on a ``Terrain`` before it reaches a device,
    naming the plain chain."""
    mpc, gait = tra.art_config_for_speed(0.3, **BENCH)
    model = hector_model(device="cpu")
    w = tra.init_art_world(mpc, 2, device="cpu")
    z2, z = torch.zeros(2, 2), torch.zeros(2)
    args = (model, tbiped.BipedParams(), mpc, gait, w.sim, torch.zeros(2, 12), z2, z, z, z2,
            mass_matrix_inv(model, w.sim.q))
    bipeds = tbiped.BipedParams().expand(2)
    _, per_env = tsweep.stack_configs(
        [mpc, dataclasses.replace(mpc, kp_hipyaw=0.0, dt=0.035)], device="cpu")
    with pytest.raises(ValueError, match="per-env dt runs the plain chain"):
        tick_kernel.fused_tick(*args, per_env=per_env, bipeds=bipeds)
    fields = tterrain.Terrain(heights=torch.zeros(2, 4, 4))
    gains = {"kp_hipyaw": per_env["kp_hipyaw"]}
    with pytest.raises(ValueError, match="on a Terrain run the plain chain"):
        tick_kernel.fused_tick(*args, terrain=fields, per_env=gains, bipeds=bipeds)
    with pytest.raises(ValueError, match="on a Terrain run the plain chain"):
        tick_kernel.fused_tick(*args, terrain=fields, x_cmd=torch.zeros(2, 12), bipeds=bipeds)


def test_perturbed_worlds():
    mpc = tra.art_mpc_config()
    gen = torch.Generator().manual_seed(0)
    w = tsweep.perturbed_worlds(mpc, 64, gen, scale=2e-3, device="cpu")
    nominal = tra.init_art_world(mpc, 1, device="cpu")
    assert torch.equal(w.sim.q[0], nominal.sim.q[0])
    dq = (w.sim.q[1:] - nominal.sim.q).numpy()
    assert (np.abs(dq) > 0).all() and 1.5e-3 < dq.std() < 2.5e-3
    assert torch.equal(w.sim.pos, nominal.sim.pos.expand(64, 3))
    w0 = tsweep.perturbed_worlds(mpc, 3, gen, scale=0.0, device="cpu")
    assert torch.equal(w0.sim.q, nominal.sim.q.expand(3, 10))


TICK = dict(n_substeps=5, minv_ll_hold=8)


@functools.cache
def _gain_sweep():
    """3 configs x 2 ticks (``tests/test_sweep.py``'s slow case at the bench
    budget and physics): the port's config, per-env values and gait, the
    perturbed worlds (rows 0 and 1 equal configs on equal worlds), and
    ``jax.jit(art_sweep_fn)``'s result from the same worlds, once per
    module (the eager and the compiled sweep use it)."""
    base, jg = jra.art_config_for_speed(0.3, **BENCH)
    jcfgs = [dataclasses.replace(base, kp_hipyaw=k, kd_hipyaw=d)
             for k, d in ((2.4, 0.3), (2.4, 0.3), (0.0, 0.0))]
    tcfgs = [_port(tcfg.MpcConfig, c) for c in jcfgs]
    tm, per_env = tsweep.stack_configs(tcfgs, device="cpu")
    tg = _port(tcfg.GaitConfig, jg)
    worlds = tsweep.perturbed_worlds(tm, 3, torch.Generator().manual_seed(1), device="cpu")
    worlds = dataclasses.replace(worlds, sim=dataclasses.replace(
        worlds.sim, q=worlds.sim.q[[0, 0, 2]]))
    jm, axes = jsweep.stack_configs(jcfgs)
    jw = jax.vmap(lambda _: jra.init_art_world(base))(jnp.arange(3))
    jw = dataclasses.replace(jw, sim=dataclasses.replace(
        jw.sim, q=jnp.asarray(worlds.sim.q.numpy())))
    out_j = jax.jit(jsweep.art_sweep_fn(2, jg, axes, model=jsweep.hector_model(), **TICK))(
        jw, jbiped.BipedParams(), jm)
    return tcfgs, tm, per_env, tg, worlds, out_j


def _assert_sweep_chain(out, out_j):
    j, t = _fields(out_j), to_numpy(out)
    for key, tol in CHAIN_BOUNDS.items():
        err = float(np.abs(t["sim"][key] - j["sim"][key]).max())
        assert err < tol, (key, err)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])


def test_art_sweep_matches_jax_and_single_runs():
    """3 configs x 2 ticks: ``tests/test_sweep.py``'s slow case at the bench
    budget and physics, against ``art_sweep_fn`` from the same perturbed
    worlds, and each row against its config run alone."""
    tcfgs, tm, per_env, tg, worlds, out_j = _gain_sweep()
    bipeds = tbiped.BipedParams().expand(3)
    out = tsweep.art_sweep(worlds, bipeds, 2, tm, tg, per_env, **TICK)
    q = out.sim.q.numpy()
    assert np.isfinite(q).all() and out.metrics.falls.shape == (3,)
    np.testing.assert_array_equal(q[0], q[1])
    assert not np.allclose(q[0], q[2], atol=1e-5)
    _assert_sweep_chain(out, out_j)
    t = to_numpy(out)

    model = hector_model(device="cpu")
    for i, cfg in enumerate(tcfgs):
        w = worlds.map(lambda v: v[i:i + 1])
        for _ in range(2):
            w = tra.art_closed_loop_tick(w, cfg, tg, tbiped.BipedParams(), model, **TICK)
        for key, tol in CHAIN_BOUNDS.items():
            err = float(np.abs(to_numpy(w.sim)[key][0] - t["sim"][key][i]).max())
            assert err < tol, (i, key, err)

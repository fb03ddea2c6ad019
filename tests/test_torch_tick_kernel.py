"""The fused-tick kernel's wrapper and its entry point on the CPU, against
the JAX package.

No Pallas interpret run here: the JAX tick kernel's interpret mode takes
minutes on a CPU and needs 1024-env blocks. So the port's plain version is
held against the JAX package's plain reference of the tick instead, the
XLA sequence ``feedback_and_soles -> low_level_control -> art_step(Minv=)``
that ``tests/test_tick_kernel.py::test_fused_tick_parity`` uses as its
oracle, and the control math against the SoA function ``_control_tau``,
which runs without Pallas at any N. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Inputs are made with numpy from a seed.

Tolerances:
- (a) control: 2e-3 Nm on torques up to ~100 Nm (``test_control_tau_parity``'s
  bound; measured 1.5e-5 for both presets: the JAX SoA control carries
  polynomial atan2/asin);
- (b) one tick, 64 envs, 8 periods of 5 substeps: q, pos, quat 5e-4, qd
  2e-2, energy rtol 2e-3 / atol 1e-3 (``test_fused_tick_parity``'s bounds;
  measured q 6.0e-7, pos 6.0e-8, quat 7.5e-8, qd 1.5e-5, energy 6.8e-7
  relative);
- (c) the entry point, 8 envs x 3 ticks, against a JAX composition of the
  same tick: pos 2e-2, qd 2.0, zero falls on both sides
  (``test_kernel_rollout_matches_xla``'s bounds; measured pos 7.7e-7, qd
  5.6e-4); once on the fixed clock and once on the contact-sensed clock,
  where the gait time and the hold counts must also be equal.
"""

import dataclasses
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from biped_mpc_py_tpu.config import GaitConfig as JGaitConfig
from biped_mpc_py_tpu.control.lowlevel import low_level_control as jlowlevel
from biped_mpc_py_tpu.models.biped import BipedParams as JBipedParams
from biped_mpc_py_tpu.ops.pallas.tick_kernel import (
    _control_consts,
    _control_tau,
    _model_consts,
    _tick_consts,
)
from biped_mpc_py_tpu.parallel import rollout_art as jra
from biped_mpc_py_tpu.sim import engine as jeng
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.control.lowlevel import low_level_control
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops.cuda import build
from biped_mpc_py_torch.ops.cuda import tick_kernel as tk
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim import engine as teng
from biped_mpc_py_torch.tools import probe_cuda_ops as probe
from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
from tests.test_torch_sim import JM, TM, _close, _fields, _perturbed
from torch_threads import one_torch_thread  # noqa: F401

TICK_BOUNDS = {"q": 5e-4, "pos": 5e-4, "quat": 5e-4, "qd": 2e-2}


def _configs(preset):
    """(JAX MpcConfig, port MpcConfig) of ``test_control_tau_parity``'s two
    presets; "tick" is ``test_fused_tick_parity``'s config."""
    if preset == "default":
        jm = jra.art_mpc_config()
    elif preset == "tick":
        jm = jra.art_mpc_config(x_cmd=jnp.zeros(12).at[5].set(0.55).at[9].set(0.3))
    else:  # every knob the articulated stack uses
        jm = jra.art_mpc_config(
            x_cmd=jnp.zeros(12).at[5].set(0.55).at[9].set(0.3),
            swing_z_sin2=True, swing_track_ff=1.0, swing_retract=0.02,
            raibert_am_y=0.05, raibert_pitch_place=0.2, raibert_pitch_nom=0.15,
            capture_sched=0.5, raibert_vint=0.05, kp_pivot=1.5, kd_pivot=0.2,
            hipyaw_rate_lead=0.1, flight_yaw_kd=2.0, swing_td_overdrive=0.01,
            cmd_body_frame=True,
        )
    return jm, from_numpy(tcfg.MpcConfig, _fields(jm))


def _controls(n, seed):
    """u0 (N,12), c0 (N,2) mixed stance/swing flags, t (N,) in [0, 0.4),
    cmd_yaw (N,), v_int (N,2), as f32 numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (30.0 * rng.normal(size=(n, 12))).astype(f32),
        (rng.random((n, 2)) < 0.5).astype(f32),
        (0.4 * rng.random(n)).astype(f32),
        (0.3 * rng.normal(size=n)).astype(f32),
        (0.1 * rng.normal(size=(n, 2))).astype(f32),
    )


def _port_tau(mpc, gait, state, u0, c0, t_ll, cmd_yaw, v_int):
    """The port's control of one period, fed as ``fused_tick_reference``
    feeds it."""
    x, pf = teng.feedback_and_soles(TM, state)
    zero = torch.zeros_like(cmd_yaw)
    return low_level_control(
        x, t_ll, pf, state.q, state.qd, mpc, BipedParams().expand(len(t_ll)), c0[:, None, :],
        u0, gait=gait, cmd_ref=torch.stack([zero, zero, cmd_yaw], -1), v_int=v_int,
    )


@pytest.mark.parametrize("preset", ["default", "loaded"])
def test_control_matches_soa_control_tau(preset):
    """256 perturbed states, mixed c0 flags: the port's low-level control
    against the JAX tick kernel's SoA ``_control_tau`` (2e-3 Nm)."""
    n = 256
    jm, tm = _configs(preset)
    js, ts, _ = _perturbed(n, 11)
    u0, c0, t_ll, cmd_yaw, v_int = _controls(n, 12)
    carry = (
        tuple(js.pos[:, i] for i in range(3)), tuple(js.quat[:, i] for i in range(4)),
        tuple(js.v_base[:, i] for i in range(3)), tuple(js.v_base[:, 3 + i] for i in range(3)),
        tuple(js.q[:, i] for i in range(10)), tuple(js.qd[:, i] for i in range(10)),
    )
    want = jnp.stack(_control_tau(
        carry, tuple(jnp.asarray(u0[:, i]) for i in range(12)),
        (jnp.asarray(c0[:, 0]), jnp.asarray(c0[:, 1])), jnp.asarray(t_ll),
        jnp.asarray(cmd_yaw), (jnp.asarray(v_int[:, 0]), jnp.asarray(v_int[:, 1])),
        _model_consts(JM), _tick_consts(JM),
        _control_consts(jm, JGaitConfig(steps_per_phase=3), JBipedParams()),
    ), axis=1)
    got = _port_tau(tm, tcfg.GaitConfig(steps_per_phase=3), ts, *map(torch.tensor, (
        u0, c0, t_ll, cmd_yaw, v_int)))
    _close(got, want, 2e-3, name="tau")


def _jax_plain_tick(jm, jg, js, u0, c0, t0, cmd_yaw, v_int, Minv, n_ll=8, n_sub=5):
    """The JAX plain tick: per period, feedback_and_soles ->
    low_level_control at t0 + p ll_dt -> art_step(Minv=) (one period jitted,
    looped here), then t + dt. Returns (state, energy)."""
    h, ll_dt, biped = jm.h, jm.dt / n_ll, JBipedParams()

    def one(s, t, u, c, cy, vi, mi):
        x, pf = jeng.feedback_and_soles(JM, s)
        tau = jlowlevel(
            x, t, pf, s.q, s.qd, jm, biped, jnp.broadcast_to(c, (h, 2)), u, gait=jg,
            cmd_ref=jnp.stack([jnp.zeros(()), jnp.zeros(()), cy]), v_int=vi,
        )
        e = jnp.sum(jnp.maximum(tau * s.qd, 0.0)) * ll_dt
        return jeng.art_step(JM, s, tau, ll_dt, n_sub, None, Minv=mi), e

    period = jax.jit(jax.vmap(one))
    s, energy = js, jnp.zeros_like(t0)
    for p in range(n_ll):
        s, e = period(s, t0 + p * ll_dt, u0, c0, cmd_yaw, v_int, Minv)
        energy = energy + e
    return dataclasses.replace(s, t=js.t + jm.dt), energy


def test_tick_reference_matches_jax_plain_tick():
    """64 perturbed envs, random clocks and flags, one tick of 8 periods x
    5 substeps with the tick-held Minv: ``fused_tick_reference`` against
    the JAX plain tick, at ``test_fused_tick_parity``'s bounds."""
    n = 64
    jm, tm = _configs("tick")
    jg, tg = JGaitConfig(steps_per_phase=5), tcfg.GaitConfig(steps_per_phase=5)
    js, ts, _ = _perturbed(n, 13)
    u0, c0, t0, cmd_yaw, v_int = _controls(n, 14)
    js = dataclasses.replace(js, t=jnp.asarray(t0))
    ts = dataclasses.replace(ts, t=torch.tensor(t0))
    Minv = jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q))(js.q)
    want, e_want = _jax_plain_tick(jm, jg, js, *map(jnp.asarray, (u0, c0, t0, cmd_yaw, v_int)),
                                   Minv)
    got, energy = tk.fused_tick_reference(
        TM, BipedParams(), tm, tg, ts, *map(torch.tensor, (u0, c0, t0, cmd_yaw, v_int)),
        torch.tensor(np.asarray(Minv)))
    for name, tol in TICK_BOUNDS.items():
        _close(getattr(got, name), getattr(want, name), tol, name=name)
    np.testing.assert_allclose(energy.numpy(), np.asarray(e_want), rtol=2e-3, atol=1e-3)
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_tick_kernel_entry_point_matches_jax():
    """8 envs x 3 ticks of ``batched_art_rollout_tick_kernel`` (on the CPU:
    the kernel's plain version) against the JAX composition of the same
    tick: ``_art_control_stage``, ``mass_matrix_inv``, the plain tick,
    ``_art_post_stage``."""
    _entry_point_against_jax(contact_clock=False)


def test_tick_kernel_entry_point_contact_clock_matches_jax():
    """The same with ``contact_clock=True``: the tick's control clock starts
    at the (possibly held) gait time ``t_g``, not at the state's ``t``."""
    _entry_point_against_jax(contact_clock=True)


def _entry_point_against_jax(contact_clock, rollout=tra.batched_art_rollout_tick_kernel, n=8):
    """``rollout(worlds, bipeds, ticks, mpc, gait)`` on the CPU against the
    JAX composition of the tick (``n`` envs x 3 ticks)."""
    ticks = 3
    jm, jg = jra.art_config_for_speed(
        0.3, n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10)
    jg = dataclasses.replace(jg, contact_clock=contact_clock)
    rng = np.random.default_rng(0)
    jw = jax.vmap(lambda _: jra.init_art_world(jm))(jnp.arange(n))
    qd = jw.sim.qd + jnp.asarray(0.01 * rng.normal(size=(n, 10)), jnp.float32)
    jw = dataclasses.replace(jw, sim=dataclasses.replace(jw.sim, qd=qd))
    jb = jax.vmap(lambda _: JBipedParams())(jnp.arange(n))
    tm, tg = from_numpy(tcfg.MpcConfig, _fields(jm)), from_numpy(tcfg.GaitConfig, _fields(jg))
    tw, tb = from_numpy(tra.ArtWorld, _fields(jw)), from_numpy(BipedParams, _fields(jb))

    control = jax.jit(jax.vmap(lambda w, b: jra._art_control_stage(w, b, jm, jg, JM)))
    minv = jax.jit(jax.vmap(lambda q: jeng.mass_matrix_inv(JM, q)))
    post = jax.jit(jax.vmap(lambda w, s, e, x, so, tg_, h: jra._art_post_stage(
        w, s, e, x, so, tg_, h, jm)))
    w = jw
    for _ in range(ticks):
        x_fb, t_g, hold, contact, sol = control(w, jb)
        sim_new, energy = _jax_plain_tick(
            jm, jg, w.sim, sol.controls[:, 0], contact[:, 0, 0:2],
            t_g if contact_clock else w.sim.t,
            w.ctrl.cmd_ref[:, 2], w.ctrl.v_int, minv(w.sim.q))
        w = post(w, sim_new, energy, x_fb, sol, t_g, hold)

    before = tk.fused_tick.launches
    out = rollout(tw, tb, ticks, tm, tg)
    assert tk.fused_tick.launches == before  # CPU: no launch
    j, t = _fields(w), to_numpy(out)
    assert float(t["metrics"]["falls"].sum()) == 0 and float(j["metrics"]["falls"].sum()) == 0
    _close(out.sim.pos, j["sim"]["pos"], 2e-2, name="pos")
    _close(out.sim.qd, j["sim"]["qd"], 2.0, name="qd")
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["ctrl"]["t_gait"], j["ctrl"]["t_gait"])
    np.testing.assert_array_equal(t["ctrl"]["hold_count"], j["ctrl"]["hold_count"])
    np.testing.assert_allclose(t["metrics"]["energy"], j["metrics"]["energy"], rtol=2e-3)


def test_fused_tick_wrapper_on_cpu():
    """On CPU tensors the wrapper runs the plain version, for any number of
    envs (here 7), counts no launch, and checks its inputs and its scope."""
    n = 7
    _, tm = _configs("tick")
    gait = tcfg.GaitConfig(steps_per_phase=5)
    _, ts, _ = _perturbed(n, 15)
    args = tuple(map(torch.tensor, _controls(n, 16)))
    Minv = teng.mass_matrix_inv(TM, ts.q)
    before = tk.fused_tick.launches
    out, energy = tk.fused_tick(TM, BipedParams(), tm, gait, ts, *args, Minv)
    ref, e_ref = tk.fused_tick_reference(TM, BipedParams(), tm, gait, ts, *args, Minv)
    assert tk.fused_tick.launches == before
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name)), f.name
    assert torch.equal(energy, e_ref) and energy.shape == (n,)
    assert torch.allclose(out.t, ts.t + tm.dt)

    def call(biped=BipedParams(), gait=gait, terrain=None, **kw):
        a = dict(zip(("u0", "c0", "t0", "cmd_yaw", "v_int"), args), Minv=Minv) | kw
        return tk.fused_tick(TM, biped, tm, gait, ts, **a, terrain=terrain)

    with pytest.raises(ValueError, match="shape"):
        call(u0=args[0][:, :11])
    with pytest.raises(TypeError, match="float32"):
        call(Minv=Minv.double())
    with pytest.raises(ValueError, match="walking"):
        call(gait=tcfg.GaitConfig(steps_per_phase=2, flight_steps=1))
    with pytest.raises(ValueError, match="flat ground"):
        call(terrain=object())
    with pytest.raises(ValueError, match="one robot"):
        call(biped=BipedParams().expand(n))


def test_tick_constants_layout():
    """The tick buffer matches csrc/tick.cu's layout: the Ctrl enum names
    CONTROL_NAMES in order, and the values are the model's and config's."""
    enum = re.search(r"enum Ctrl \{(.*?)\};", tk.SOURCE.read_text(), re.S).group(1)
    names = [e.strip()[1:].lower() for e in enum.split(",") if e.strip()]
    assert names[-1] == "nctrl"
    assert names[:-1] == [n.replace("_", "").lower() for n in tk.CONTROL_NAMES]
    _, tm = _configs("loaded")
    gait = tcfg.GaitConfig(steps_per_phase=3)
    buf = tk.tick_constants(TM, BipedParams(), tm, gait, "cpu")
    assert buf.shape == (tk.N_TICK_CONSTS,) and buf.dtype == torch.float32
    assert torch.equal(buf[:11], TM.mass) and torch.equal(buf[11:44], TM.com.reshape(-1))
    assert float(buf[44]) == float(TM.contact_points[0, 2])
    ctrl = dict(zip(tk.CONTROL_NAMES, buf[46:].tolist()))
    assert ctrl["t_p"] == pytest.approx(0.12) and ctrl["xc9"] == pytest.approx(0.3)
    assert ctrl["l_foot"] == pytest.approx(float(BipedParams().jac_geometry.l_foot[0]))
    assert tk._flags(tm) == tk.FLAG_SIN2 | tk.FLAG_CMD_BODY_FRAME


def test_library_name_follows_headers(tmp_path):
    """A kernel's library is named by its source and the headers beside it:
    editing only a header renames it (a stale build is not reused)."""
    src, hdr = tmp_path / "tick.cu", tmp_path / "substep_device.cuh"
    src.write_text(build.CSRC.joinpath("tick.cu").read_text())
    hdr.write_text(build.CSRC.joinpath("substep_device.cuh").read_text())
    first = build._library_path(src)
    assert first == build._library_path(src)
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    second = build._library_path(src)
    assert second != first and second.parent == build.BUILD_DIR
    assert second.name.startswith("libtick_") and second.suffix == ".so"


@pytest.mark.parametrize("op", probe.OPS)
def test_probe_oracle(op):
    """The CUDA probe's numpy oracle (its plain version) against torch on
    the CPU, and the probe wrapper on CPU tensors: the oracle, no launch.
    The kernels themselves run in chip_smoke.py."""
    a, b = probe.inputs()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d = probe.oracle(op, a, b)
    if op == "asin":
        want = torch.asin(torch.clamp(ta.double() * 0.3, -1.0, 1.0))
    elif op == "remainder":
        want = torch.remainder(ta.double(), float(probe.DIVISOR))
        assert (d >= 0).all() and (d < probe.DIVISOR).all()
    elif op == "nested":
        want = ta.clone()
        for i in range(8):
            for _ in range(5):
                want = want + 0.01 * torch.sin(want)
            want = want + 0.1 * (i + 1)
    else:
        want = torch.atan2(ta.double(), tb.double())
    _close(want, d, probe.TOLERANCE[op], name=op)
    before = probe.probe_op.launches
    got = probe.probe_op(op, ta, tb)
    assert probe.probe_op.launches == before and got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(d.astype(np.float32)))
    with pytest.raises(ValueError, match="unknown"):
        probe.probe_op("sqrt", ta, tb)

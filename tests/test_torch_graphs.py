"""The compiled entry points (``*_fn``: one tick captured as a CUDA graph on
the card, the same static-buffer step on the CPU) and what makes a tick
capture-safe, on the CPU.

- Each ``*_fn`` is bit-equal to its eager loop (``batched_rollout``,
  ``batched_cmd_rollout``, ``batched_art_rollout_tick_kernel``,
  ``batched_art_rollout_kernel``, and on the plain chain at the bench
  physics ``batched_art_rollout``, ``batched_art_rollout_terrain`` on
  per-env fields with the contact-sensed clock, ``art_sweep`` with per-env
  gains, ADMM numerics and commands), pure (a second call gives the same
  result, the inputs are unchanged, the result aliases no graph buffer).
- ``graphed`` copies a dict of per-env values in on every call, and keys
  its graphs on a ``Terrain``'s ``extent``: a call with other values, or
  another extent, gives that call's own result.
- The N = 1 graphs: ``MjController`` (the MuJoCo loop's controller) against
  the same calls made eagerly, ``rollout_qpos_track``'s frames against an
  eager loop of ``art_closed_loop_tick``, the demo's graphed tick against
  ``control_tick``, all bit-equal.
- ``batched_rollout_fn`` against ``jax.jit`` of the JAX factory, 4
  randomized envs x 3 ticks, at the bounds of
  ``tests/test_torch_rollout.py::test_rollout_matches_jax_pointwise``
  (x_fb, foot atol 2e-3; clocks, falls and step counts equal; attitude
  error rtol 1e-2); ``batched_art_rollout_tick_kernel_fn`` against the JAX
  composition of the tick at the bounds of
  ``tests/test_torch_tick_kernel.py::test_tick_kernel_entry_point_matches_jax``
  (pos 2e-2, qd 2.0), 4 envs x 3 ticks. Inputs from a numpy seed, carried
  across by ``utils/convert.py``.
- After a warm-up tick, a steady tick of each loop, of ``RealtimeLoop``
  and of ``MjController`` calls ``host_to_device`` no time and makes no tensor of more than one
  element from host data (what a capture would bake in as a host address).
- ``config_tensor``'s memo and the kernels' constant caches.

The graphs themselves (capture, replay, launch counts) are on the card:
``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 22.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import biped_mpc_py_torch as bt
from biped_mpc_py_torch import config as tcfg
from biped_mpc_py_torch.ops.cuda import qp_kernel
from biped_mpc_py_torch.ops.cuda import substep_kernel as sk
from biped_mpc_py_torch.ops.cuda import tick_kernel as tk
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.sim import mj_driver as tmj
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.engine import ArtState
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils import device as tdevice
from biped_mpc_py_torch.utils.graphs import TickGraph, graphed, leaves
from torch_threads import one_torch_thread  # noqa: F401

N = 4
CPU = torch.device("cpu")


def _srb_inputs(seed=0):
    mpc = bt.fast_mpc_config(x_cmd=(0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0))
    rng = np.random.default_rng(seed)
    w = bt.batch_worlds(mpc, N, device=CPU)
    x = w.sim.x_fb + torch.from_numpy(0.01 * rng.normal(size=(N, 12)).astype(np.float32))
    w = dataclasses.replace(w, sim=dataclasses.replace(w.sim, x_fb=x))
    b = bt.randomize_params(torch.Generator().manual_seed(seed), N, device=CPU)
    x_cmd = torch.zeros(N, 12)
    x_cmd[:, 5], x_cmd[:, 9] = 0.55, torch.linspace(0.0, 0.4, N)
    return mpc, bt.GaitConfig(), w, b, x_cmd


def _art_inputs(seed=0):
    mpc, gait = bt.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                        admm_polish=False, kinv_ns_iters=10)
    rng = np.random.default_rng(seed)
    w = bt.init_art_world(mpc, N, device=CPU)
    qd = w.sim.qd + torch.from_numpy(0.01 * rng.normal(size=(N, 10)).astype(np.float32))
    w = dataclasses.replace(w, sim=dataclasses.replace(w.sim, qd=qd))
    return mpc, gait, w, bt.BipedParams().expand(N)


KW = dict(n_substeps=5, minv_ll_hold=8)  # the bench physics


def _sweep_inputs(mpc):
    """4 configs that differ in gains, ADMM numerics and command."""
    configs = [dataclasses.replace(mpc, kp_hipyaw=k, admm_rho=r, x_cmd=tuple(
        v + (0.1 * i if j == 9 else 0.0) for j, v in enumerate(mpc.x_cmd)))
        for i, (k, r) in enumerate(((2.4, 0.3), (0.0, 1.0), (1.2, 0.1), (2.4, 0.3)))]
    return bt.stack_configs(configs, device=CPU)


def _paths():
    """{name: (eager(k) -> world, factory(k) -> fn, the fn's inputs)}."""
    mpc, gait, w, b, x_cmd = _srb_inputs()
    am, ag, aw, ab = _art_inputs()
    clock = dataclasses.replace(ag, contact_clock=True)
    fields = dataclasses.replace(
        Terrain.rough_batch(torch.Generator().manual_seed(1), N, amplitude=0.06, res=16,
                            device=CPU), extent=2.0)
    sm, per_env = _sweep_inputs(am)
    return {
        "srb": (lambda k: bt.batched_rollout(w, b, k, mpc, gait),
                lambda k: bt.batched_rollout_fn(k, mpc, gait), (w, b)),
        "cmd": (lambda k: bt.batched_cmd_rollout(w, b, x_cmd, k, mpc, gait),
                lambda k: bt.batched_cmd_rollout_fn(k, mpc, gait), (w, b, x_cmd)),
        "tick": (lambda k: bt.batched_art_rollout_tick_kernel(aw, ab, k, am, ag),
                 lambda k: bt.batched_art_rollout_tick_kernel_fn(k, am, ag), (aw, ab)),
        "substep": (lambda k: bt.batched_art_rollout_kernel(aw, ab, k, am, ag),
                    lambda k: bt.batched_art_rollout_kernel_fn(k, am, ag), (aw, ab)),
        "plain": (lambda k: bt.batched_art_rollout(aw, ab, k, am, ag, **KW),
                  lambda k: bt.batched_art_rollout_fn(k, am, ag, **KW), (aw, ab)),
        "terrain": (lambda k: bt.batched_art_rollout_terrain(aw, ab, fields, k, am, clock, **KW),
                    lambda k: bt.batched_art_rollout_terrain_fn(k, am, clock, **KW),
                    (aw, ab, fields)),
        "sweep": (lambda k: bt.art_sweep(aw, ab, k, sm, ag, per_env, **KW),
                  lambda k: bt.art_sweep_fn(k, sm, ag, **KW), (aw, ab, per_env)),
    }


TICKS = {"srb": 3, "cmd": 3, "tick": 2, "substep": 2, "plain": 1, "terrain": 1, "sweep": 1}


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("path", list(TICKS))
def test_fn_is_bit_equal_to_eager_and_pure(path):
    eager, factory, inputs = _paths()[path]
    k = TICKS[path]
    before = [t.clone() for t in leaves(inputs)]
    fn = factory(k)
    out = fn(*inputs)
    assert _equal(out, eager(k)), "the fn differs from its eager loop"
    assert _equal(fn(*inputs), out), "a second call differs"
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(inputs))), "inputs changed"
    (graph,) = fn.graphs.values()
    buffers = {t.untyped_storage().data_ptr() for t in leaves((graph.carry, graph.consts))}
    assert not buffers & {t.untyped_storage().data_ptr() for t in leaves(out)}
    assert graph.graph is None and graph.launches == {}  # CPU: no capture


def test_rollout_fn_matches_jax():
    import jax

    from biped_mpc_py_tpu import config as jcfg
    from biped_mpc_py_tpu.parallel import rollout as jroll
    from biped_mpc_py_tpu.utils.precision import f32_precision
    from biped_mpc_py_torch.models.biped import BipedParams
    from biped_mpc_py_torch.utils.convert import from_numpy, to_numpy
    from tests.test_torch_rollout import X_CMD, _fields, _matched, _start

    n, ticks = N, 3
    jm = _matched(jcfg.fast_mpc_config(x_cmd=jax.numpy.asarray(X_CMD)))
    jw, jb = _start(jm, n, randomized=True)
    out_j = jax.jit(f32_precision(jroll.batched_rollout_fn(ticks, jm, jcfg.GaitConfig())))(jw, jb)
    tm = from_numpy(tcfg.MpcConfig, _fields(jm))
    before = qp_kernel.fused_qp_solve.launches
    out_t = troll.batched_rollout_fn(ticks, tm, tcfg.GaitConfig())(
        from_numpy(troll.World, _fields(jw)), from_numpy(BipedParams, _fields(jb)))
    assert qp_kernel.fused_qp_solve.launches == before  # CPU tensors: plain version
    j, t = _fields(out_j), to_numpy(out_t)
    np.testing.assert_allclose(t["sim"]["x_fb"], j["sim"]["x_fb"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(t["sim"]["foot"], j["sim"]["foot"], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t["sim"]["t"], j["sim"]["t"])
    np.testing.assert_array_equal(t["metrics"]["falls"], j["metrics"]["falls"])
    np.testing.assert_array_equal(t["metrics"]["n_steps"], j["metrics"]["n_steps"])
    np.testing.assert_allclose(
        t["metrics"]["attitude_err_sq"], j["metrics"]["attitude_err_sq"], rtol=1e-2, atol=1e-5
    )


def test_tick_kernel_fn_matches_jax():
    from tests.test_torch_tick_kernel import _entry_point_against_jax

    def rollout(worlds, bipeds, ticks, mpc, gait):
        return tra.batched_art_rollout_tick_kernel_fn(ticks, mpc, gait)(worlds, bipeds)

    _entry_point_against_jax(contact_clock=False, rollout=rollout, n=N)


class _HostData(TorchDispatchMode):
    """Counts the tensors of more than one element made from host data
    (``torch.tensor``, ``torch.as_tensor`` of a sequence or an array)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default and out.numel() > 1:
            self.made.append(tuple(out.shape))
        return out


class _Plant:
    """A plant that stands still: fixed readings, torques ignored."""

    def read_state(self):
        x = np.zeros(12)
        x[5] = 0.53
        return x, np.array([0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2), np.zeros(10)

    def foot_positions(self):
        return np.array([-0.02, 0.09, 0.0, -0.02, -0.09, 0.0])

    def apply(self, tau, dt):
        pass


def _controller_config():
    """The bench articulated config with the foot-frame wrench rows (the
    solve then reads the hip-yaw angles of the read)."""
    mpc, _ = bt.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                     admm_polish=False, kinv_ns_iters=10,
                                     foot_frame_wrench=True)
    return mpc


def _standing_read():
    """MuJoCo's qpos (17,) and qvel (16,) of the standing robot."""
    s = ArtState.standing()
    qpos = torch.cat([s.pos[0], s.quat[0], s.q[0]]).double().numpy()
    return qpos, np.zeros(16)


@pytest.mark.parametrize("path", list(TICKS) + ["realtime", "mujoco"])
def test_steady_tick_makes_no_host_copy(path, monkeypatch):
    if path == "realtime":
        mpc, _ = bt.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                         admm_polish=False, kinv_ns_iters=10)
        loop = bt.RealtimeLoop(mpc, bt.GaitConfig(), bt.BipedParams(), device=CPU)
        plant = _Plant()
        loop.warmup(plant)

        def tick():
            loop.run(plant, 1, realtime=False)
    elif path == "mujoco":
        ctl = tmj.MjController(_controller_config(), bt.GaitConfig(), device=CPU)
        read = _standing_read()

        def tick():
            ctl.tick(lambda: read, lambda tau: None, 0.0)
    else:
        _, factory, inputs = _paths()[path]
        fn = factory(1)

        def tick():
            fn(*inputs)
    tick()  # warm-up: the constants are made here
    calls = []

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    real = tdevice.host_to_device
    monkeypatch.setattr(tdevice, "host_to_device", counting)
    monkeypatch.setattr(tcfg, "host_to_device", counting)
    with _HostData() as mode:
        tick()
    assert calls == [] and mode.made == []


def test_config_tensor_is_memoized():
    like = torch.zeros(3)
    a = tcfg.config_tensor((0.1, 0.2, 0.3), like)
    assert tcfg.config_tensor([0.1, 0.2, 0.3], like) is a
    assert tcfg.config_tensor(np.array([0.1, 0.2, 0.3]), like) is a
    assert tcfg.config_tensor((0.1, 0.2, 0.4), like) is not a
    assert tcfg.config_tensor((0.1, 0.2, 0.3), like.double()).dtype == torch.float64
    assert torch.equal(a, torch.tensor([0.1, 0.2, 0.3]))
    # ArtState.standing builds its joint vector through the memo: the same
    # values as a fresh tensor, no host-to-device copy after the first call
    s1, s2 = ArtState.standing(2), ArtState.standing(3)
    assert torch.equal(s1.q[0], s2.q[2])
    assert torch.equal(s1.q[0], torch.tensor([0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2,
                                             dtype=torch.float32))


def test_constant_caches_keep_every_config():
    """The kernels' constant buffers are cached per set of objects and never
    evicted: a second config does not free the first's buffers (a captured
    graph would read freed memory)."""
    model, biped = hector_model(device=CPU), bt.BipedParams()
    gait = bt.GaitConfig()
    m1, m2 = bt.art_mpc_config(), bt.art_mpc_config(kp_hipyaw=1.0)
    c1 = tk._constants(model, biped, m1, gait, CPU)
    c2 = tk._constants(model, biped, m2, gait, CPU)
    assert tk._constants(model, biped, m1, gait, CPU)[1] is c1[1]
    assert tk._constants(model, biped, m2, gait, CPU)[1] is c2[1]
    assert not torch.equal(c1[1], c2[1])
    other = hector_model(device=CPU)
    s1, s2 = sk._constants(model, CPU), sk._constants(other, CPU)
    assert sk._constants(model, CPU) is s1 and sk._constants(other, CPU) is s2
    assert s1 is not s2 and torch.equal(s1, s2)


def test_tick_graph_copies_passed_on_inputs_first():
    """A step that passes an input on into another field (as
    ``RealtimeLoop``'s solve keeps the tick's old ``v_int``) reads it before
    the copy back overwrites it; a result of another shape raises."""
    carry = (torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))
    g = TickGraph(lambda c: (c[0] + 1.0, c[0]), carry)
    g.replay(2)
    assert carry[0].tolist() == [3.0, 4.0] and carry[1].tolist() == [2.0, 3.0]
    bad = TickGraph(lambda c: (c[0][:1], c[1]), carry)
    with pytest.raises(ValueError, match="structure"):
        bad.replay()


def test_graphed_copies_per_env_values_in_on_every_call():
    """A dict of per-env values is an input of the graph: a second call with
    other values of the same shapes gives its own result, from the same
    graph."""

    def step(c, per_env):
        return c * per_env["gain"] + per_env["bias"]

    fn = graphed(step, 2)
    c = torch.tensor([1.0, 2.0, 3.0])
    for gain in (2.0, -0.5):
        per_env = {"gain": torch.full((3,), gain), "bias": torch.tensor([0.1, 0.2, 0.3])}
        assert torch.equal(fn(c, per_env), step(step(c, per_env), per_env))
    assert len(fn.graphs) == 1


def test_graphed_keys_on_a_terrains_extent():
    """A ``Terrain``'s ``extent`` is a Python float that a capture bakes in:
    another extent is another graph, as a new static value retraces a
    ``jax.jit``."""

    def step(x, terrain):
        return terrain.height(x, 0.5 * x)

    heights = torch.arange(32.0).reshape(2, 4, 4)
    x = torch.tensor([0.3, -0.7])
    fn = graphed(step, 1)
    for extent in (2.0, 4.0, 2.0):
        terrain = Terrain(heights=heights, extent=extent)
        assert torch.equal(fn(x, terrain), step(x, terrain))
    assert len(fn.graphs) == 2


def test_mj_controller_is_the_eager_controller():
    """``MjController.tick`` (three graphs, the command a buffer) against
    the same calls made eagerly on the same reads, over 3 ticks of a fixed
    standing read with a command switch after the first: the feedback
    states and every period's torques bit-equal."""
    from biped_mpc_py_torch.control.controller import (
        ControllerState,
        advance_cmd_ref,
        advance_pitch_ref,
        advance_v_int,
    )
    from biped_mpc_py_torch.control.gait import contact_sequence
    from biped_mpc_py_torch.control.lowlevel import low_level_control
    from biped_mpc_py_torch.control.mpc import solve_mpc
    from biped_mpc_py_torch.sim.engine import feedback_and_soles

    mpc, gait = _controller_config(), bt.GaitConfig()
    model, biped = hector_model(device=CPU), bt.BipedParams()
    qpos, qvel = _standing_read()
    rng = np.random.default_rng(0)
    qvel = qvel + 0.05 * rng.normal(size=16)
    cmds = [torch.tensor(mpc.x_cmd, dtype=torch.float32)] * 2
    cmds[1] = cmds[1].clone()
    cmds[1][9] = 0.1
    ctl = tmj.MjController(mpc, gait, model, biped, device=CPU)
    ctrl = ControllerState.init(mpc)
    for k, t in enumerate((0.0, 0.04, 0.08)):
        x_cmd = cmds[min(k, 1)]
        if k == 1:
            ctl.set_command(x_cmd.numpy())
        got = []
        x_g = ctl.tick(lambda: (qpos, qvel), got.append, t)
        s = tmj._state_from_read(torch.from_numpy(
            np.concatenate([qpos, qvel, [t]]).astype(np.float32))[None])
        x, pf = feedback_and_soles(model, s)
        contact = contact_sequence(s.t, mpc, gait)
        sol = solve_mpc(x, s.t, pf, mpc, biped, contact, warm=ctrl.qp, gait=gait,
                        cmd_ref=ctrl.cmd_ref, foot_yaw=x[:, 2:3] + s.q[:, 0:6:5],
                        v_int=ctrl.v_int, pitch_ref=ctrl.pitch_ref, x_cmd=x_cmd)
        tau = low_level_control(x, s.t, pf, s.q, s.qd, mpc, biped, contact,
                                sol.controls[:, 0], gait=gait, cmd_ref=ctrl.cmd_ref,
                                v_int=ctrl.v_int, x_cmd=x_cmd)
        ctrl = ControllerState(qp=sol, cmd_ref=advance_cmd_ref(ctrl.cmd_ref, x, mpc, x_cmd),
                               v_int=advance_v_int(ctrl.v_int, x, mpc, x_cmd),
                               pitch_ref=advance_pitch_ref(ctrl.pitch_ref, x, mpc))
        assert torch.equal(x_g, x)
        assert len(got) == tmj.N_LL and all(np.array_equal(g, tau[0].numpy()) for g in got)
    assert torch.equal(ctl.state.qp.controls, ctrl.qp.controls)


def test_replay_frames_are_the_eager_loops():
    """``rollout_qpos_track`` (the plain chain's tick on a graph at N = 1,
    frames gathered on the device) against a loop of
    ``art_closed_loop_tick``: every frame and time bit-equal."""
    from biped_mpc_py_torch.sim.replay import rollout_qpos_track

    mpc, gait, _, _ = _art_inputs()
    qpos, times, falls = rollout_qpos_track(mpc, gait, 3, device=CPU, **KW)
    model, biped = hector_model(device=CPU), bt.BipedParams()
    w = bt.init_art_world(mpc, 1, device=CPU)
    frames = []
    for _ in range(3):
        w = tra.art_closed_loop_tick(w, mpc, gait, biped, model, **KW)
        frames.append((torch.cat([w.sim.pos, w.sim.quat, w.sim.q], -1)[0], w.sim.t[0]))
    assert np.array_equal(qpos, torch.stack([f for f, _ in frames]).numpy())
    assert np.array_equal(times, torch.stack([t for _, t in frames]).numpy())
    assert falls == float(w.metrics.falls[0])


def test_demo_tick_is_control_tick():
    """The demo's graphed tick replays ``control_tick``'s torques, states
    and controls bit for bit, twice."""
    from biped_mpc_py_torch.control.controller import control_tick
    from biped_mpc_py_torch.demo import compiled_tick

    mpc, gait, biped = tcfg.MpcConfig(), bt.GaitConfig(), bt.BipedParams()
    x = torch.tensor([[0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0, 0, 0]], dtype=torch.float32)
    q = torch.tensor([[0, 0, -np.pi / 4, np.pi / 2, -np.pi / 4] * 2], dtype=torch.float32)
    qd, t = torch.zeros(1, 10), torch.zeros(1)
    tau, _, sol = control_tick(x, q, qd, t, mpc, gait, biped)
    tick = compiled_tick(x, q, qd, t, mpc, gait, biped)
    for _ in range(2):
        tick.replay()
        assert all(torch.equal(a, b) for a, b in zip(tick.carry[4:],
                                                     (tau, sol.states, sol.controls)))

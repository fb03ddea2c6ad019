"""The compiled entry points (``*_fn``: one tick captured as a CUDA graph on
the card, the same static-buffer step on the CPU) and what makes a tick
capture-safe, on the CPU.

- Each ``*_fn`` is bit-equal to its eager loop (``batched_rollout``,
  ``batched_cmd_rollout``, ``batched_art_rollout_tick_kernel``,
  ``batched_art_rollout_kernel``), pure (a second call gives the same
  result, the inputs are unchanged, the result aliases no graph buffer).
- ``batched_rollout_fn`` against ``jax.jit`` of the JAX factory, 4
  randomized envs x 3 ticks, at the bounds of
  ``tests/test_torch_rollout.py::test_rollout_matches_jax_pointwise``
  (x_fb, foot atol 2e-3; clocks, falls and step counts equal; attitude
  error rtol 1e-2); ``batched_art_rollout_tick_kernel_fn`` against the JAX
  composition of the tick at the bounds of
  ``tests/test_torch_tick_kernel.py::test_tick_kernel_entry_point_matches_jax``
  (pos 2e-2, qd 2.0), 4 envs x 3 ticks. Inputs from a numpy seed, carried
  across by ``utils/convert.py``.
- After a warm-up tick, a steady tick of each loop and of ``RealtimeLoop``
  calls ``host_to_device`` no time and makes no tensor of more than one
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
from biped_mpc_py_torch.sim.engine import ArtState
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils import device as tdevice
from biped_mpc_py_torch.utils.graphs import TickGraph, _leaves

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


def _paths():
    """{name: (eager(k) -> world, factory(k) -> fn, the fn's inputs)}."""
    mpc, gait, w, b, x_cmd = _srb_inputs()
    am, ag, aw, ab = _art_inputs()
    return {
        "srb": (lambda k: bt.batched_rollout(w, b, k, mpc, gait),
                lambda k: bt.batched_rollout_fn(k, mpc, gait), (w, b)),
        "cmd": (lambda k: bt.batched_cmd_rollout(w, b, x_cmd, k, mpc, gait),
                lambda k: bt.batched_cmd_rollout_fn(k, mpc, gait), (w, b, x_cmd)),
        "tick": (lambda k: bt.batched_art_rollout_tick_kernel(aw, ab, k, am, ag),
                 lambda k: bt.batched_art_rollout_tick_kernel_fn(k, am, ag), (aw, ab)),
        "substep": (lambda k: bt.batched_art_rollout_kernel(aw, ab, k, am, ag),
                    lambda k: bt.batched_art_rollout_kernel_fn(k, am, ag), (aw, ab)),
    }


TICKS = {"srb": 3, "cmd": 3, "tick": 2, "substep": 2}


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("path", list(TICKS))
def test_fn_is_bit_equal_to_eager_and_pure(path):
    eager, factory, inputs = _paths()[path]
    k = TICKS[path]
    before = [t.clone() for t in _leaves(inputs)]
    fn = factory(k)
    out = fn(*inputs)
    assert _equal(out, eager(k)), "the fn differs from its eager loop"
    assert _equal(fn(*inputs), out), "a second call differs"
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(inputs))), "inputs changed"
    (graph,) = fn.graphs.values()
    buffers = {t.untyped_storage().data_ptr() for t in _leaves((graph.carry, graph.consts))}
    assert not buffers & {t.untyped_storage().data_ptr() for t in _leaves(out)}
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


@pytest.mark.parametrize("path", list(TICKS) + ["realtime"])
def test_steady_tick_makes_no_host_copy(path, monkeypatch):
    if path == "realtime":
        mpc, _ = bt.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                         admm_polish=False, kinv_ns_iters=10)
        loop = bt.RealtimeLoop(mpc, bt.GaitConfig(), bt.BipedParams(), device=CPU)
        plant = _Plant()
        loop.warmup(plant)

        def tick():
            loop.run(plant, 1, realtime=False)
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

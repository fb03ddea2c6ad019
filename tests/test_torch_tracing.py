"""The port's span recorder (``utils/profiling.py``): host spans, the
stages of a tick and the one-robot loop's per-period spans.

On the CPU: with tracing off neither kind of span calls into
``torch.profiler``; inside ``tracing()`` an SRB tick records its six stages
and a tick-kernel articulated tick its eight, once each and in order, and
a 2-tick ``RealtimeLoop`` its per-period spans; under a CPU profiler the
spans are among its host events.

On the card (``cuda``-marked; the file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py

After a replay every stage reads > 0 ms and the stages add up, within 5%,
to the replay's time between its first and last boundary; the QP kernel's
stage is within 3% of the kernel's device time in a profiler trace of the
same graph; a capture with the marks steps bit-equal to one without; and
with a profiler recording a graphed call and three N = 1 ticks under
tracing, no device event carries a span's name.
"""

import contextlib

import numpy as np
import pytest
import torch

import biped_mpc_py_torch as bt
from biped_mpc_py_torch.parallel import rollout as troll
from biped_mpc_py_torch.parallel import rollout_art as tra
from biped_mpc_py_torch.utils import profiling
from biped_mpc_py_torch.utils.graphs import leaves
from biped_mpc_py_torch.utils.precision import f32_matmul

CPU = torch.device("cpu")
SRB_STAGES = ["mpc.build", "qp.ruiz", "qp.kernel", "qp.unscale", "srb.step", "tick.post"]
ART_STAGES = ["art.feedback", "mpc.build", "qp.ruiz", "qp.kernel", "qp.unscale", "art.minv",
              "art.tick_kernel", "tick.post"]
PERIOD = ["realtime.read", "realtime.lowlevel", "realtime.torques", "realtime.apply"]


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


def _art_config():
    return bt.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                   admm_polish=False, kinv_ns_iters=10)


def _srb(n, device):
    mpc = bt.fast_mpc_config()
    return mpc, bt.GaitConfig(), bt.batch_worlds(mpc, n, device=device), \
        bt.BipedParams().expand(n).to(device)


def _art(n, device):
    mpc, gait = _art_config()
    return mpc, gait, bt.init_art_world(mpc, n, device=device), \
        bt.BipedParams().expand(n).to(device)


def _srb_tick(n=2, device=CPU):
    mpc, gait, w, b = _srb(n, device)
    with torch.no_grad():
        return troll.batched_closed_loop_tick(w, mpc, gait, b)


def _art_tick(n=2, device=CPU):
    mpc, gait, w, b = _art(n, device)
    return bt.batched_art_rollout_tick_kernel(w, b, 1, mpc, gait)


def _loop(device):
    mpc, _ = _art_config()
    loop = bt.RealtimeLoop(mpc, bt.GaitConfig(), bt.BipedParams(), device=device)
    loop.warmup(_Plant())
    return loop


def test_off_calls_nothing_of_the_profiler(monkeypatch):
    """With tracing off and no profiler recording, a span or stage is the
    one shared null context and no tick calls into ``torch.profiler``."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler called with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("x") is profiling.stage("y") is profiling._OFF
    _srb_tick()
    _loop(CPU).run(_Plant(), 1, realtime=False)


def test_srb_tick_records_its_six_stages():
    with profiling.tracing() as spans:
        _srb_tick()
    assert [s.name for s in spans] == SRB_STAGES
    assert all(s.parent is None and s.tick == 0 and s.end_ns >= s.start_ns
               and s.device_ms == pytest.approx((s.end_ns - s.start_ns) * 1e-6)
               for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_tick_kernel_tick_records_its_eight_stages():
    with profiling.tracing() as spans:
        _art_tick()
    assert [s.name for s in spans] == ART_STAGES
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_realtime_loop_records_each_period():
    """Per tick one ``realtime.tick`` holding 9 reads, 1 solve and 8 of
    each other period span, all numbered with the tick."""
    loop = _loop(CPU)
    with profiling.tracing() as spans:
        loop.run(_Plant(), 2, realtime=False)
    ticks = [i for i, s in enumerate(spans) if s.name == "realtime.tick"]
    assert [spans[i].tick for i in ticks] == [0, 1]
    for i in ticks:
        kids = [s.name for s in spans if s.parent == i]
        assert all(s.tick == spans[i].tick for s in spans if s.parent == i)
        assert kids == ["realtime.clock", "realtime.read", "realtime.solve"] + PERIOD * 8
        # the solve graph's own stages, run eagerly on the CPU, sit under the solve
        solve = next(j for j, s in enumerate(spans) if s.parent == i
                     and s.name == "realtime.solve")
        assert [s.name for s in spans if s.parent == solve] == ["qp.ruiz", "qp.kernel",
                                                                "qp.unscale"]
    assert {s.name for s in spans if s.parent is None} == {"realtime.tick"}


def test_spans_are_cpu_profiler_host_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.span"):
            _srb_tick()
    names = {e.name for e in prof.events()}
    assert {"outer.span", *SRB_STAGES} <= names


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _graph(path, n, device, ticks=3):
    """A graphed rollout of ``path`` at ``n`` envs, called once (the
    capture and ``ticks`` replays); returns (fn, its inputs, its TickGraph)."""
    if path == "srb":
        mpc, gait, w, b = _srb(n, device)
        fn = bt.batched_rollout_fn(ticks, mpc, gait)
    else:
        mpc, gait, w, b = _art(n, device)
        fn = bt.batched_art_rollout_tick_kernel_fn(ticks, mpc, gait)
    with f32_matmul():
        fn(w, b)
    return fn, (w, b), next(iter(fn.graphs.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("path, names", [("srb", SRB_STAGES), ("tick", ART_STAGES)])
def test_stage_ms_after_a_replay(cuda, path, names):
    _, _, g = _graph(path, 1024, cuda)
    g.replay()
    ms = profiling.stage_ms()
    assert g.marks.names == names and len(g.marks.events) == len(names) + 1
    assert sorted(ms) == sorted(names) and all(v > 0 for v in ms.values()), ms
    whole = g.marks.events[0].elapsed_time(g.marks.events[-1])
    assert sum(ms.values()) == pytest.approx(whole, rel=0.05)


@pytest.mark.cuda
def test_qp_kernel_stage_is_the_kernel(cuda):
    from torch.profiler import ProfilerActivity, profile

    _, _, g = _graph("tick", 1024, cuda)
    g.replay()
    stage = profiling.stage_ms()["qp.kernel"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    ks = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "qp_admm_kernel" in e.name]
    assert len(ks) == 1, ks
    assert stage == pytest.approx(ks[0] * 1e-3, rel=0.03)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["srb", "tick"])
def test_marks_leave_the_tick_bit_equal(cuda, path, monkeypatch):
    fn, args, g = _graph(path, 256, cuda)
    assert g.marks.names
    with monkeypatch.context() as m:
        m.setattr(profiling, "marking", contextlib.nullcontext)
        plain, _, g0 = _graph(path, 256, cuda)
    assert g0.marks is None
    with f32_matmul():
        a, b = fn(*args), plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
def test_spans_have_no_device_twin(cuda):
    """A profiler records a graphed call and three N = 1 ticks under
    tracing: the spans and stages are among its host events, and no device
    event carries one of their names."""
    from torch.profiler import ProfilerActivity, profile

    fn, args, _ = _graph("tick", 64, cuda)
    loop = _loop(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with f32_matmul():
            fn(*args)
        with profiling.tracing() as spans:
            loop.run(_Plant(), 3, realtime=False)
        torch.cuda.synchronize()
    names = {s.name for s in spans}
    assert {"realtime.tick", *PERIOD} <= names
    assert sum(s.name == "realtime.tick" for s in spans) == 3
    cuda_names = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
    host_names = {e.name for e in prof.events()
                  if e.device_type != torch.autograd.DeviceType.CUDA}
    assert names <= host_names
    assert not (names | set(ART_STAGES)) & cuda_names

"""The port's entry-point constructors build on the card by default.

``init_world``, ``batch_worlds``, ``randomize_params``, ``init_art_world``,
``hector_model``, ``stack_configs``, ``perturbed_worlds`` and
``RealtimeLoop`` default to ``device="cuda"``; without a card they raise at
once (no fallback to the CPU), and ``device="cpu"`` builds on the CPU. The
entry points that run a loop at once (``rollout_qpos_track``,
``export_rollout``, ``run_mujoco_closed_loop``, the demo) default to the
card too and raise without one before they do any work. Whether there is a
card is decided inside each test (monkeypatched), never at import.
"""

import dataclasses
import inspect
import sys

import pytest
import torch

from biped_mpc_py_torch import BipedParams, GaitConfig, fast_mpc_config
from biped_mpc_py_torch import demo
from biped_mpc_py_torch.parallel import rollout, rollout_art, sweep
from biped_mpc_py_torch.runtime.realtime import RealtimeLoop
from biped_mpc_py_torch.sim import mj_driver, model, replay
from torch_threads import one_torch_thread  # noqa: F401

CONSTRUCTORS = {
    "init_world": (rollout.init_world, lambda **kw: rollout.init_world(fast_mpc_config(), 2, **kw)),
    "batch_worlds": (rollout.batch_worlds,
                     lambda **kw: rollout.batch_worlds(fast_mpc_config(), 2, **kw)),
    "randomize_params": (rollout.randomize_params, lambda **kw: rollout.randomize_params(
        torch.Generator().manual_seed(0), 2, **kw)),
    "init_art_world": (rollout_art.init_art_world,
                       lambda **kw: rollout_art.init_art_world(fast_mpc_config(), 2, **kw)),
    "hector_model": (model.hector_model, lambda **kw: model.hector_model(**kw)),
    "stack_configs": (sweep.stack_configs, lambda **kw: sweep.stack_configs(
        [fast_mpc_config(), fast_mpc_config(kp_hipyaw=1.0)], **kw)[1]),
    "perturbed_worlds": (sweep.perturbed_worlds, lambda **kw: sweep.perturbed_worlds(
        fast_mpc_config(), 2, torch.Generator().manual_seed(0), **kw)),
    "RealtimeLoop": (RealtimeLoop.__init__, lambda **kw: RealtimeLoop(
        fast_mpc_config(), GaitConfig(), BipedParams(), **kw).ctrl),
}
# Entry points that run a loop: checked for their default and the raise only.
LOOPS = {
    "rollout_qpos_track": (replay.rollout_qpos_track, lambda **kw: replay.rollout_qpos_track(
        fast_mpc_config(), GaitConfig(), 1, **kw)),
    "export_rollout": (replay.export_rollout, lambda **kw: replay.export_rollout(
        "unused", fast_mpc_config(), GaitConfig(), 1, **kw)),
    "run_mujoco_closed_loop": (mj_driver.run_mujoco_closed_loop,
                               lambda **kw: mj_driver.run_mujoco_closed_loop(
                                   fast_mpc_config(), GaitConfig(), 1, **kw)),
}


def _leaves(obj):
    """Every tensor of a nested dataclass."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v)]
    if dataclasses.is_dataclass(obj):
        return [t for name in obj.__dataclass_fields__ for t in _leaves(getattr(obj, name))]
    return []


@pytest.mark.parametrize("name", list(CONSTRUCTORS) + list(LOOPS))
def test_default_device_is_cuda(name):
    fn, _ = {**CONSTRUCTORS, **LOOPS}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", list(CONSTRUCTORS) + list(LOOPS))
def test_raises_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, call = {**CONSTRUCTORS, **LOOPS}[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call(device="cuda:0")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_cpu_when_asked(name):
    _, call = CONSTRUCTORS[name]
    leaves = _leaves(call(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_demo_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["demo", "--rollout-steps", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main()

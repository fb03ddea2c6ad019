"""The port's entry-point constructors build on the card by default.

``init_world``, ``batch_worlds``, ``randomize_params``, ``init_art_world``
and ``hector_model`` default to ``device="cuda"``; without a card they raise
at once (no fallback to the CPU), and ``device="cpu"`` builds on the CPU.
Whether there is a card is decided inside each test (monkeypatched), never
at import.
"""

import inspect

import pytest
import torch

from biped_mpc_py_torch import fast_mpc_config
from biped_mpc_py_torch.parallel import rollout, rollout_art
from biped_mpc_py_torch.sim import model

CONSTRUCTORS = {
    "init_world": (rollout.init_world, lambda **kw: rollout.init_world(fast_mpc_config(), 2, **kw)),
    "batch_worlds": (rollout.batch_worlds,
                     lambda **kw: rollout.batch_worlds(fast_mpc_config(), 2, **kw)),
    "randomize_params": (rollout.randomize_params, lambda **kw: rollout.randomize_params(
        torch.Generator().manual_seed(0), 2, **kw)),
    "init_art_world": (rollout_art.init_art_world,
                       lambda **kw: rollout_art.init_art_world(fast_mpc_config(), 2, **kw)),
    "hector_model": (model.hector_model, lambda **kw: model.hector_model(**kw)),
}


def _leaves(obj):
    """Every tensor of a nested dataclass."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for name in obj.__dataclass_fields__ for t in _leaves(getattr(obj, name))]
    return []


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_default_device_is_cuda(name):
    fn, _ = CONSTRUCTORS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_raises_without_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, call = CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call(device="cuda:0")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_cpu_when_asked(name):
    _, call = CONSTRUCTORS[name]
    leaves = _leaves(call(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)

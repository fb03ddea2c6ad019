"""What the cells' drivers share: the two packages' classes, the device
record, the seed's draws on the host, and the sequence every run follows."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import tree


def port_classes(*more) -> dict:
    """The program's dataclasses by name (imports the port), with those of
    the modules ``more`` (an entry's own)."""
    from biped_mpc_py_torch import config
    from biped_mpc_py_torch.control import controller
    from biped_mpc_py_torch.models import biped
    from biped_mpc_py_torch.ops import qp
    from biped_mpc_py_torch.parallel import rollout, rollout_art
    from biped_mpc_py_torch.runtime import realtime
    from biped_mpc_py_torch.sim import engine, srb_sim
    from biped_mpc_py_torch.utils import metrics

    return tree.classes(config, controller, biped, qp, rollout, rollout_art, realtime, engine,
                        srb_sim, metrics, *more)


def reference_classes(*more) -> dict:
    from benchmark.reference import config, loops
    from benchmark.reference.control import controller
    from benchmark.reference.models import biped
    from benchmark.reference.ops import qp
    from benchmark.reference.sim import engine, srb_sim
    from benchmark.reference.utils import metrics

    return tree.classes(config, loops, controller, biped, qp, engine, srb_sim, metrics, *more)


def module_of(obj):
    """The module that defines ``obj``."""
    import sys

    return sys.modules[obj.__module__]


def configs(cell, package) -> tuple:
    """``package``'s MpcConfig (the configuration's ``mpc`` with the
    traffic's solver budget) and GaitConfig for the cell; ``package`` is
    the port or ``benchmark.reference.config``."""
    mpc = {**cell.config["mpc"], **cell.traffic["budget"]}
    return package.MpcConfig(**mpc), package.GaitConfig(**cell.config["gait"])


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator of the seed's draws for one purpose (``stream``)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def index(t, idx):
    """Rows ``idx`` of every tensor of a tree of dataclasses."""
    import dataclasses

    if isinstance(t, torch.Tensor):
        return t[idx]
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return type(t)(**{f.name: index(getattr(t, f.name), idx) for f in dataclasses.fields(t)})
    return t


def sync(device: torch.device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU, where
    only the tests run a cell)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device: torch.device, count: int = 1) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def release() -> None:
    """Return the memory of what the caller has dropped (the program's
    graphs and state) before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def now() -> float:
    return time.perf_counter()

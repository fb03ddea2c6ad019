"""The generator of the sweep cells: a cell's robots, starts and one config
per env from its traffic file and ``--seed``, drawn in that order from one
``torch.Generator`` on the run's device.

The traffic file is a batched one (``generate.py``) whose ``loop`` is
``sweep`` and which names, under ``per_env``, what differs between envs:

- ``command``: ``{index: [lo, hi]}``, entry ``index`` of each env's
  ``x_cmd`` drawn uniformly (9 the forward speed, 8 the turn rate);
- ``uniform``: ``{field: [lo, hi]}``, a float field of the configuration's
  ``mpc`` drawn uniformly per env;
- ``log_uniform``: as ``uniform``, drawn uniformly in the logarithm;
- ``log_scale``: ``{field: [lo, hi]}``, each weight of a vector field
  (``Q``, ``R``) times its own factor drawn uniformly in the logarithm.

They are drawn in that order, each group in the file's order; env 0 then
takes the configuration's values, as ``parallel/sweep.py::perturbed_worlds``
keeps world 0 nominal. The result is the port's ``per_env`` form
(``parallel/sweep.py::stack_configs``): ``x_cmd`` (N, 12), a float field
(N,), ``Q`` (N, 13), ``R`` (N, 12), f32. Every seed gets the same sizes and
the same work; only the values differ. The robots and starts are of the
reference's classes (``benchmark.reference``): the harness hands a copy to
the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.config import MpcConfig
from benchmark.traffic import generate


def _draw(gen, shape, lo_hi, log: bool = False) -> torch.Tensor:
    lo, hi = (math.log(v) for v in lo_hi) if log else lo_hi
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)
    return torch.exp(u) if log else u


def configs(traffic: dict, mpc: MpcConfig, gen: torch.Generator) -> dict:
    """The ``per_env`` values of ``envs`` configs drawn from ``traffic``'s
    ``per_env`` ranges around ``mpc``, env 0 ``mpc``'s own."""
    n, device, draws = traffic["envs"], gen.device, traffic["per_env"]
    if not draws.get("command"):
        raise ValueError("a sweep's traffic draws each env's command (per_env.command)")
    base = {"x_cmd": mpc.x_cmd, "Q": mpc.Q, "R": mpc.R}
    x_cmd = torch.tensor(mpc.x_cmd, dtype=torch.float32, device=device).repeat(n, 1)
    for i, r in draws["command"].items():
        x_cmd[:, int(i)] = _draw(gen, (n,), r)
    out = {"x_cmd": x_cmd}
    for kind in ("uniform", "log_uniform"):
        for name, r in draws.get(kind, {}).items():
            base[name] = getattr(mpc, name)
            out[name] = _draw(gen, (n,), r, log=kind == "log_uniform")
    for name, r in draws.get("log_scale", {}).items():
        w = torch.tensor(getattr(mpc, name), dtype=torch.float32, device=device)
        out[name] = w * _draw(gen, (n, w.numel()), r, log=True)
    for name, v in out.items():
        v[0] = torch.tensor(base[name], dtype=torch.float32, device=device)
    return out


def inputs(traffic: dict, mpc: MpcConfig, init, seed: int, device):
    """(robots, starts, per-env configs) for ``seed``, drawn in that order
    from one generator; the traffic draws no command range of its own
    (``command_vx``): the commands are the sweep's."""
    if traffic.get("command_vx") is not None:
        raise ValueError("a sweep draws its commands under per_env.command")
    gen = generate.generator(seed, device)
    bipeds = generate.robots(traffic, gen)
    world = generate.starts(init, mpc, traffic, gen)
    return bipeds, world, configs(traffic, mpc, gen)

"""The general generator of the batched cells: a cell's inputs from its
traffic file and ``--seed``, made on the run's device with one
``torch.Generator``.

A traffic file (``benchmark/traffic/<name>.json``) is data:

- ``loop``: the kind of loop that drives the program
  (``harness/loops/<loop>.py``): ``batched`` (many envs, chunks of
  ``ticks_per_call`` ticks) or ``realtime`` (one robot against the
  sensor-log plant, ``plant.py``);
- ``generator``: the module that makes its inputs (``traffic/<name>.py``:
  this one for the batched cells, ``plant`` for the one-robot cells);
- ``envs``; ``budget``: the seven solver-budget fields, replaced into the
  configuration's ``mpc``;
- ``robots``: ranges of the per-env mass and inertia scales and of the
  friction coefficient (each drawn uniformly, as ``randomize_params``),
  or null for the nominal HECTOR in every env;
- ``start_joint_sigma_rad``: N(0, sigma) joint-angle perturbations of the
  standing starts, env 0 nominal (as ``perturbed_worlds``), where the
  start has joints;
- ``command_vx``: null for the configuration's own command in every env,
  or a range from which each env's forward speed is drawn (per-env
  commands);
- realtime only: ``log`` (the sensor log), ``log_noise`` (the read noise's
  standard deviations by field) and ``warmup_ticks``.

Every seed gets the same sizes and the same work; only the values differ.
Everything returned is of the reference's classes (``benchmark.reference``):
the harness hands a copy to the program.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.config import MpcConfig
from benchmark.reference.models.biped import BipedParams


def seed_value(seed: int) -> int:
    """``--seed`` (any whole number) as a generator seed."""
    return int(seed) % 2**64


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_value(seed))


def _uniform(gen, shape, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def robots(traffic: dict, gen: torch.Generator) -> BipedParams:
    """``envs`` robots: mass and inertia diagonal scaled and friction drawn
    from the traffic's ranges, or all nominal."""
    n, device, r = traffic["envs"], gen.device, traffic["robots"]
    base = BipedParams().expand(n).to(device)
    if r is None:
        return base
    return dataclasses.replace(
        base,
        m=base.m * _uniform(gen, (n,), r["mass_scale"], device),
        I_diag=base.I_diag * _uniform(gen, (n, 3), r["inertia_scale"], device),
        mu=_uniform(gen, (n,), r["mu"], device),
    )


def starts(init, mpc: MpcConfig, traffic: dict, gen: torch.Generator):
    """The standing starts made by ``init(mpc, n, device=...)`` (the
    entry's ``start``), with the joint perturbations where they have
    joints."""
    n, device = traffic["envs"], gen.device
    w = init(mpc, n, device=device)
    sigma = traffic.get("start_joint_sigma_rad")
    if not sigma or not hasattr(w.sim, "q"):
        return w
    dq = torch.randn(w.sim.q.shape, generator=gen, device=device) * sigma
    dq[0] = 0.0
    return dataclasses.replace(w, sim=dataclasses.replace(w.sim, q=w.sim.q + dq))


def commands(mpc: MpcConfig, traffic: dict, gen: torch.Generator):
    """(N,12) per-env commands, each the configuration's with its forward
    speed drawn from ``command_vx``; None where the traffic has none."""
    if traffic.get("command_vx") is None:
        return None
    n, device = traffic["envs"], gen.device
    x = torch.tensor(mpc.x_cmd, dtype=torch.float32, device=device).repeat(n, 1)
    x[:, 9] = _uniform(gen, (n,), traffic["command_vx"], device)
    return x


def inputs(traffic: dict, mpc: MpcConfig, init, takes_command: bool, seed: int, device):
    """(robots, starts, per-env commands or None) for ``seed``, all of the
    reference's classes, drawn in that order from one generator; an entry
    that takes a command gets the configuration's in every env where the
    traffic draws none."""
    gen = generator(seed, device)
    bipeds = robots(traffic, gen)
    world = starts(init, mpc, traffic, gen)
    cmd = commands(mpc, traffic, gen)
    if cmd is not None and not takes_command:
        raise ValueError("this entry takes the configuration's command only")
    if cmd is None and takes_command:
        cmd = torch.tensor(mpc.x_cmd, dtype=torch.float32, device=device).repeat(
            traffic["envs"], 1)
    return bipeds, world, cmd

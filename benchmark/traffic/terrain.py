"""The generator of the rough-ground cells: a cell's robots, starts and one
height field per env from its traffic file, its configuration's
``terrain`` and ``--seed``, drawn in that order from one
``torch.Generator`` on the run's device.

The traffic file is a batched one (``generate.py``) whose ``loop`` is
``terrain``; the configuration's ``terrain`` gives the fields:
``Terrain.rough_batch`` with ``amplitude`` [m], ``res`` cells a side,
``extent`` [m] a side and ``smooth`` cells of box filter each side. Every
seed gets the same sizes and the same work; only the values differ.
Everything returned is of the reference's classes (``benchmark.reference``):
the harness hands a copy to the program.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference.config import MpcConfig
from benchmark.reference.sim.contact import Terrain
from benchmark.traffic import generate


def fields(ground: dict, n: int, gen) -> Terrain:
    """``n`` rough fields (N, res, res) of the configuration's ``terrain``."""
    if ground["kind"] != "Terrain.rough_batch" or not ground["per_env"]:
        raise ValueError(f"no generator for the ground {ground['kind']!r}")
    t = Terrain.rough_batch(gen, n, amplitude=ground["amplitude"], res=ground["res"],
                            smooth=ground["smooth"], device=gen.device)
    return dataclasses.replace(t, extent=float(ground["extent"]))


def inputs(traffic: dict, mpc: MpcConfig, init, ground: dict, seed: int, device):
    """(robots, starts, fields) for ``seed``, all of the reference's
    classes, drawn in that order from one generator; the traffic draws no
    command (the configuration's own in every env)."""
    if traffic.get("command_vx") is not None:
        raise ValueError("the terrain entry takes the configuration's command only")
    gen = generate.generator(seed, device)
    bipeds = generate.robots(traffic, gen)
    world = generate.starts(init, mpc, traffic, gen)
    return bipeds, world, fields(ground, traffic["envs"], gen)

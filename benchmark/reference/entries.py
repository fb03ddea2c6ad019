"""The reference's counterpart of each program entry that a configuration
names (``benchmark/configs/<config>.json``: ``entry.<loop>.reference``).
Every batched counterpart takes one signature,
``(world, bipeds, mpc, gait, x_cmd, **kwargs) -> world``: one tick for
every env, ``x_cmd`` the (N,12) per-env commands or None, ``kwargs`` the
entry's own."""

from __future__ import annotations

import torch

from benchmark.reference import loops
from benchmark.reference.models.biped import BipedParams
from benchmark.reference.sim.model import hector_model


def srb_tick(world, bipeds, mpc, gait, x_cmd: torch.Tensor | None = None):
    """``batched_closed_loop_tick``: the SRB loop, with or without per-env
    commands."""
    return loops.srb_tick(world, mpc, gait, bipeds, x_cmd)


def art_tick(world, bipeds, mpc, gait, x_cmd: torch.Tensor | None = None, *,
             n_lowlevel: int, n_substeps: int):
    """``_tick_kernel_tick``: the articulated tick path, with the nominal
    HECTOR's model and parameters in the physics (as the tick kernel)."""
    if x_cmd is not None:
        raise ValueError("the tick path takes the configuration's command only")
    device = world.sim.q.device
    return loops.art_tick(world, bipeds, mpc, gait, hector_model(device=device),
                          BipedParams().to(device), n_lowlevel, n_substeps)

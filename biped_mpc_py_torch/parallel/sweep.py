"""Config-batched stability sweeps: the counterpart of
``biped_mpc_py_tpu/parallel/sweep.py``.

The articulated closed loop is chaotic near its capability boundaries, so a
controller is tuned by mapping its stability region in one batch: gains x
commands x initial-state perturbations along the env axis. JAX batches the
whole ``MpcConfig`` pytree under vmap; the port keeps one config of floats
and hands the fields that differ between envs beside it, as (N,) or (N, 12)
tensors (``config.py`` describes the mechanism). :func:`stack_configs`
builds that pair from a list of configs, :func:`perturbed_worlds` the
perturbed initial worlds, and :func:`art_sweep` runs the plain articulated
chain (``art_closed_loop_tick``) over them. The physics kernels are not
used: the tick kernel's constant buffer holds one config per batch.
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import PER_ENV_FIELDS, GaitConfig, MpcConfig
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel.rollout_art import (
    ArtWorld,
    art_closed_loop_tick,
    init_art_world,
)
from biped_mpc_py_torch.sim.model import ArticulatedModel, hector_model
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.precision import f32_precision

# The MpcConfig fields that select the program in JAX (``pytree_node=False``
# in ``biped_mpc_py_tpu/config.py``): equal across a sweep, as there. Every
# GaitConfig field is of this kind.
STATIC_FIELDS = (
    "h", "swing_z_sin2", "foot_frame_wrench", "tau_z_max", "mu_z", "cmd_body_frame",
    "n_admm_iters", "admm_rho_phases", "admm_polish", "kinv_ns_iters",
    "kinv_bf16_iters", "admm_bf16_matvec", "ruiz_bf16_norms", "ruiz_iters",
    "compat_foot_ref_bug", "compat_force_box_bug", "compat_ref_col0_bug",
    "compat_swing_frame_bug", "compat_swing_yaw_bug",
)


def stack_configs(configs, device=DEFAULT_DEVICE):
    """One config and its per-env values from a list of N configs
    (``sweep.py:36``).

    Fields equal across the list stay in the returned config (the first of
    the list). ``x_cmd`` where it differs becomes an (N, 12) tensor and a
    differing low-level or swing gain (``config.PER_ENV_FIELDS``) an (N,)
    tensor, f32 on ``device`` (the card unless named), in the ``per_env``
    dict. Raises ``ValueError`` where a static field differs (JAX compiles
    one program per static combination) and where any other float field
    differs: the port's functions take no per-env value of it.

    Returns (mpc, per_env).
    """
    device = entry_device(device)
    base = configs[0]
    if any(type(c) is not type(base) for c in configs):
        raise ValueError("configs of different types")
    static = STATIC_FIELDS if isinstance(base, MpcConfig) else ()
    per_env = {}
    for f in dataclasses.fields(base):
        col = [getattr(c, f.name) for c in configs]
        if all(v == col[0] for v in col):
            continue
        if isinstance(base, GaitConfig) or f.name in static:
            raise ValueError(
                f"configs differ in static field {f.name}; split the sweep into one "
                "run per static combination"
            )
        if f.name != "x_cmd" and f.name not in PER_ENV_FIELDS:
            raise ValueError(
                f"configs differ in {f.name}, which the port takes from the config "
                f"only; per-env fields are x_cmd and {', '.join(PER_ENV_FIELDS)}"
            )
        per_env[f.name] = torch.tensor(col, dtype=torch.float32).to(device)
    return base, per_env


def perturbed_worlds(mpc: MpcConfig, n: int, generator: torch.Generator,
                     scale: float = 2e-3, device=DEFAULT_DEVICE) -> ArtWorld:
    """``n`` standing worlds on ``device`` (the card unless named; raises
    without one) (``sweep.py:73``): world 0 is nominal, the others carry
    N(0, scale) joint-angle perturbations drawn from ``generator`` on its
    own device."""
    device = entry_device(device)
    w = init_art_world(mpc, n, device=device)
    dq = torch.randn((n, 10), generator=generator, device=generator.device).to(device)
    dq[0] = 0.0
    return dataclasses.replace(w, sim=dataclasses.replace(w.sim, q=w.sim.q + scale * dq))


@f32_precision
@torch.no_grad()
def art_sweep(worlds: ArtWorld, bipeds: BipedParams, n_steps: int, mpc: MpcConfig,
              gait: GaitConfig, per_env: dict, model: ArticulatedModel | None = None,
              **tick_kw) -> ArtWorld:
    """``n_steps`` ticks of ``art_closed_loop_tick`` with env i under
    config i of the sweep: the counterpart of ``art_sweep_fn(n_steps, gait,
    in_axes, model, **tick_kw)(worlds, biped, mpc_batch)`` (``sweep.py:92``).
    ``mpc`` and ``per_env`` come from :func:`stack_configs`; ``tick_kw``
    goes to the tick (``n_lowlevel``, ``n_substeps``, ``minv_ll_hold``,
    ``terrain``)."""
    model = model or hector_model(device=worlds.sim.q.device)
    gains = {k: v for k, v in per_env.items() if k != "x_cmd"}
    x_cmd = per_env.get("x_cmd")
    w = worlds
    for _ in range(n_steps):
        w = art_closed_loop_tick(w, mpc, gait, bipeds, model, x_cmd=x_cmd, per_env=gains,
                                 **tick_kw)
    return w

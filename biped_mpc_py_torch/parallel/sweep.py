"""Config-batched stability sweeps: the counterpart of
``biped_mpc_py_tpu/parallel/sweep.py``.

The articulated closed loop is chaotic near its capability boundaries, so a
controller is tuned by mapping its stability region in one batch: gains x
commands x initial-state perturbations along the env axis. JAX batches the
whole ``MpcConfig`` pytree under vmap; the port keeps one config of floats
and hands the fields that differ between envs beside it, as (N,), (N, 12)
or (N, 13) tensors (``config.py`` describes the mechanism): every dynamic
field may differ, as in JAX. :func:`stack_configs` builds that pair from a
list of configs, :func:`perturbed_worlds` the perturbed initial worlds, and
:func:`art_sweep` runs ``art_closed_loop_tick`` over them, with one launch
of the QP kernel a tick that takes each env's ADMM numerics. On the card,
with one ``dt`` for the sweep, a walking gait and the mass-matrix inverse
held all tick (``minv_ll_hold == n_lowlevel``), everything below the MPC
is one launch of the tick kernel's per-env variant, which reads each env's
command and gains from a table formed in the tick
(``ops/cuda/tick_kernel.py::tick_table``); a per-env ``dt``, a running
gait, another hold or a field runs the plain articulated chain, as the
CPU always does. :func:`art_sweep_fn` is its compiled form, the
counterpart of ``jax.jit`` of the JAX factory: one tick captured as a CUDA
graph with the per-env values as its input, and replayed
(``utils/graphs.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from biped_mpc_py_torch.config import STATIC_FIELDS, GaitConfig, MpcConfig
from biped_mpc_py_torch.utils.device import host_to_device
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel.rollout_art import ArtWorld, _plain_step, init_art_world
from biped_mpc_py_torch.sim.model import ArticulatedModel
from biped_mpc_py_torch.utils.device import DEFAULT_DEVICE, entry_device
from biped_mpc_py_torch.utils.graphs import graphed
from biped_mpc_py_torch.utils.precision import f32_precision


def stack_configs(configs, device=DEFAULT_DEVICE):
    """One config and its per-env values from a list of N configs
    (``sweep.py:36``).

    Fields equal across the list stay in the returned config (the first of
    the list), as JAX keeps them unbatched. Every other field that differs
    becomes a tensor in the ``per_env`` dict, f32 on ``device`` (the card
    unless named): (N, 12) for ``x_cmd`` and ``R``, (N, 13) for ``Q``, (N,)
    for a float (``config.PER_ENV_FIELDS``, ``config.MPC_PER_ENV_FIELDS``).
    Raises ``ValueError`` naming the field where a static field or a
    ``GaitConfig`` field differs (JAX compiles one program per static
    combination).

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
        per_env[f.name] = host_to_device(col, device, torch.float32)
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
    step = _plain_step(mpc, gait, model, **tick_kw)
    w = worlds
    for _ in range(n_steps):
        w = step(w, bipeds, None, per_env)
    return w


def art_sweep_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                 model: ArticulatedModel | None = None, **tick_kw):
    """``fn(worlds, bipeds, per_env) -> worlds``: ``n_steps`` ticks of the
    sweep, the counterpart of ``jax.jit(art_sweep_fn(n_steps, gait,
    in_axes, model, **tick_kw))(worlds, biped, mpc_batch)``
    (``sweep.py:92``). ``mpc`` and ``per_env`` come from
    :func:`stack_configs`: ``mpc`` is a factory constant, as JAX's static
    fields are, and ``per_env`` (``x_cmd`` included) an input of the graph,
    as ``mpc_batch`` is traced in JAX: new values of the same shapes replay
    the same graph, the QP kernel reads each env's (rho, sigma, alpha) from
    its buffers on every replay, and on the tick-kernel path the table of
    each env's control constants is formed from them in the tick. On the CPU
    the same static buffers step eagerly. Bit-equal to :func:`art_sweep`."""
    run = graphed(_plain_step(mpc, gait, model, **tick_kw), n_steps)

    def fn(worlds: ArtWorld, bipeds: BipedParams, per_env: dict) -> ArtWorld:
        return run(worlds, bipeds, None, per_env)

    fn.graphs = run.graphs
    return fn

"""biped_mpc_py_torch: the PyTorch and CUDA port of ``biped_mpc_py_tpu``.

The HECTOR force-and-moment MPC with low-level control, closed around the
single-rigid-body simulator or the 11-body articulated engine, batched over
thousands of envs on one NVIDIA Hopper GPU. The layout mirrors the JAX
package module for module, so each function's counterpart is found by
path; every function takes a leading env axis instead of being vmapped.

The main paths are :func:`biped_mpc_py_torch.parallel.rollout.batched_rollout`
(SRB) and, articulated,
:func:`biped_mpc_py_torch.parallel.rollout_art.batched_art_rollout_tick_kernel`
and :func:`~biped_mpc_py_torch.parallel.rollout_art.batched_art_rollout_kernel`
on flat ground, and
:func:`~biped_mpc_py_torch.parallel.rollout_art.batched_art_rollout_terrain`
on per-env height fields (:class:`~biped_mpc_py_torch.sim.contact.Terrain`).
Their compiled forms, the counterparts of ``jax.jit`` of the JAX package's
factories, capture one tick as a CUDA graph and replay it
(:mod:`~biped_mpc_py_torch.utils.graphs`): ``batched_rollout_fn``,
``batched_cmd_rollout_fn``, ``batched_art_rollout_tick_kernel_fn``,
``batched_art_rollout_kernel_fn``, ``batched_art_rollout_fn`` (the plain
chain), ``batched_art_rollout_terrain_fn``, ``art_sweep_fn``,
``sharded_rollout_fn`` and ``sharded_art_rollout_fn``;
:func:`~biped_mpc_py_torch.parallel.sweep.art_sweep` runs a batch of
configs (per-env gains and commands beside one config). Around one robot:
:func:`~biped_mpc_py_torch.sim.mj_driver.run_mujoco_closed_loop` (MuJoCo as
the plant), :class:`~biped_mpc_py_torch.runtime.realtime.RealtimeLoop` (a
deadline-scheduled loop against any plant),
:mod:`~biped_mpc_py_torch.sim.replay` (MuJoCo replay files) and
``python -m biped_mpc_py_torch.demo``.
Their kernels are hand-written CUDA for sm_90a, built with ``nvcc`` the
first time a CUDA tensor reaches their wrappers: the fused ADMM QP solve
(``csrc/qp_admm.cu``, ``ops.cuda.qp_kernel.fused_qp_solve``), the fused
physics substeps (``csrc/substep.cu``,
``ops.cuda.substep_kernel.fused_substeps``) and the fused tick of low-level
control and physics (``csrc/tick.cu``, ``ops.cuda.tick_kernel.fused_tick``,
sharing the substep's device code). On CPU tensors the same
wrappers run their plain PyTorch versions. Importing the package needs
neither CUDA nor ``nvcc``.

Layer map:
  L0 config            -> config, models.biped, sim.model
  L1 math utilities    -> ops.rotations, ops.linalg3, sim.spatial
  L2 kinematics        -> models.kinematics
  L3 planning/refs     -> control.gait, control.reference, control.swing
  L4 MPC (dyn + QP)    -> models.srb, ops.qp, ops.cuda.qp_kernel, control.mpc
  L5 low-level         -> control.lowlevel
  L6 driver            -> control.controller, sim.srb_sim, parallel.rollout
  L7 articulated sim   -> sim.dynamics, sim.contact, sim.engine,
                          ops.cuda.substep_kernel, ops.cuda.tick_kernel,
                          parallel.rollout_art, parallel.sweep
  L8 deployment        -> sim.mjcf, sim.mj_driver, sim.replay,
                          runtime.realtime, runtime.native, demo
  L9 multi-device      -> parallel.sharding (one process per device, a
                          DeviceMesh of DTensor-sharded envs)
  utilities            -> utils.checkpoint, utils.logging, utils.profiling,
                          utils.graphs (CUDA-graph capture of a tick, L6 and L8)

The names of ``parallel.sharding`` are imported on first use:
``torch.distributed.tensor`` adds most of a second to the package's import,
and ``python -m biped_mpc_py_torch.parallel.sharding`` must not find its
module imported before it runs.
"""

from biped_mpc_py_torch.config import (
    GaitConfig,
    MpcConfig,
    default_mpc_config,
    fast_mpc_config,
    reference_compat_config,
)
from biped_mpc_py_torch.control.controller import control_tick
from biped_mpc_py_torch.control.gait import gait_for_speed
from biped_mpc_py_torch.control.mpc import solve_mpc
from biped_mpc_py_torch.models.biped import (
    HECTOR_LEG_FK,
    HECTOR_LEG_JAC,
    BipedParams,
    LegGeometry,
)
from biped_mpc_py_torch.parallel.rollout import (
    World,
    batch_worlds,
    batched_cmd_rollout,
    batched_cmd_rollout_fn,
    batched_rollout,
    batched_rollout_fn,
    init_world,
    randomize_params,
)
from biped_mpc_py_torch.parallel.rollout_art import (
    ArtWorld,
    art_config_for_run,
    art_config_for_speed,
    art_config_for_turn,
    art_mpc_config,
    batched_art_rollout,
    batched_art_rollout_fn,
    batched_art_rollout_kernel,
    batched_art_rollout_kernel_fn,
    batched_art_rollout_terrain,
    batched_art_rollout_terrain_fn,
    batched_art_rollout_tick_kernel,
    batched_art_rollout_tick_kernel_fn,
    init_art_world,
)
from biped_mpc_py_torch.parallel.sweep import (
    art_sweep,
    art_sweep_fn,
    perturbed_worlds,
    stack_configs,
)
from biped_mpc_py_torch.ops.qp import ns_inverse, sparse_qp_matrices
from biped_mpc_py_torch.runtime.realtime import LoopStats, Plant, RealtimeLoop
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.mj_driver import run_mujoco_closed_loop
from biped_mpc_py_torch.sim.replay import export_rollout, rollout_qpos_track
from biped_mpc_py_torch.utils.graphs import TickGraph, graphed
from biped_mpc_py_torch.utils.checkpoint import (
    load_pytree,
    load_pytree_dcp,
    save_pytree,
    save_pytree_dcp,
)

_SHARDING = (
    "dryrun_multichip",
    "env_group",
    "env_mesh",
    "make_sharded_batch",
    "shard_world",
    "sharded_art_rollout",
    "sharded_art_rollout_fn",
    "sharded_rollout",
    "sharded_rollout_fn",
    "spawn_env_group",
)


def __getattr__(name):
    if name in _SHARDING:
        from biped_mpc_py_torch.parallel import sharding

        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "MpcConfig",
    "GaitConfig",
    "BipedParams",
    "LegGeometry",
    "HECTOR_LEG_FK",
    "HECTOR_LEG_JAC",
    "default_mpc_config",
    "fast_mpc_config",
    "reference_compat_config",
    "gait_for_speed",
    "ns_inverse",
    "solve_mpc",
    "control_tick",
    "World",
    "batch_worlds",
    "batched_cmd_rollout",
    "batched_cmd_rollout_fn",
    "batched_rollout",
    "batched_rollout_fn",
    "init_world",
    "randomize_params",
    "ArtWorld",
    "art_config_for_run",
    "art_config_for_speed",
    "art_config_for_turn",
    "art_mpc_config",
    "batched_art_rollout",
    "batched_art_rollout_fn",
    "batched_art_rollout_kernel",
    "batched_art_rollout_kernel_fn",
    "batched_art_rollout_terrain",
    "batched_art_rollout_terrain_fn",
    "batched_art_rollout_tick_kernel",
    "batched_art_rollout_tick_kernel_fn",
    "init_art_world",
    "Terrain",
    "sparse_qp_matrices",
    "art_sweep",
    "art_sweep_fn",
    "perturbed_worlds",
    "stack_configs",
    "LoopStats",
    "Plant",
    "RealtimeLoop",
    "run_mujoco_closed_loop",
    "export_rollout",
    "rollout_qpos_track",
    "load_pytree",
    "save_pytree",
    "load_pytree_dcp",
    "save_pytree_dcp",
    "TickGraph",
    "graphed",
    *_SHARDING,
    "__version__",
]

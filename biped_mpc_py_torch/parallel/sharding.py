"""Env-sharded rollouts over a device mesh: the counterpart of
``biped_mpc_py_tpu/parallel/sharding.py`` and of
``__graft_entry__.py::dryrun_multichip``.

PyTorch's idiom for the JAX mesh is one process per device. A
``torch.distributed`` process group joins the processes (``torchrun``, or
:func:`spawn_env_group` on one host), :func:`env_mesh` lays a 1-D ``"env"``
``DeviceMesh`` over its ranks, and :func:`shard_world` makes every tensor of
a world a ``DTensor`` sharded on its env axis (``Shard(0)``, the counterpart
of ``NamedSharding(mesh, P("env"))``). Each rank runs the port's batched loop
on its own rows, as ``shard_map`` runs the vmapped scan on each device, so
rollouts stay embarrassingly parallel: the only collectives are one
all-reduce of the metric sums and one of their maxima at the end.
:func:`sharded_rollout_fn` and :func:`sharded_art_rollout_fn` are the
compiled forms, the counterparts of ``jax.jit`` of the JAX factories: each
rank replays one CUDA graph of a tick over its rows
(``utils/graphs.py``), with the collectives outside the graph.

On CUDA the backend is NCCL, one rank per card; ``gloo`` runs the same
program on the CPU, or with several ranks sharing one card, which NCCL
refuses. gloo all-reduces the summary's CUDA tensors in place (torch 2.11
on an H100); its gather of CUDA tensors into one tensor crashes, so
``utils/checkpoint.py::save_pytree`` gathers into a list.

    python -m biped_mpc_py_torch.parallel.sharding --devices N [--device cpu]

runs :func:`dryrun_multichip`.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from biped_mpc_py_torch.config import GaitConfig, MpcConfig, fast_mpc_config
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.parallel.rollout import (
    World,
    batch_worlds,
    batched_rollout,
    batched_rollout_fn,
)
from biped_mpc_py_torch.parallel.rollout_art import (
    art_mpc_config,
    batched_art_rollout,
    batched_art_rollout_fn,
    init_art_world,
)
from biped_mpc_py_torch.utils.device import entry_device
from biped_mpc_py_torch.utils.struct import TensorStruct


def env_mesh(device="cuda", axis: str = "env") -> DeviceMesh:
    """1-D mesh over every rank of the initialized default process group,
    env-parallel axis ``axis`` (``sharding.py:31``).

    On ``cuda`` it first makes this rank's card (``LOCAL_RANK``, else the
    rank, modulo the host's cards) the current device, so that every tensor
    the port builds on ``"cuda"`` afterwards lands there. Raises without a
    process group, without a card, and for more NCCL ranks than the host
    has cards; it never falls back to the CPU.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "env_mesh needs an initialized torch.distributed process group "
            "(torchrun, or spawn_env_group)")
    dev = entry_device(device)
    n_ranks = dist.get_world_size()
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if dist.get_backend() == "nccl" and n_ranks > n_cards:
            raise RuntimeError(
                f"{n_ranks} NCCL ranks need {n_ranks} cards, this host has "
                f"{n_cards}; NCCL refuses two ranks on one card (use gloo)")
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local_rank % n_cards)
    return init_device_mesh(dev.type, (n_ranks,), mesh_dim_names=(axis,))


def shard_world(struct: TensorStruct, mesh: DeviceMesh, axis: str = "env"):
    """Every tensor leaf of ``struct`` as a ``DTensor`` sharded on its
    leading env axis over ``mesh`` (``sharding.py:39``); Python-number and
    ``None`` leaves pass through.

    Every rank holds the same full batch, as JAX's ``device_put`` of one
    host array does, so each slices its own rows and nothing is sent
    (``src_data_rank=None``). Raises unless the env count divides by the
    mesh size, as ``shard_map`` does.
    """
    n_shards = mesh.size()

    def place(t):
        if t.dim() == 0 or t.shape[0] % n_shards:
            raise ValueError(
                f"a leaf of shape {tuple(t.shape)} does not split its env axis "
                f"over {n_shards} ranks of the {axis!r} mesh")
        return distribute_tensor(t, mesh, [Shard(0)], src_data_rank=None)

    return struct.map(place)


def _local(struct: TensorStruct) -> TensorStruct:
    def rows(t):
        if not isinstance(t, DTensor):
            raise TypeError("a sharded rollout takes DTensor leaves: place the "
                            "batch with shard_world first")
        return t.to_local()

    return struct.map(rows)


def _sharded(struct: TensorStruct, mesh: DeviceMesh) -> TensorStruct:
    return struct.map(lambda t: DTensor.from_local(t, mesh, [Shard(0)], run_check=False))


def _summary(metrics, mesh: DeviceMesh, axis: str, with_max: bool) -> dict:
    """The metric sums over every env of the mesh, one all-reduce; with
    ``with_max`` the largest ADMM primal residual, one more."""
    group = mesh.get_group(axis)
    sums = torch.stack([metrics.n_steps.sum(), metrics.height_err_sq.sum(),
                        metrics.falls.sum()])
    dist.all_reduce(sums, dist.ReduceOp.SUM, group=group)
    summary = dict(zip(("n_steps", "height_rmse_sum", "falls"), sums.unbind()))
    if with_max:
        top = metrics.res_prim_max.max().reshape(1)
        dist.all_reduce(top, dist.ReduceOp.MAX, group=group)
        summary["res_prim_max"] = top[0]
    return summary


def make_sharded_batch(mpc: MpcConfig, n_envs: int, mesh: DeviceMesh,
                       axis: str = "env") -> World:
    """``n_envs`` standing worlds sharded over the mesh, on its device type
    (``sharding.py:89``)."""
    return shard_world(batch_worlds(mpc, n_envs, device=mesh.device_type), mesh, axis)


def sharded_rollout(worlds: World, bipeds: BipedParams, n_steps: int, mpc: MpcConfig,
                    gait: GaitConfig, mesh: DeviceMesh, axis: str = "env"):
    """``n_steps`` ticks of the SRB closed loop on every rank's rows ->
    ``(worlds, summary)``: the counterpart of ``sharded_rollout_fn``
    (``sharding.py:45``).

    ``worlds`` and ``bipeds`` are sharded alike (:func:`shard_world`). Each
    rank runs ``batched_rollout`` on its local rows, and the summary is
    reduced over the mesh at the end: ``n_steps``, ``height_rmse_sum`` and
    ``falls`` summed, ``res_prim_max`` the maximum (``sharding.py:67-70``),
    each a 0-d tensor on the rank's device.
    """
    w = batched_rollout(_local(worlds), _local(bipeds), n_steps, mpc, gait)
    return _sharded(w, mesh), _summary(w.metrics, mesh, axis, with_max=True)


def sharded_art_rollout(worlds, bipeds: BipedParams, n_steps: int, mpc: MpcConfig,
                        gait: GaitConfig, mesh: DeviceMesh, model=None,
                        axis: str = "env", **kw):
    """``n_steps`` articulated ticks of the plain substep chain on every
    rank's rows -> ``(worlds, summary)``: the counterpart of
    ``sharded_art_rollout_fn`` (``sharding.py:97``). ``kw`` (``n_lowlevel``,
    ``n_substeps``, ``minv_ll_hold``, ``terrain``) goes to
    ``batched_art_rollout``; the summary sums ``n_steps``, ``falls`` and
    ``height_rmse_sum`` over the mesh (``sharding.py:121-123``)."""
    w = batched_art_rollout(_local(worlds), _local(bipeds), n_steps, mpc, gait,
                            model=model, **kw)
    return _sharded(w, mesh), _summary(w.metrics, mesh, axis, with_max=False)


def sharded_rollout_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig, mesh: DeviceMesh,
                       axis: str = "env"):
    """``fn(worlds, bipeds) -> (worlds, summary)``: the compiled form of
    :func:`sharded_rollout`, the counterpart of ``jax.jit`` of
    ``sharded_rollout_fn(n_steps, mpc, gait, mesh, axis)``
    (``sharding.py:45``). Each rank replays one ``batched_rollout_fn``
    graph over its local rows; the ``DTensor`` unwrap and rewrap and the
    summary's two all-reduces stay outside the graph, as JAX's ``psum`` and
    ``pmax`` come after the scan. Bit-equal to :func:`sharded_rollout`."""
    run = batched_rollout_fn(n_steps, mpc, gait)

    def fn(worlds: World, bipeds: BipedParams):
        w = run(_local(worlds), _local(bipeds))
        return _sharded(w, mesh), _summary(w.metrics, mesh, axis, with_max=True)

    fn.graphs = run.graphs
    return fn


def sharded_art_rollout_fn(n_steps: int, mpc: MpcConfig, gait: GaitConfig,
                           mesh: DeviceMesh, model=None, axis: str = "env", **kw):
    """``fn(worlds, bipeds) -> (worlds, summary)``: the compiled form of
    :func:`sharded_art_rollout`, the counterpart of ``jax.jit`` of
    ``sharded_art_rollout_fn(n_steps, mpc, gait, mesh, model, axis, **kw)``
    (``sharding.py:92``). Each rank replays one ``batched_art_rollout_fn``
    graph (``kw``: ``n_lowlevel``, ``n_substeps``, ``minv_ll_hold``,
    ``terrain``) over its local rows; the all-reduce of the summary stays
    outside it. Bit-equal to :func:`sharded_art_rollout`."""
    run = batched_art_rollout_fn(n_steps, mpc, gait, model, **kw)

    def fn(worlds, bipeds: BipedParams):
        w = run(_local(worlds), _local(bipeds))
        return _sharded(w, mesh), _summary(w.metrics, mesh, axis, with_max=False)

    fn.graphs = run.graphs
    return fn


@contextlib.contextmanager
def env_group(store: str, backend: str, rank: int = 0, world_size: int = 1):
    """A process group for the block, joined through the file ``store``
    (``file://``: no TCP port), destroyed at its end."""
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _host(obj):
    """A rank's result as the parent can load it: tensors on the CPU, a
    ``DTensor`` as this rank's rows."""
    if isinstance(obj, torch.Tensor):
        return (obj.to_local() if isinstance(obj, DTensor) else obj).detach().cpu()
    if isinstance(obj, TensorStruct):
        return obj.map(_host)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _rank_main(rank, n_ranks, backend, device, tmp, fn, args):
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(1)
    with env_group(os.path.join(tmp, "store"), backend, rank, n_ranks):
        out = fn(env_mesh(device), *args)
        torch.save(_host(out), os.path.join(tmp, f"rank{rank}.pt"))


def spawn_env_group(n_ranks: int, fn, *args, device="cuda",
                    timeout: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` new processes, one group over
    an :func:`env_mesh` on ``device``, and return each rank's result
    (tensors on the CPU, a ``DTensor`` as that rank's rows): the
    counterpart of ``__graft_entry__.py::_reexec_on_cpu_mesh``.

    The processes start by ``spawn`` and join through a ``file://`` store
    in a temporary directory. The backend is NCCL on ``cuda`` with a card
    per rank and ``gloo`` otherwise (on the CPU, or every rank on the one
    card); the choice is printed. ``fn`` must
    be importable by module path, since the children import it, and
    ``args`` picklable; on the CPU each child runs one thread. Past
    ``timeout`` seconds the children are killed and ``TimeoutError``
    raised; a child's exception is raised here.
    """
    dev = entry_device(device)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= n_ranks else "gloo"
    print(f"spawn_env_group: {n_ranks} ranks on {dev.type}, backend {backend}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(n_ranks, backend, dev.type, tmp, fn, args), nprocs=n_ranks,
            join=False)
        deadline = time.monotonic() + (math.inf if timeout is None else timeout)
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_env_group: {n_ranks} ranks past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n_ranks)]


def _finite(t) -> bool:
    return bool(torch.isfinite(t.full_tensor()).all())


def _bipeds(n_envs: int, mesh: DeviceMesh) -> BipedParams:
    return shard_world(BipedParams().expand(n_envs).to(mesh.device_type), mesh)


def _dryrun_rank(mesh: DeviceMesh) -> list[str]:
    """The three phases of :func:`dryrun_multichip` on one rank -> the lines
    it printed (rank 0) or none."""
    n_ranks, lines = mesh.size(), []

    def say(line):
        if dist.get_rank() == 0:
            print(line, flush=True)
            lines.append(line)

    gait = GaitConfig()
    n_envs = 2 * n_ranks
    bipeds = _bipeds(n_envs, mesh)

    # Phase 1: the SRB closed loop, env-sharded.
    mpc = MpcConfig()
    world, summary = sharded_rollout(make_sharded_batch(mpc, n_envs, mesh), bipeds, 2,
                                     mpc, gait, mesh)
    if float(summary["n_steps"]) != 2 * n_envs or not _finite(world.sim.x_fb):
        raise RuntimeError(f"dryrun_multichip SRB failed: {summary}")
    say(f"dryrun_multichip SRB OK: {n_ranks} ranks on {mesh.device_type}, {n_envs} envs, "
        f"falls={float(summary['falls'])}")

    # Phase 2: the full articulated stack, 50 ticks (2 s: ~5 gait cycles of
    # stance switching, swing and contact under the same reductions).
    ampc = art_mpc_config()
    aworlds = shard_world(init_art_world(ampc, n_envs, device=mesh.device_type), mesh)
    _sync(mesh)
    t0 = time.perf_counter()
    aworld, asummary = sharded_art_rollout(aworlds, bipeds, 50, ampc, gait, mesh)
    _sync(mesh)
    sec = time.perf_counter() - t0
    if float(asummary["n_steps"]) != 50 * n_envs or not _finite(aworld.sim.pos):
        raise RuntimeError(f"dryrun_multichip ART failed: {asummary}")
    say(f"dryrun_multichip ART OK: {n_ranks} ranks on {mesh.device_type}, {n_envs} envs, "
        f"50 steps, falls={float(asummary['falls'])}, {50 * n_envs / sec:.1f} env-steps/s "
        f"({50 * n_envs / sec / n_ranks:.1f}/rank)")

    # Phase 3: weak scaling of the SRB loop at a fixed env count per rank.
    _weak_scaling_table(mesh, say)
    return lines


def _sync(mesh: DeviceMesh) -> None:
    """Wait for this rank's card, then for every rank of ``mesh``."""
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()
    dist.barrier(group=mesh.get_group())


def _weak_scaling_table(mesh: DeviceMesh, say, envs_per_rank: int = 4,
                        n_steps: int = 50) -> None:
    """Timed SRB sharded rollouts over meshes of the first 1, 2, 4, ...
    ranks at a fixed env count per rank (``__graft_entry__.py:143``); every
    rank takes part in building each mesh, the others wait at a barrier.
    Ranks that share a host's cores or one card measure the program's
    validity there, not the scaling across cards."""
    mpc, gait = fast_mpc_config(), GaitConfig()
    n_ranks = mesh.size()
    say(f"weak scaling (SRB, {envs_per_rank} envs/rank, {n_steps} steps, fast budget, "
        f"{mesh.device_type}):")
    d = 1
    while d <= n_ranks:
        sub = mesh if d == n_ranks else DeviceMesh(mesh.device_type, list(range(d)),
                                                    mesh_dim_names=mesh.mesh_dim_names)
        if dist.get_rank() < d:
            n_envs = envs_per_rank * d
            worlds, bipeds = make_sharded_batch(mpc, n_envs, sub), _bipeds(n_envs, sub)
            sharded_rollout(worlds, bipeds, 2, mpc, gait, sub)  # warm-up
            _sync(sub)
            t0 = time.perf_counter()
            world, summary = sharded_rollout(worlds, bipeds, n_steps, mpc, gait, sub)
            _sync(sub)
            sec = time.perf_counter() - t0
            if float(summary["n_steps"]) != n_steps * n_envs or not _finite(world.sim.x_fb):
                raise RuntimeError(f"weak scaling at {d} ranks failed: {summary}")
            total = n_steps * n_envs
            say(f"  ranks={d} envs={n_envs} steps={n_steps} falls={float(summary['falls']):.0f} "
                f"env-steps/s={total / sec:.1f} per-rank={total / sec / d:.1f}")
        dist.barrier()
        d *= 2


def dryrun_multichip(n_devices: int, device="cuda", timeout: float | None = None) -> list[str]:
    """Shard the env batch over an ``n_devices``-rank mesh and run the SRB
    loop (``MpcConfig()``, 2 envs per rank, 2 ticks), the articulated
    stack (``art_mpc_config()``, 50 ticks) and the weak-scaling table (1,
    2, 4, ... ranks, 4 envs per rank, 50 SRB ticks at ``fast_mpc_config()``),
    each checked and printed by rank 0 -> the lines printed: the
    counterpart of ``__graft_entry__.py::dryrun_multichip`` (:30-141, with
    ``_weak_scaling_table`` :143).

    On ``cuda`` every rank has a card of its own over NCCL, and asking for
    more ranks than cards raises; on ``cpu`` the ranks are processes over
    ``gloo``. ``timeout`` as in :func:`spawn_env_group`.
    """
    dev = entry_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_devices} NCCL ranks need {n_devices} "
                           f"cards, this host has {torch.cuda.device_count()}")
    return spawn_env_group(n_devices, _dryrun_rank, device=dev.type, timeout=timeout)[0]


def _main() -> None:
    parser = argparse.ArgumentParser(
        description="dryrun_multichip: the env-sharded SRB and articulated loops and a "
                    "weak-scaling table over N ranks")
    parser.add_argument("--devices", type=int, required=True, help="ranks in the mesh")
    parser.add_argument("--device", default="cuda", help="cuda (one card per rank) or cpu")
    args = parser.parse_args()
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    from biped_mpc_py_torch.parallel import sharding

    sharding._main()

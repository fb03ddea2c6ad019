"""What the stage-timing tools share: the bench budget, the batched standing
worlds, graph timing in turns, and the card line.

The tools are the counterparts of the JAX repo's ``tools/bench_*.py``. There
a compiled variant is one ``jax.jit`` of a ``lax.scan`` and an isolated
stage is ``scan``-ed 100 times inside one program (``tools/bench_stages.py::
scan100``, ``tools/bench_art_stages.py::timed``). Here a variant is a
``graphed`` rollout (one tick captured as a CUDA graph, replayed
``n_steps`` times) and a stage is ``repeats`` calls captured in one
:class:`~biped_mpc_py_torch.utils.graphs.TickGraph`. Each is timed with CUDA
events around its replays only: the copy of the inputs into the graph's
buffers is outside the window. On CUDA nothing is dead-code eliminated, so
the JAX tools' trick of tying every repeat to the carry is not carried
over: every repeat recomputes the stage from the same inputs.

Variants (and stages) run in turns, A B C A B C ..., and each reports the
best of ``reps`` rounds. On CPU tensors the same graphs step eagerly and the
host clock times them (a check of the tools at a tiny size, not a device
number). Nothing is caught: a variant that fails raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from biped_mpc_py_torch.config import MpcConfig
from biped_mpc_py_torch.models.biped import BipedParams
from biped_mpc_py_torch.ops import qp as qp_ops
from biped_mpc_py_torch.ops.cuda.qp_kernel import fused_qp_solve_reference
from biped_mpc_py_torch.ops.qp import CondensedQp, ruiz_equilibrate, scaled_warm_start
from biped_mpc_py_torch.parallel import rollout, rollout_art
from biped_mpc_py_torch.utils.device import card_line, entry_device
from biped_mpc_py_torch.utils.graphs import TickGraph, kernel_wrappers, leaves

# The JAX tools' fast articulated budget (tools/bench_tick_stages.py:54-62,
# the same in bench_tick_kernel.py, bench_art_probe.py, bench_art_stages.py):
# the bench budget with the three bf16 knobs on.
BUDGET = dict(
    n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10,
    kinv_bf16_iters=8, admm_bf16_matvec=True, ruiz_bf16_norms=True,
)
KNOBS_OFF = dict(kinv_bf16_iters=0, admm_bf16_matvec=False, ruiz_bf16_norms=False)
DEFAULT_REPS = 3  # BENCH_REPS' default in tools/bench_tick_stages.py


def launches(qp: int = 0, substeps: int = 0, tick: int = 0, ruiz: int = 0) -> dict:
    """Launches of the QP, substep, tick and Ruiz kernels, keyed as a
    record's ``launches``."""
    return {"fused_qp_solve": qp, "fused_substeps": substeps, "fused_tick": tick,
            "fused_ruiz": ruiz}


def fast_art_mpc(**kw) -> MpcConfig:
    """``art_mpc_config`` at :data:`BUDGET`, ``kw`` replacing any field
    (``tools/bench_tick_stages.py::fast_art_mpc``)."""
    return rollout_art.art_mpc_config(**(BUDGET | kw))


def art_worlds(mpc: MpcConfig, n: int, device):
    """(worlds, bipeds): ``n`` identical standing articulated envs and the
    default robot for each, as the JAX tools broadcast ``init_art_world``
    and ``BipedParams()``."""
    return (rollout_art.init_art_world(mpc, n, device=device),
            BipedParams().expand(n).to(device))


def srb_worlds(mpc: MpcConfig, n: int, device):
    """(worlds, bipeds): ``n`` identical standing SRB envs (``batch_worlds``)
    and the default robot for each."""
    return rollout.batch_worlds(mpc, n, device=device), BipedParams().expand(n).to(device)


def card(device: torch.device) -> dict:
    """``device`` (the card's name, or ``cpu``) and ``card`` (its
    ``nvidia-smi`` name and power limit; None on the CPU)."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device), "card": card_line()}
    return {"device": "cpu", "card": None}


def scaled_core(qp: CondensedQp, mpc: MpcConfig) -> tuple:
    """The eight tensors ``fused_qp_solve`` takes for ``qp``'s cold solve
    at ``mpc``'s Ruiz settings: P, Ah, q, l, u, x0, z0, y0, scaled."""
    Ph, qh, Ah, lh, uh, D, E, c = ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    return (Ph, Ah, qh, lh, uh) + scaled_warm_start(None, D, E, c, Ph.shape[-1])


@contextlib.contextmanager
def plain_core():
    """Inside the block, ``ops.qp.solve_qp`` (and every rollout that calls
    it) runs its Ruiz scaling and its core through their plain versions
    (``scale_qp_reference``, ``fused_qp_solve_reference``) in place of the
    kernels, on any device."""
    saved = qp_ops.scale_qp, qp_ops.fused_qp_solve
    qp_ops.scale_qp, qp_ops.fused_qp_solve = qp_ops.scale_qp_reference, fused_qp_solve_reference
    try:
        yield
    finally:
        qp_ops.scale_qp, qp_ops.fused_qp_solve = saved


def solve_plain(qp: CondensedQp, mpc: MpcConfig):
    """``ops.qp.solve_qp(qp, mpc)`` (cold) under :func:`plain_core`."""
    with plain_core():
        return qp_ops.solve_qp(qp, mpc)


class _Clock:
    """Elapsed ms of a window: CUDA events on the card, the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(graph: TickGraph, per: int = 1) -> dict:
    """The kernel wrappers' launches per replay of ``graph`` over ``per``."""
    return {f.__name__: graph.launches.get(f, 0) / per for f in kernel_wrappers()}


def _in_turns(graphs: dict, reps: int, n: int, load=None) -> dict:
    """Best ms of ``n`` replays per graph over ``reps`` rounds, the graphs
    in turns within each round; ``load(key, graph)`` runs before each
    timed window."""
    best = dict.fromkeys(graphs, float("inf"))
    for _ in range(reps):
        for key, g in graphs.items():
            if load is not None:
                load(key, g)
            with _Clock(g.device) as clock:
                g.replay(n)
            best[key] = min(best[key], clock.ms)
    return best


def time_graphs(cases: dict, n_steps: int, reps: int) -> dict:
    """Time compiled rollouts in turns.

    ``cases`` maps a key to ``(fn, args)``: ``fn`` a ``graphed`` factory's
    function of ``n_steps`` ticks (``fn.graphs`` holds its ``TickGraph``),
    ``args`` its inputs (worlds first). Each ``fn(*args)`` is called once
    (the capture and a first run, ``capture_s``); then every round loads
    ``args``' worlds into each graph's carry and times its ``n_steps``
    replays. -> {key: {"ms": best ms a tick, "capture_s", "pool_mb",
    "launches": per replay (one tick), "world": the final world}}.
    """
    graphs, out = {}, {}
    for key, (fn, args) in cases.items():
        device = leaves(args)[0].device
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        capture_s = time.perf_counter() - t0
        (g,) = fn.graphs.values()
        graphs[key] = g
        out[key] = {"capture_s": capture_s, "pool_mb": g.pool_mb, "launches": _launches(g)}

    def load(key, g):
        for d, s in zip(leaves(g.carry), leaves(cases[key][1][0]), strict=True):
            d.copy_(s)

    with torch.no_grad():
        for key, ms in _in_turns(graphs, reps, n_steps, load).items():
            out[key] |= {"ms": ms / n_steps, "world": graphs[key].carry.map(torch.clone)}
    return out


def _repeat(f, repeats: int):
    def step(_, *args):
        for _ in range(repeats - 1):
            f(*args)
        return f(*args)

    return step


def time_stages(cases: dict, repeats: int, reps: int) -> dict:
    """Time isolated stages in turns.

    ``cases`` maps a key to ``(f, args)``: ``f(*args)`` returns a tensor or
    a tree of tensors, and non-tensor inputs are closed over in ``f``. Each
    stage's ``repeats`` calls are captured as one ``TickGraph`` on the card
    (the counterpart of ``scan100``); every round times one replay of each.
    -> {key: {"ms": best ms a call, "capture_s", "pool_mb", "launches": per
    call, "out": the stage's output}}.
    """
    graphs, out = {}, {}
    for key, (f, args) in cases.items():
        device = leaves(args)[0].device
        t0 = time.perf_counter()
        with torch.no_grad():
            first = f(*args)
        g = TickGraph(_repeat(f, repeats), first, *args)
        _sync(device)
        graphs[key] = g
        out[key] = {"capture_s": time.perf_counter() - t0, "pool_mb": g.pool_mb,
                    "launches": _launches(g, repeats)}
    for key, ms in _in_turns(graphs, reps, 1).items():
        out[key] |= {"ms": ms / repeats, "out": graphs[key].carry}
    return out


def world_checks(world) -> dict:
    """``falls`` (the sum over envs), ``finite`` (every float leaf of the
    world finite) and the mean base height ``z_mean`` of an articulated
    world."""
    return {"falls": float(world.metrics.falls.sum()),
            "finite": all(bool(torch.isfinite(t).all()) for t in leaves(world)
                          if t.is_floating_point()),
            "z_mean": float(world.sim.pos[:, 2].mean())}


def graph_record(tool: str, key: str, label: str, timed: dict, envs: int, steps: int,
                 where: dict) -> dict:
    """One variant's record: its ms a tick, env-steps/s, launches per
    replay, pool MB, capture seconds, the final world's checks and the
    card."""
    return {"tool": tool, "name": key, "label": label.strip(), "envs": envs, "steps": steps,
            "ms": timed["ms"], "env_steps_per_s": envs / timed["ms"] * 1e3,
            "launches": timed["launches"], "pool_mb": timed["pool_mb"],
            "capture_s": timed["capture_s"], **world_checks(timed["world"]), **where}


def stage_record(tool: str, key: str, label: str, timed: dict, envs: int, repeats: int,
                 where: dict) -> dict:
    """One isolated stage's record: ms a call at ``envs`` envs, launches
    per call, pool MB, capture seconds and the card."""
    return {"tool": tool, "name": key, "label": label.strip(), "envs": envs,
            "repeats": repeats, "ms": timed["ms"], "launches": timed["launches"],
            "pool_mb": timed["pool_mb"], "capture_s": timed["capture_s"], **where}


def emit(text: str, record: dict) -> None:
    """Print one record: the JAX tool's line, then the record as JSON on the
    same line (``parse`` reads it back)."""
    print(f"{text}  {json.dumps(record)}", flush=True)


def parse(line: str) -> dict:
    """The record of a line that :func:`emit` printed."""
    return json.loads(line[line.index("{"):])


def header(tool: str, where: dict, **sizes) -> None:
    """The first line of a tool's output: the card (its ``nvidia-smi`` name
    and power limit) and the sizes, as the JAX tools print their devices."""
    size = " ".join(f"{k}={v}" for k, v in sizes.items())
    print(f"{tool}: device {where['device']} | nvidia-smi: {where['card']}  {size}", flush=True)


def main(tool: str, run, line, defaults: tuple, argv=None, device="cuda",
         sizes=("envs", "steps"), **run_kw) -> int:
    """A tool's command: ``argv`` (``sys.argv[1:]``) as ``[envs] [steps]``,
    each missing one at its ``defaults`` entry, and ``BENCH_REPS`` rounds
    (:data:`DEFAULT_REPS`); the header, then ``run(envs, steps, reps,
    device=device, **run_kw)``'s records, each printed as ``line(record,
    envs)`` and its JSON. ``device`` is for a check on the CPU."""
    argv = sys.argv[1:] if argv is None else argv
    envs, steps = (int(argv[i]) if len(argv) > i else d for i, d in enumerate(defaults))
    reps = int(os.environ.get("BENCH_REPS", str(DEFAULT_REPS)))
    device = entry_device(device)
    header(tool, card(device), **dict(zip(sizes, (envs, steps), strict=True)))
    for r in run(envs, steps, reps, device=device, **run_kw):
        emit(line(r, envs), r)
    return 0

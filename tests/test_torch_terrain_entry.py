"""The port's rough-ground entry against the benchmark's plain reference of
it: ``parallel/rollout_art.py::batched_art_rollout_terrain_fn`` (the graph's
static-buffer step, eager on the CPU) against
``benchmark/reference/entries_terrain.py::art_terrain_tick``, on seeded
inputs: 4 perturbed standing envs, one 16 x 16 field of 0.04 m each, 2
ticks at the fast budget, 8 periods of 5 substeps, Minv held all tick. The
same reference on flat ground (a planted fault) fails each of the same
tolerances."""

import dataclasses
import functools

import pytest
import torch

import biped_mpc_py_torch as bt
from benchmark.harness import common, tree
from benchmark.reference import config as rconfig
from benchmark.reference import entries_terrain
from benchmark.reference.precision import matmul
from benchmark.reference.sim import contact as rcontact
from torch_threads import one_torch_thread  # noqa: F401

N, TICKS = 4, 2
KW = dict(n_lowlevel=8, n_substeps=5, minv_ll_hold=8)
FAST = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10,
            kinv_bf16_iters=8, admm_bf16_matvec=True, ruiz_bf16_norms=True)
# The reference is frozen from the port's plain code, so on the CPU the two run
# the same f32 arithmetic and agree to the bit today; each tolerance leaves room
# for f32 roundoff a reordered sum would carry through 2 ticks of 40 substeps,
# and is far below what the flat-ground fault moves (pose 2e-3, velocity 0.37,
# force 15 N on these inputs).
TOL = {
    "pose": 1e-5,  # pos (m), quat, q (rad): a few ulps of 0.5 m carried 80 substeps
    "velocity": 1e-3,  # v_base, qd (rad/s, m/s): contact stiffness amplifies roundoff
    "force": 1e-2,  # first MPC control (N): the bf16 knobs flip on a last-bit change
}


def _inputs():
    mpc = bt.art_mpc_config(**FAST)
    world = bt.perturbed_worlds(mpc, N, torch.Generator().manual_seed(21), device="cpu")
    fields = bt.Terrain.rough_batch(torch.Generator().manual_seed(22), N, amplitude=0.04,
                                    res=16, device="cpu")
    return mpc, bt.GaitConfig(), world, bt.BipedParams().expand(N), fields


@functools.cache
def _program():
    mpc, gait, world, bipeds, fields = _inputs()
    return bt.batched_art_rollout_terrain_fn(TICKS, mpc, gait, **KW)(world, bipeds, fields)


def _reference(flat: bool):
    mpc, gait, world, bipeds, fields = _inputs()
    reg = {**common.reference_classes(), **tree.classes(rcontact)}
    rmpc = rconfig.MpcConfig(**{f.name: getattr(mpc, f.name) for f in dataclasses.fields(mpc)})
    rgait = rconfig.GaitConfig(**{f.name: getattr(gait, f.name)
                                  for f in dataclasses.fields(gait)})
    w, b, t = (tree.rebuild(x, reg) for x in (world, bipeds, fields))
    if flat:
        t = dataclasses.replace(t, heights=torch.zeros_like(t.heights))
    with matmul(), torch.no_grad():
        for _ in range(TICKS):
            w = entries_terrain.art_terrain_tick(w, b, rmpc, rgait, None, terrains=t, **KW)
    return w


def _gaps(a, b) -> dict:
    def gap(fields):
        return max(float((getattr(a.sim, f) - getattr(b.sim, f)).abs().max()) for f in fields)

    force = float((a.ctrl.qp.controls[:, 0] - b.ctrl.qp.controls[:, 0]).abs().max())
    return {"pose": gap(("pos", "quat", "q")), "velocity": gap(("v_base", "qd")),
            "force": force}


@pytest.mark.parametrize("flat", [False, True], ids=["fields", "flat_fault"])
def test_terrain_entry_matches_the_reference(flat):
    gaps = _gaps(_program(), _reference(flat))
    within = {k: v <= TOL[k] for k, v in gaps.items()}
    assert all(v != flat for v in within.values()), gaps

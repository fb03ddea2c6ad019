"""The frozen reference (``benchmark/reference``) against the port's plain
path, on the CPU at a few envs and ticks: bit-equal where the arithmetic is
the same, as it was when the reference was frozen."""

from __future__ import annotations

import dataclasses

import torch

import biped_mpc_py_torch as bt
from benchmark.harness import common, tree
from benchmark.reference import loops
from benchmark.reference.config import GaitConfig as RGait
from benchmark.reference.config import MpcConfig as RMpc
from benchmark.reference.models.biped import BipedParams as RBiped
from benchmark.reference.precision import matmul
from benchmark.reference.sim.model import hector_model

FAST = dict(n_admm_iters=40, admm_rho_phases=1, admm_polish=False, kinv_ns_iters=10,
            kinv_bf16_iters=8, admm_bf16_matvec=True, ruiz_bf16_norms=True)


def _ref_mpc(m):
    return RMpc(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


def _equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb) and la
    return max(float((x - y).abs().max()) for x, y in zip(la, lb))


def test_srb_cmd_loop_bit_equal():
    n = 3
    m = bt.fast_mpc_config()
    x = torch.zeros(n, 12)
    x[:, 5], x[:, 9] = 0.55, torch.tensor([0.0, 0.2, 0.4])
    b = bt.randomize_params(torch.Generator().manual_seed(1), n, device="cpu")
    prog = bt.batched_cmd_rollout(bt.batch_worlds(m, n, device="cpu"), b, x, 3, m,
                                  bt.GaitConfig())
    rm = _ref_mpc(m)
    rw = loops.init_world(rm, n, device="cpu")
    rb = tree.rebuild(b, common.reference_classes())
    with matmul(), torch.no_grad():
        for _ in range(3):
            rw = loops.srb_tick(rw, rm, RGait(), rb, x)
    assert _equal(prog, rw) == 0.0


def test_art_tick_path_bit_equal():
    n = 3
    m = bt.art_mpc_config(**FAST)
    w = bt.perturbed_worlds(m, n, torch.Generator().manual_seed(2), device="cpu")
    b = bt.randomize_params(torch.Generator().manual_seed(3), n, device="cpu")
    prog = bt.batched_art_rollout_tick_kernel(w, b, 2, m, bt.GaitConfig())
    rm = _ref_mpc(m)
    registry = common.reference_classes()
    rw, rb = tree.rebuild(w, registry), tree.rebuild(b, registry)
    with matmul(), torch.no_grad():
        for _ in range(2):
            rw = loops.art_tick(rw, rb, rm, RGait(), hector_model(device="cpu"), RBiped(), 8, 5)
    assert _equal(prog, rw) == 0.0


def test_realtime_steps_bit_equal():
    """One tick of ``RealtimeLoop``'s two graphs (run eagerly on the CPU)
    against ``realtime_solve`` and ``realtime_lowlevel`` on the same read."""
    m = bt.art_mpc_config()
    loop = bt.RealtimeLoop(m, bt.GaitConfig(), bt.BipedParams(), device="cpu")
    read = torch.zeros(1, 39)
    read[0, 5], read[0, 14], read[0, 17], read[0, 38] = 0.53, 0.09, -0.09, 0.12
    read[0, 12:18] = torch.tensor([-0.02, 0.09, 0.0, -0.02, -0.09, 0.0])
    loop.state.read.copy_(read)
    s0 = tree.rebuild(loop.state, common.port_classes())
    s1 = loop._lowlevel_step(loop._solve_step(loop.state))
    rm = _ref_mpc(m)
    qp = tree.rebuild(s0.qp, common.reference_classes())
    with matmul(), torch.no_grad():
        sol, cmd, vint, contact, u0, vint_ll = loops.realtime_solve(
            read, qp, s0.cmd_ref, s0.v_int, rm, RGait(), RBiped())
        tau = loops.realtime_lowlevel(read, contact, u0, cmd, vint_ll, rm, RGait(), RBiped())
    assert _equal(s1.qp, sol) == 0.0
    assert float((s1.tau - tau).abs().max()) == 0.0


def test_configs_and_traffic_as_the_port_makes_them():
    """The configuration files hold ``MpcConfig()`` and ``art_mpc_config()``
    as run, and the generator draws robots and starts as
    ``randomize_params`` and ``perturbed_worlds`` do on the same
    generator."""
    import json
    from pathlib import Path

    from benchmark.traffic import generate

    here = Path(__file__).resolve().parent
    for name, mpc in (("hector_srb", bt.MpcConfig()), ("hector_art", bt.art_mpc_config())):
        cfg = json.loads((here / "configs" / f"{name}.json").read_text())
        assert bt.MpcConfig(**cfg["mpc"]) == mpc
        assert bt.GaitConfig(**cfg["gait"]) == bt.GaitConfig()
    traffic = {"envs": 5, "robots": {"mass_scale": [0.8, 1.2], "inertia_scale": [0.8, 1.2],
                                     "mu": [0.4, 0.7]}, "start_joint_sigma_rad": 2e-3}
    ours = generate.robots(traffic, torch.Generator().manual_seed(4))
    port = bt.randomize_params(torch.Generator().manual_seed(4), 5, device="cpu")
    assert _equal(port, ours) == 0.0
    m = bt.art_mpc_config()
    ours = generate.starts(loops.init_art_world, _ref_mpc(m), traffic,
                           torch.Generator().manual_seed(5))
    port = bt.perturbed_worlds(m, 5, torch.Generator().manual_seed(5), device="cpu")
    assert _equal(port, ours) == 0.0

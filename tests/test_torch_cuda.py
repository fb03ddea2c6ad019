"""The torch port's CUDA kernels on the card: the fused ADMM QP solve, the
fused articulated substeps and the fused tick, each held against its plain
PyTorch version, and the rollouts' launch counts.

Every test here needs an NVIDIA GPU with nvcc and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance: unscaled controls within 0.05 N at the bench budget (1 phase, no
polish), with and without the torsional cone and at short horizons (the
mma tiles' ragged edge); both sides compute at f32 accuracy (the kernel's
Newton-Schulz products in split TF32 on the tensor cores, see
tests/test_torch_qp_tf32.py) and differ in summation order. At
the default budget (3 phases + polish) the solve is discontinuous in
roundoff (the polish's active set and merit accept flip on last-bit
differences: about one env in a hundred lands tens of N away for any two
f32 implementations), so the kernel may put no more envs past 0.1 N than
the plain version on the CPU does against itself on the card (twice that,
plus five), and the median env agrees within 0.01 N; see
chip_smoke.py::phase_kernel.

The substep kernel: the bounds of ``tests/test_substep_kernel.py:73-76``
(pos 5e-7, quat 1e-6, v_base 5e-6, q 1e-6, qd 1e-4) on 1024 perturbed
in-contact envs, 5 substeps of 1 ms, at batch sizes that leave a warp's
last env pairs empty (the kernels give an env to two lanes, 16 envs to a
warp: N = 1, 17, 33, 1000); the kernel path of the articulated loop
launches it once per low-level period (8 per tick).

The tick kernel: the bounds of ``tests/test_tick_kernel.py:257-261`` (q,
pos, quat 5e-4, qd 2e-2, energy rtol 2e-3 / atol 1e-3) on perturbed
in-contact envs with random clocks, flags and controls, one tick of 8
periods x 5 substeps, for the bench config and for configs that set the
kernel's four switches, at the same ragged batch sizes and with the contact
flags all stance, all swing and mixed; the tick-kernel path launches it
once per tick and the substep kernel never. Both kernels also run a batch
whose even envs are pressed deep into the ground and whose odd envs hang in
the air, so that a lane that read its neighbour's env would show.

The QP kernel with per-env ``rho``, ``sigma`` and ``alpha`` (four value
groups): within 0.05 N per env of the plain version with the same per-env
values at the bench budget, and bit-equal per env to one scalar launch per
group (one env per CTA: an env's result does not depend on the others'
values); per-env values all equal to the config's are bit-equal to the
scalar launch; a per-env tensor of the wrong shape, dtype, device or
stride raises before any launch.

The sweep (``parallel/sweep.py``): with per-env gains and one ``dt`` it
runs the tick path with the tick kernel's per-env variant, 8 envs x 2
ticks on the card against the same path's plain version on the CPU within
``CHAIN_BOUNDS`` of ``tests/test_torch_rollout_art.py`` (pos 1e-4, quat
1e-4, v_base 2e-3, q 1e-3, qd 2e-2), ``t`` bit-equal, one QP and one tick
launch per tick; with per-env MPC fields and a per-env ``dt`` (weights,
Raibert gains, the ADMM numerics) the plain chain, against the CPU within
the same bounds, one QP launch per tick and no physics launch; the tick
kernel refuses a per-env ``dt`` and per-env values on a field before it
launches. The tick kernel's per-env variant (``fused_tick(x_cmd=,
per_env=)``, each env's control constants from ``tick_table``): at 4096,
1024 and 17 envs, four configs of command, swing, Raibert and heading
gains, one tick against its plain version (``fused_tick_reference`` with
the same values) within the flat kernel's bounds, ``t`` bit-equal, one
tick launch; with every row the shared constants it steps as the flat
kernel within the same bounds, ``t`` bit-equal. The N = 1 loops
(``RealtimeLoop``, and ``run_mujoco_closed_loop`` where MuJoCo is
installed) with the controller on the card against the CPU, 5 ticks at the
bench budget: feedback attitude and position 1e-4, velocities 2e-3 (the
bounds of ``tests/test_torch_deploy.py``). The new entry points build on
the card by default.

The substep kernel's field variant (a height field per env): at 4096, 17
and 1 envs on a 4 cm ``Terrain.rough_batch`` field each, 5 substeps of 1 ms
against ``art_step(..., terrain, Minv=)`` on the card within the substep
kernel's bounds above, ``t`` bit-equal (the plain chain's 5 f32 additions),
and its count of sole points below the ground within 1 of the plain
chain's in each entry and in at most 4 entries (a point flips only where
its gap to the ground lies within the two sides' rounding, ~1e-7 m); on
flat fields it agrees with the flat kernel within the same bounds (the two
grounds share every line but the contact, which on a flat field rounds a
few envs' forces apart: qd 3.3e-6 at most in 5 substeps); an env seeded
with NaN ends all NaN without a device fault and
leaves its neighbours bit-unchanged. The terrain path launches it once per
low-level period: 64 envs x 2 ticks of ``batched_art_rollout_terrain`` on
the card against the same rollout on the CPU (pos 1e-3, q 1e-2, qd 1.0: the
QP kernel and its plain version differ by up to 0.05 N per solve, and stiff
contact grows that), 2 QP and 2 tick launches (the terrain path's
low-level loop is the tick kernel's field variant since it exists) and no
substep launch; the substep wrapper raises on a shared field and on a
per-env ``dt``, the tick kernel on a shared field and on a field without
its robots, before they launch.

The tick kernel's field variant (``fused_tick(terrain=)``): at 4096, 1024
and 17 envs from perturbed in-contact states with random clocks, flags and
controls, each on a 4 cm ``Terrain.rough_batch`` field of 64 x 64 (the
terrain cell's draw), one tick against its plain version
(``fused_tick_field_reference``, the terrain periods of ``_art_tick``)
within the flat tick kernel's bounds above, ``t`` bit-equal (the plain
chain's 40 f32 additions), the energy within the same rtol / atol and the
ground count within 1 of the plain chain's in at most 4 entries, one tick
launch and no substep launch; a batch on two leg geometries (even envs
FK, odd envs Jacobian) holds its plain version and equals, env by env and
bit for bit, the launches whose robots all share one geometry.

The compiled entry points (``*_fn``, one tick captured as a CUDA graph): at
1024 envs and the bench budget, a replay bit-equal to the eager loop on
every leaf (SRB and the tick path 10 ticks, the substep path 5), with the
launch counters reading the replays' launches (the plain chain, the
per-env terrain walk and the 4 x 4 x 64 sweep 3 ticks each: the terrain
walk's and the sweep's tick-kernel launches 1 a tick, the plain chain's
none); the sharded ``*_fn`` on one NCCL rank bit-equal
to the eager sharded loops; ``RealtimeLoop`` on its two graphs, and the
MuJoCo loop's ``MjController`` on its three, walk
``chip_smoke.EnginePlant``; replay's graphed frames and the demo's graphed
tick equal their eager forms; a step that synchronizes the host raises at
capture and runs no eager fallback.
"""

import dataclasses
import gc

import pytest
import torch

from biped_mpc_py_torch import BipedParams, GaitConfig, MpcConfig, fast_mpc_config
from biped_mpc_py_torch.control.gait import contact_sequence
from biped_mpc_py_torch.control.mpc import build_mpc_qp
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.ops.cuda import qp_kernel as tk
from biped_mpc_py_torch.ops.cuda import ruiz_kernel as rk
from biped_mpc_py_torch.ops.cuda import substep_kernel as sk
from biped_mpc_py_torch.ops.cuda import tick_kernel as tick
from biped_mpc_py_torch.parallel import rollout_art as ra
from biped_mpc_py_torch.parallel.rollout import (
    batch_worlds,
    batched_rollout,
    batched_rollout_fn,
    randomize_params,
)
from biped_mpc_py_torch.sim.contact import Terrain
from biped_mpc_py_torch.sim.engine import ArtState, art_step, mass_matrix_inv
from biped_mpc_py_torch.sim.model import hector_model
from biped_mpc_py_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _mpc_qps(n, device, mpc, seed=0):
    """Perturbed standing states at several gait phases, randomized robots."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.zeros(n, 12)
    x[:, 5] = 0.53
    x += 0.05 * torch.randn(n, 12, generator=gen)
    foot = torch.tensor([-0.02, 0.09, 0.0, -0.02, -0.09, 0.0]).repeat(n, 1)
    t = (torch.arange(n) % 10).to(torch.float32) * mpc.dt
    biped = randomize_params(gen, n, device=device)
    x, foot, t = x.to(device), foot.to(device), t.to(device)
    contact = contact_sequence(t, mpc, GaitConfig())
    return build_mpc_qp(x, t, foot, mpc, biped, contact, GaitConfig())


def _bench(**over):
    """The bench budget with the bf16 knobs off (every NS step after the
    first in 3xTF32, f32 elsewhere)."""
    return dataclasses.replace(fast_mpc_config(**over), kinv_bf16_iters=0,
                               admm_bf16_matvec=False, ruiz_bf16_norms=False)


def _bench_ns(**over):
    """The bench budget with the bf16 NS steps and Ruiz norms, the K^-1
    product in f32 (the kernel's bf16 mma.sync path, held per env)."""
    return dataclasses.replace(fast_mpc_config(**over), admm_bf16_matvec=False)


# The kernel's cases: both budgets, the torsional cone (28 rows per step)
# and short horizons (n = 60 and 84 variables: the mma tiles' ragged edge),
# the bench ones also with the bf16 NS steps (k-steps of 16).
QP_CASES = {
    "bench": _bench(),
    "default": MpcConfig(),
    "bench-cone": _bench(mu_z=0.03),
    "default-cone": MpcConfig(mu_z=0.03),
    "bench-h5": _bench(h=5),
    "bench-h7-cone": _bench(h=7, mu_z=0.03),
    "bench-bf16ns": _bench_ns(),
    "bench-bf16ns-h5": _bench_ns(h=5),
    "bench-bf16ns-h7-cone": _bench_ns(h=7, mu_z=0.03),
}


@pytest.mark.parametrize("budget", list(QP_CASES))
def test_kernel_matches_plain(cuda, budget):
    mpc = QP_CASES[budget]
    qp = _mpc_qps(256, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    x0, z0, y0 = tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1])
    kw = tqp.solver_args(mpc)
    before = tk.fused_qp_solve.launches
    out_k = tk.fused_qp_solve(Ph, Ah, qh, lh, uh, x0, z0, y0, **kw)
    torch.cuda.synchronize()
    assert tk.fused_qp_solve.launches == before + 1
    out_p = tk.fused_qp_solve_reference(Ph, Ah, qh, lh, uh, x0, z0, y0, **kw)
    sol_k = tqp.recover_solution(qp, *out_k, D, E, c)
    sol_p = tqp.recover_solution(qp, *out_p, D, E, c)
    assert torch.isfinite(sol_k.controls).all()
    du = (sol_k.controls - sol_p.controls).abs().flatten(1).amax(1)
    if budget.startswith("bench"):
        assert float(du.max()) < 0.05
        assert float((sol_k.res_prim - sol_p.res_prim).abs().max()) < 5e-3
        return
    out_c = tk.fused_qp_solve_reference(
        *[a.cpu() for a in (Ph, Ah, qh, lh, uh, x0, z0, y0)], **kw
    )
    sol_c = tqp.recover_solution(qp, *[o.to(cuda) for o in out_c], D, E, c)
    noise = (sol_c.controls - sol_p.controls).abs().flatten(1).amax(1)
    assert float(du.median()) < 0.01
    assert int((du > 0.1).sum()) <= 2 * int((noise > 0.1).sum()) + 5


def test_kernel_bf16_knobs_match_plain(cuda):
    """The bench budget as the JAX bench runs it (``fast_mpc_config()``: the
    bf16 NS steps, K^-1 product and Ruiz norms), kernel against plain on 64
    QPs. Every ADMM step rounds its right-hand side to bf16, so a last-bit
    difference can flip a rounding and move the iterates by a bf16 step
    (chip_smoke.py::phase_kernel measures that noise floor at 1024 QPs):
    the kernel's median env agrees within a twentieth of the knobs' own
    effect (the plain version at knobs-on against knobs-off, tens of N),
    and every env lies nearer to the plain knobs-on solve than half its
    effect."""
    mpc = fast_mpc_config()
    qp = _mpc_qps(64, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    kw = tqp.solver_args(mpc)
    assert kw["bf16_iters"] == 8 and kw["bf16_matvec"]
    u_k = tqp.recover_solution(qp, *tk.fused_qp_solve(*args, **kw), D, E, c).controls
    u_p = tqp.recover_solution(qp, *tk.fused_qp_solve_reference(*args, **kw), D, E, c).controls
    u_off = tqp.solve_qp(qp, _bench()).controls
    du = (u_k - u_p).abs().flatten(1).amax(1)
    effect = (u_off - u_p).abs().flatten(1).amax(1)
    assert torch.isfinite(u_k).all()
    assert float(du.median()) < 0.05 * float(effect.median())
    assert bool((du < 0.5 * effect).all()), (du, effect)


def test_kernel_knobs_off_is_the_launch_without_them(cuda):
    """bf16_iters=0 and bf16_matvec=False launch the f32 kernel: bit-equal
    to a launch that leaves the knob arguments out."""
    mpc = _bench()
    qp = _mpc_qps(64, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    kw = tqp.solver_args(mpc)
    assert kw["bf16_iters"] == 0 and not kw["bf16_matvec"]
    omitted = {k: v for k, v in kw.items() if not k.startswith("bf16")}
    for a, b in zip(tk.fused_qp_solve(*args, **kw), tk.fused_qp_solve(*args, **omitted)):
        assert torch.equal(a, b)


def test_kernel_launch_count_per_solve(cuda):
    mpc = fast_mpc_config()
    qp = _mpc_qps(32, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    before = tk.fused_qp_solve.launches
    for i in range(3):
        tk.fused_qp_solve(*args, **tqp.solver_args(mpc))
        assert tk.fused_qp_solve.launches == before + i + 1
    tk.fused_qp_solve_reference(*args, **tqp.solver_args(mpc))
    tk.fused_qp_solve(*[a.cpu() for a in args], **tqp.solver_args(mpc))
    torch.cuda.synchronize()
    assert tk.fused_qp_solve.launches == before + 3


def test_kernel_rejects_misaligned_P(cuda):
    """The kernel reads P as float4: a contiguous P off a 16-byte boundary
    raises before any launch."""
    mpc = fast_mpc_config()
    qp = _mpc_qps(4, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    shifted = torch.empty(Ph.numel() + 1, device=cuda)[1:].view_as(Ph)
    shifted.copy_(Ph)
    args = (shifted, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    before = tk.fused_qp_solve.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.fused_qp_solve(*args, **tqp.solver_args(mpc))
    assert tk.fused_qp_solve.launches == before


def _numerics_groups(n, device):
    """Per-env (rho, sigma, alpha): four value groups of n // 4 envs."""
    values = torch.tensor([[0.1, 1e-6, 1.6], [0.3, 1e-5, 1.4], [1.0, 1e-4, 1.8],
                           [3.0, 1e-6, 1.2]])
    per_env = values.repeat_interleave(n // 4, 0).to(device)
    return values, {k: per_env[:, i].contiguous() for i, k in
                    enumerate(("rho", "sigma", "alpha"))}


@pytest.mark.parametrize("budget", ["bench", "default"])
def test_kernel_per_env_numerics(cuda, budget):
    mpc = QP_CASES[budget]
    n = 256
    qp = _mpc_qps(n, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    kw = tqp.solver_args(mpc)
    values, per_env = _numerics_groups(n, cuda)
    before = tk.fused_qp_solve.launches
    out = tk.fused_qp_solve(*args, **{**kw, **per_env})
    torch.cuda.synchronize()
    assert tk.fused_qp_solve.launches == before + 1
    g = n // 4
    for i, (rho, sigma, alpha) in enumerate(values.tolist()):
        rows = slice(i * g, (i + 1) * g)
        part = tk.fused_qp_solve(*[a[rows] for a in args],
                                 **{**kw, "rho": rho, "sigma": sigma, "alpha": alpha})
        for u, v in zip(out, part):
            assert torch.equal(u[rows], v), i
    same = {k: torch.full((n,), kw[k], device=cuda) for k in per_env}
    for u, v in zip(tk.fused_qp_solve(*args, **kw), tk.fused_qp_solve(*args, **{**kw, **same})):
        assert torch.equal(u, v)
    if budget == "bench":
        ref = tk.fused_qp_solve_reference(*args, **{**kw, **per_env})
        du = (tqp.recover_solution(qp, *out, D, E, c).controls
              - tqp.recover_solution(qp, *ref, D, E, c).controls).abs()
        assert float(du.max()) < 0.05


@pytest.mark.parametrize("fault", ["shape", "dtype", "device", "strided"])
def test_kernel_rejects_bad_per_env_numerics(cuda, fault):
    mpc = fast_mpc_config()
    n = 8
    qp = _mpc_qps(n, cuda, mpc)
    Ph, qh, Ah, lh, uh, D, E, c = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    args = (Ph, Ah, qh, lh, uh, *tqp.scaled_warm_start(None, D, E, c, Ph.shape[-1]))
    bad = {"shape": torch.full((n + 1,), 0.3, device=cuda),
           "dtype": torch.full((n,), 0.3, dtype=torch.float64, device=cuda),
           "device": torch.full((n,), 0.3),
           "strided": torch.full((2 * n,), 0.3, device=cuda)[::2]}[fault]
    before = tk.fused_qp_solve.launches
    with pytest.raises((ValueError, TypeError), match="rho"):
        tk.fused_qp_solve(*args, **{**tqp.solver_args(mpc), "rho": bad})
    assert tk.fused_qp_solve.launches == before


# The Ruiz kernel's cases: every horizon and row count the repo solves (h =
# 5, 7, 10; m = 24, or 28 with the torsional cone), both norm precisions,
# cold and warm starts at 33 envs, and at the real horizon 1 env (the N = 1
# solve graph) and 4096 (the batched cells).
RUIZ_CASES = [(33, h, m, bf16, warm) for h in (5, 7, 10) for m in (24, 28)
              for bf16 in (False, True) for warm in (False, True)]
RUIZ_CASES += [(n, 10, m, bf16, warm) for n in (1, 4096) for m in (24, 28)
               for bf16 in (False, True) for warm in (False, True)]
RUIZ_OUTPUTS = ("Ph", "qh", "Ah", "lh", "uh", "D", "E", "c", "x0", "z0", "y0")


def _ruiz_case(cuda, n, h, m, bf16, warm):
    """(mpc, qp, warm start or None): real MPC QPs at the case's shape, the
    first env with an all-zero constraint row (its E reaches the 1e6 clamp)
    and the last with A's column 7 zero and P's column 19 zero but for
    1e-12 on the diagonal, so that P is not symmetric and step 1's column 7
    starts under the 1e-8 clamp of the column norms."""
    mpc = dataclasses.replace(fast_mpc_config(h=h, mu_z=0.03 if m == 28 else None),
                              ruiz_bf16_norms=bf16)
    qp = _mpc_qps(n, cuda, mpc, seed=n + h + m)
    assert qp.l.shape[1:] == (h, m)
    A, P = qp.A_step.clone(), qp.P.clone()
    A[0, 3] = 0.0
    A[-1, :, 7] = 0.0
    P[-1, :, 19] = 0.0
    P[-1, 19, 19] = 1e-12
    qp = dataclasses.replace(qp, A_step=A, P=P)
    if not warm:
        return mpc, qp, None
    gen = torch.Generator().manual_seed(7)

    def draw(*shape, scale):
        return (scale * torch.randn((n,) + shape, generator=gen)).to(cuda)

    sol = tqp.QpSolution(controls=draw(h, 12, scale=50.0), states=draw(h, 13, scale=1.0),
                         z=draw(h, m, scale=20.0), y=draw(h, m, scale=5.0),
                         res_prim=draw(scale=1.0), res_dual=draw(scale=1.0))
    return mpc, qp, sol


@pytest.mark.parametrize("n, h, m, bf16, warm", RUIZ_CASES,
                         ids=[f"n{n}-h{h}-m{m}-{'bf16' if b else 'f32'}-{'warm' if w else 'cold'}"
                              for n, h, m, b, w in RUIZ_CASES])
def test_ruiz_kernel_matches_plain(cuda, n, h, m, bf16, warm):
    """The Ruiz kernel (one launch) against ``ruiz_equilibrate`` and
    ``scaled_warm_start`` on the card. The kernel adds the one sum, the
    mean behind each iteration's cost scaling, in the order of torch.mean on
    the card; every other number is the plain version's arithmetic in its
    order. So every output is bit-equal (0 ulps) to the plain version's, D,
    E, c, Ph and Ah included. Each iteration's column norms (bf16 products
    and a bf16 maximum with bf16 norms) enter its D and c, so equal D and c
    over 10 iterations are equal norms. The clamps engage: the zero row's E
    reads 1e6. The mean's order is ATen's reduce kernel's as of torch
    2.11.0 (CUDA 12.8), where it was matched: under a torch that orders that
    reduction otherwise, the outputs differ by a few ulps from c on, a fault
    of the match and not of the kernel's arithmetic."""
    mpc, qp, sol = _ruiz_case(cuda, n, h, m, bf16, warm)
    want = tqp.scale_qp_reference(qp, mpc, sol)
    before = rk.fused_ruiz.launches
    got = rk.fused_ruiz(qp.P, qp.q, qp.A_step, qp.l, qp.u,
                        None if sol is None else (sol.controls, sol.z, sol.y),
                        n_iters=mpc.ruiz_iters, bf16_norms=bf16)
    torch.cuda.synchronize()
    assert rk.fused_ruiz.launches == before + 1
    gaps = {}
    for name, a, b in zip(RUIZ_OUTPUTS, got, want, strict=True):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        if not torch.equal(a, b):
            ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().reshape(n, -1)
            gaps[name] = (int(ulps.max()), int((ulps > 0).any(1).sum()))
    assert not gaps, (f"(largest ulps, envs that differ) by output: {gaps}; gamma's mean is "
                      f"added in torch 2.11.0's order, this is torch {torch.__version__}")
    assert torch.equal(got[6][0, :, 3], torch.full((h,), 1e6, device=cuda))
    if not warm:
        assert all(not bool(t.any()) for t in got[8:])


def test_ruiz_kernel_refuses_what_it_does_not_take(cuda):
    """CPU tensors, a P past the shared memory of a block (h = 20: 230 KB
    of P), a P off a 16-byte boundary and a strided input each raise before
    any launch."""
    mpc = fast_mpc_config()
    qp = _mpc_qps(4, cuda, mpc)
    args = (qp.P, qp.q, qp.A_step, qp.l, qp.u)
    kw = dict(n_iters=10, bf16_norms=True)
    shifted = torch.empty(qp.P.numel() + 1, device=cuda)[1:].view_as(qp.P)
    shifted.copy_(qp.P)
    big = (torch.zeros(1, 240, 240, device=cuda), torch.zeros(1, 240, device=cuda),
           torch.zeros(1, 24, 12, device=cuda), torch.zeros(1, 20, 24, device=cuda),
           torch.zeros(1, 20, 24, device=cuda))
    before = rk.fused_ruiz.launches
    with pytest.raises(ValueError, match="on the card"):
        rk.fused_ruiz(*[a.cpu() for a in args], **kw)
    with pytest.raises(ValueError, match="shared memory"):
        rk.fused_ruiz(*big, **kw)
    with pytest.raises(ValueError, match="16-byte"):
        rk.fused_ruiz(shifted, *args[1:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        rk.fused_ruiz(*args[:4], torch.cat([qp.u, qp.u], 2)[:, :, ::2], **kw)
    assert rk.fused_ruiz.launches == before


def test_rollout_launches_kernel_once_per_tick(cuda):
    mpc = dataclasses.replace(fast_mpc_config(), x_cmd=(0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0))
    n, ticks = 16, 5
    worlds = batch_worlds(mpc, n, device=cuda)
    bipeds = randomize_params(torch.Generator().manual_seed(1), n, device=cuda)
    before = tk.fused_qp_solve.launches
    out = batched_rollout(worlds, bipeds, ticks, mpc, GaitConfig())
    torch.cuda.synchronize()
    assert tk.fused_qp_solve.launches == before + ticks
    assert torch.isfinite(out.sim.x_fb).all()
    assert float(out.metrics.falls.sum()) == 0


def _perturbed_states(n, device, seed=0):
    """Near-standing states with the soles pushed into the plane, and
    random torques (as tests/test_substep_kernel.py builds them)."""
    gen = torch.Generator().manual_seed(seed)
    base = ArtState.standing(n)
    pos = base.pos + 0.02 * torch.randn(n, 3, generator=gen)
    pos[:, 2] -= 0.03
    quat = base.quat + 0.02 * torch.randn(n, 4, generator=gen)
    quat = quat / quat.norm(dim=1, keepdim=True)
    state = ArtState(
        pos=pos, quat=quat, v_base=0.3 * torch.randn(n, 6, generator=gen),
        q=base.q + 0.05 * torch.randn(n, 10, generator=gen),
        qd=0.5 * torch.randn(n, 10, generator=gen), t=torch.zeros(n),
    )
    return state.to(device), (5.0 * torch.randn(n, 10, generator=gen)).to(device)


SUBSTEP_BOUNDS = {"pos": 5e-7, "quat": 1e-6, "v_base": 5e-6, "q": 1e-6, "qd": 1e-4}
TICK_BOUNDS = {"q": 5e-4, "pos": 5e-4, "quat": 5e-4, "qd": 2e-2}


def _deep_and_airborne(state):
    """Even envs 6 cm into the ground, odd envs 30 cm above it."""
    pos = state.pos.clone()
    pos[0::2, 2] = ArtState.standing().pos[0, 2] - 0.06
    pos[1::2, 2] += 0.3
    return dataclasses.replace(state, pos=pos)


def _substep_case(cuda, state, tau):
    model = hector_model(device=cuda)
    n = state.q.shape[0]
    Minv = mass_matrix_inv(model, state.q)
    before = sk.fused_substeps.launches
    out_k = sk.fused_substeps(model, state, tau, Minv, 0.005, 5)
    torch.cuda.synchronize()
    assert sk.fused_substeps.launches == before + 1
    out_p = sk.fused_substeps_reference(model, state, tau, Minv, 0.005, 5)
    for name, tol in SUBSTEP_BOUNDS.items():
        k, p = getattr(out_k, name), getattr(out_p, name)
        assert k.shape == (n,) + p.shape[1:] and torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err < tol, (name, err)
    assert torch.equal(out_k.t, out_p.t)


@pytest.mark.parametrize("n", [1024, 1000, 33, 17, 1])
def test_substep_kernel_matches_plain(cuda, n):
    _substep_case(cuda, *_perturbed_states(n, cuda))


def test_substep_kernel_neighbour_envs(cuda):
    """Deep penetration beside free fall in every lane pair's warp."""
    state, tau = _perturbed_states(64, cuda)
    _substep_case(cuda, _deep_and_airborne(state), tau)


def _ground_count(device):
    """A copy of the count of sole points below the ground on ``device``."""
    return profiling._ground[profiling._indexed(device)].below.clone()


def _field_case(cuda, n, nan_env=None):
    """The field kernel against ``art_step`` on the card on a 4 cm rough
    field per env; with ``nan_env``, that env's position is NaN. Returns
    (kernel state, plain state, kernel count, plain count)."""
    state, tau = _perturbed_states(n, cuda)
    model = hector_model(device=cuda)
    Minv = mass_matrix_inv(model, state.q)
    fields = Terrain.rough_batch(torch.Generator().manual_seed(2), n, amplitude=0.04,
                                 device=cuda)
    if nan_env is not None:
        pos = state.pos.clone()
        pos[nan_env] = float("nan")
        state = dataclasses.replace(state, pos=pos)
    profiling.start_ground_count(cuda)
    out_p = art_step(model, state, tau, 0.005, 5, fields, Minv=Minv)
    count_p = _ground_count(cuda)
    profiling.start_ground_count(cuda)
    before = sk.fused_substeps.launches
    out_k = sk.fused_substeps(model, state, tau, Minv, 0.005, 5, terrain=fields)
    torch.cuda.synchronize()
    assert sk.fused_substeps.launches == before + 1
    return out_k, out_p, _ground_count(cuda), count_p


@pytest.mark.parametrize("n", [4096, 17, 1])
def test_substep_field_kernel_matches_plain(cuda, n):
    out_k, out_p, count_k, count_p = _field_case(cuda, n)
    for name, tol in SUBSTEP_BOUNDS.items():
        k, p = getattr(out_k, name), getattr(out_p, name)
        assert k.shape == p.shape and torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err < tol, (name, err)
    assert torch.equal(out_k.t, out_p.t)
    assert count_k.shape == (n, 2, 2) and int(count_p.sum()) > 0
    diff = (count_k - count_p).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4, int(diff.sum())


def test_substep_field_kernel_nan_env(cuda):
    """An env whose position is NaN queries its field at NaN: it ends NaN in
    every state entry, as on the plain chain, the card raises no fault, and
    the other envs' results are those of the same launch without it, bit
    for bit."""
    n, bad = 64, 21
    clean, _, _, _ = _field_case(cuda, n)
    out_k, out_p, _, _ = _field_case(cuda, n, nan_env=bad)
    keep = torch.arange(n, device=cuda) != bad
    for name in ("pos", "quat", "v_base", "q", "qd"):
        k = getattr(out_k, name)
        assert torch.isnan(k[bad]).all() and torch.isnan(getattr(out_p, name)[bad]).all(), name
        assert torch.equal(k[keep], getattr(clean, name)[keep]), name
    assert torch.equal(out_k.t, clean.t)


def test_substep_field_kernel_on_flat_fields_matches_the_flat_kernel(cuda):
    state, tau = _perturbed_states(1024, cuda)
    model = hector_model(device=cuda)
    Minv = mass_matrix_inv(model, state.q)
    flat = sk.fused_substeps(model, state, tau, Minv, 0.005, 5)
    field = sk.fused_substeps(model, state, tau, Minv, 0.005, 5,
                              terrain=Terrain.flat(res=8, n=1024, device=cuda))
    for name, tol in SUBSTEP_BOUNDS.items():
        err = float((getattr(field, name) - getattr(flat, name)).abs().max())
        assert err < tol, (name, err)


def test_art_rollout_launches_substep_kernel(cuda):
    mpc, gait = ra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                        admm_polish=False, kinv_ns_iters=10)
    n, ticks = 64, 3
    worlds = ra.init_art_world(mpc, n, device=cuda)
    bipeds = BipedParams().expand(n).to(cuda)
    before_s, before_q = sk.fused_substeps.launches, tk.fused_qp_solve.launches
    out = ra.batched_art_rollout_kernel(worlds, bipeds, ticks, mpc, gait)
    torch.cuda.synchronize()
    assert sk.fused_substeps.launches == before_s + 8 * ticks
    assert tk.fused_qp_solve.launches == before_q + ticks
    assert torch.isfinite(out.sim.pos).all() and torch.isfinite(out.sim.qd).all()
    assert float(out.metrics.falls.sum()) == 0


def _tick_config(preset):
    """The tick tests' configs: the bench walk, one that sets sin² swing and
    body-frame commands with every gain of the low-level control nonzero,
    and one with both compat swing flags."""
    x_cmd = (0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0)
    if preset == "walk":
        return ra.art_mpc_config(x_cmd=x_cmd)
    if preset == "loaded":
        return ra.art_mpc_config(
            x_cmd=x_cmd, swing_z_sin2=True, swing_track_ff=1.0, swing_retract=0.02,
            raibert_am_y=0.05, raibert_pitch_place=0.2, raibert_pitch_nom=0.15,
            capture_sched=0.5, raibert_vint=0.05, kp_pivot=1.5, kd_pivot=0.2,
            hipyaw_rate_lead=0.1, flight_yaw_kd=2.0, swing_td_overdrive=0.01,
            cmd_body_frame=True,
        )
    return ra.art_mpc_config(x_cmd=x_cmd, compat_swing_frame_bug=True,
                             compat_swing_yaw_bug=True)


def _tick_controls(n, device, seed=1):
    gen = torch.Generator().manual_seed(seed)
    out = (30.0 * torch.randn(n, 12, generator=gen),
           (torch.rand(n, 2, generator=gen) < 0.5).float(),
           0.4 * torch.rand(n, generator=gen), 0.3 * torch.randn(n, generator=gen),
           0.1 * torch.randn(n, 2, generator=gen))
    return [t.to(device) for t in out]


def _tick_case(cuda, preset, state, contact="mixed"):
    model = hector_model(device=cuda)
    mpc, gait = _tick_config(preset), GaitConfig(steps_per_phase=5)
    biped = BipedParams().to(cuda)
    n = state.q.shape[0]
    args = _tick_controls(n, cuda)
    if contact != "mixed":
        args[1] = torch.full_like(args[1], float(contact == "stance"))
    state = dataclasses.replace(state, t=args[2].clone())
    Minv = mass_matrix_inv(model, state.q)
    before = tick.fused_tick.launches
    out_k, e_k = tick.fused_tick(model, biped, mpc, gait, state, *args, Minv)
    torch.cuda.synchronize()
    assert tick.fused_tick.launches == before + 1
    out_p, e_p = tick.fused_tick_reference(model, biped, mpc, gait, state, *args, Minv)
    for name, tol in TICK_BOUNDS.items():
        k, p = getattr(out_k, name), getattr(out_p, name)
        assert k.shape == (n,) + p.shape[1:] and torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err < tol, (name, err)
    assert e_k.shape == (n,) and torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3)
    assert torch.equal(out_k.t, out_p.t)


@pytest.mark.parametrize("n,preset,contact", [
    (1024, "walk", "mixed"), (1000, "loaded", "mixed"), (256, "compat", "mixed"),
    (1024, "loaded", "stance"), (1000, "walk", "swing"), (33, "compat", "stance"),
    (33, "walk", "mixed"), (17, "loaded", "swing"), (17, "walk", "stance"),
    (1, "walk", "mixed"), (1, "compat", "swing"),
])
def test_tick_kernel_matches_plain(cuda, n, preset, contact):
    _tick_case(cuda, preset, _perturbed_states(n, cuda)[0], contact)


@pytest.mark.parametrize("contact", ["mixed", "stance"])
def test_tick_kernel_neighbour_envs(cuda, contact):
    """Deep penetration beside free fall in every lane pair's warp."""
    _tick_case(cuda, "walk", _deep_and_airborne(_perturbed_states(64, cuda)[0]), contact)


def _tick_field_case(cuda, n, bipeds=None):
    """The tick kernel's field variant against its plain version
    (``fused_tick_field_reference``: the terrain periods of ``_art_tick``)
    on the card, one tick of 8 periods x 5 substeps from ``n`` perturbed
    in-contact envs with random clocks and controls, each on its own rough
    field drawn as the terrain cell's (``Terrain.rough_batch``, 0.04 m, 64
    x 64 over 8 m), on the nominal robot per env or on ``bipeds``. Holds the
    state to ``TICK_BOUNDS``, the energy to rtol 2e-3 / atol 1e-3, ``t`` bit
    for bit, the ground count within 1 of the plain chain's in at most 4
    entries, and the launch to one tick launch and no substep launch.
    Returns the kernel's state."""
    model = hector_model(device=cuda)
    mpc, gait = _tick_config("walk"), GaitConfig(steps_per_phase=5)
    bipeds = BipedParams().expand(n).to(cuda) if bipeds is None else bipeds
    state = _perturbed_states(n, cuda)[0]
    u0, c0, t0, cmd_yaw, v_int = _tick_controls(n, cuda)
    state = dataclasses.replace(state, t=t0.clone())
    fields = Terrain.rough_batch(torch.Generator().manual_seed(2), n, amplitude=0.04,
                                 device=cuda)
    Minv = mass_matrix_inv(model, state.q)
    profiling.start_ground_count(cuda)
    out_p, e_p = tick.fused_tick_field_reference(model, bipeds, mpc, gait, state, u0, c0,
                                                 state.t, cmd_yaw, v_int, Minv, fields)
    count_p = _ground_count(cuda)
    profiling.start_ground_count(cuda)
    before = (tick.fused_tick.launches, sk.fused_substeps.launches)
    out_k, e_k = tick.fused_tick(model, BipedParams().to(cuda), mpc, gait, state, u0, c0,
                                 state.t, cmd_yaw, v_int, Minv, terrain=fields, bipeds=bipeds)
    torch.cuda.synchronize()
    assert (tick.fused_tick.launches, sk.fused_substeps.launches) == (before[0] + 1, before[1])
    count_k = _ground_count(cuda)
    for name, tol in TICK_BOUNDS.items():
        k, p = getattr(out_k, name), getattr(out_p, name)
        assert k.shape == p.shape and torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err < tol, (name, err)
    assert e_k.shape == (n,) and torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3)
    assert torch.equal(out_k.t, out_p.t)
    assert count_k.shape == (n, 2, 2) and int(count_p.sum()) > 0
    diff = (count_k - count_p).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 4, int(diff.sum())
    return out_k, (model, mpc, gait, state, u0, c0, cmd_yaw, v_int, Minv, fields)


@pytest.mark.parametrize("n", [4096, 1024, 17])
def test_tick_field_kernel_matches_plain(cuda, n):
    _tick_field_case(cuda, n)


def test_tick_field_kernel_reads_each_envs_leg_geometry(cuda):
    """Even envs on the FK leg geometry, odd envs on the Jacobian one: the
    kernel holds its plain version with the same robots, and each env's
    result is bit for bit that of the launch whose robots all share its
    geometry (an env's lanes read no other env)."""
    from biped_mpc_py_torch.models.biped import HECTOR_LEG_FK, HECTOR_LEG_JAC

    n = 256
    fk = BipedParams(leg_jac=HECTOR_LEG_FK).expand(n).to(cuda)
    jac = BipedParams(leg_jac=HECTOR_LEG_JAC).expand(n).to(cuda)
    odd = torch.arange(n, device=cuda) % 2 == 1
    mixed, (model, mpc, gait, state, u0, c0, cmd_yaw, v_int, Minv, fields) = _tick_field_case(
        cuda, n, fk.where(odd, jac))
    for robots, envs in ((fk, slice(0, None, 2)), (jac, slice(1, None, 2))):
        alone, _ = tick.fused_tick(model, BipedParams().to(cuda), mpc, gait, state, u0, c0,
                                   state.t, cmd_yaw, v_int, Minv, terrain=fields,
                                   bipeds=robots)
        for name in ("pos", "quat", "v_base", "q", "qd", "t"):
            assert torch.equal(getattr(mixed, name)[envs], getattr(alone, name)[envs]), name
    assert float((mixed.q[0::2] - mixed.q[1::2]).abs().max()) > 0


def _sweep_table_values(n, mpc, device):
    """(x_cmd, per_env) of four configs around ``mpc``, env i under config
    i % 4: the command (forward speed and turn rate), the swing, Raibert
    and heading gains and the touchdown overdrive (also the two-lane
    form's, ``tests/test_torch_lane_split.py``)."""
    from biped_mpc_py_torch.parallel.sweep import stack_configs

    configs = [dataclasses.replace(
        mpc, x_cmd=tuple(mpc.x_cmd[:8]) + (0.1 * i, 0.2 + 0.2 * i) + tuple(mpc.x_cmd[10:]),
        kp_swing=500.0 + 100 * i, kd_swing=10.0 - i, swing_height=0.04 + 0.01 * i,
        raibert_capture_gain=0.3 + 0.05 * i, raibert_ff_scale=1.0 - 0.1 * i,
        kp_hipyaw=0.8 * i, kd_hipyaw=0.1 * i, swing_td_overdrive=0.005 * i,
        kv=0.01 + 0.01 * i) for i in range(4)]
    _, per_env = stack_configs([configs[i % 4] for i in range(n)], device=device)
    return per_env.pop("x_cmd"), per_env


@pytest.mark.parametrize("n,preset", [(4096, "walk"), (1024, "loaded"), (17, "compat")])
def test_tick_table_kernel_matches_plain(cuda, n, preset):
    """The tick kernel's per-env variant (``tick_kernel<PlaneTable>``)
    against its plain version (``fused_tick_reference`` with the same
    ``x_cmd`` and ``per_env``: the plain per-env periods), one tick of 8
    periods x 5 substeps from ``n`` perturbed in-contact envs with random
    clocks and controls: the state within ``TICK_BOUNDS``, the energy within
    rtol 2e-3 / atol 1e-3, ``t`` bit for bit, one tick launch and no substep
    launch. The field variant read max |err| q 1.19e-6, qd 3.81e-5 against
    its plain version at 4096 envs (PERF.md §6, the kernel table)."""
    model = hector_model(device=cuda)
    mpc, gait = _tick_config(preset), GaitConfig(steps_per_phase=5)
    biped, bipeds = BipedParams().to(cuda), BipedParams().expand(n).to(cuda)
    state = _perturbed_states(n, cuda)[0]
    u0, c0, t0, cmd_yaw, v_int = _tick_controls(n, cuda)
    state = dataclasses.replace(state, t=t0.clone())
    x_cmd, per_env = _sweep_table_values(n, mpc, cuda)
    Minv = mass_matrix_inv(model, state.q)
    before = (tick.fused_tick.launches, sk.fused_substeps.launches)
    out_k, e_k = tick.fused_tick(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw, v_int,
                                 Minv, x_cmd=x_cmd, per_env=per_env, bipeds=bipeds)
    torch.cuda.synchronize()
    assert (tick.fused_tick.launches, sk.fused_substeps.launches) == (before[0] + 1, before[1])
    out_p, e_p = tick.fused_tick_reference(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw,
                                           v_int, Minv, x_cmd=x_cmd, per_env=per_env,
                                           bipeds=bipeds)
    for name, tol in TICK_BOUNDS.items():
        k, p = getattr(out_k, name), getattr(out_p, name)
        assert k.shape == p.shape and torch.isfinite(k).all(), name
        err = float((k - p).abs().max())
        assert err < tol, (name, err)
    assert e_k.shape == (n,) and torch.allclose(e_k, e_p, rtol=2e-3, atol=1e-3)
    assert torch.equal(out_k.t, out_p.t)
    shared, _ = tick.fused_tick(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw, v_int, Minv)
    assert float((out_k.q - shared.q)[1:4].abs().max()) > 1e-4  # the configs were felt


@pytest.mark.parametrize("preset", ["walk", "loaded", "compat"])
def test_tick_table_kernel_with_the_shared_constants_steps_as_the_flat_kernel(cuda, preset):
    """Every row of the table the shared tick buffer's control block (what
    ``tick_table`` forms with no field differing, bit for bit: ``tests/
    test_torch_sweep_kernel.py``): the per-env variant steps as
    ``tick_kernel<Plane>``, which reads the same constants from the buffer,
    at 1000 envs (a partial last block), within the bounds each holds
    against the plain version, ``t`` bit for bit. Not bit for bit in the
    state: the two instantiations read the constants from two places, and
    nvcc contracts and schedules some of their products into FMAs apart
    (the "walk" preset happened to agree to the bit, "loaded" not)."""
    n = 1000
    model = hector_model(device=cuda)
    mpc, gait = _tick_config(preset), GaitConfig(steps_per_phase=5)
    biped, bipeds = BipedParams().to(cuda), BipedParams().expand(n).to(cuda)
    state = _perturbed_states(n, cuda)[0]
    u0, c0, t0, cmd_yaw, v_int = _tick_controls(n, cuda)
    state = dataclasses.replace(state, t=t0.clone())
    Minv = mass_matrix_inv(model, state.q)
    table = tick.tick_table(bipeds, mpc, gait, None, {})
    x_cmd = torch.tensor(mpc.x_cmd, device=cuda).expand(n, 12)
    out_t, e_t = tick.fused_tick(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw, v_int,
                                 Minv, x_cmd=x_cmd, bipeds=bipeds, table=table)
    out_s, e_s = tick.fused_tick(model, biped, mpc, gait, state, u0, c0, t0, cmd_yaw, v_int,
                                 Minv)
    gaps = {name: float((getattr(out_t, name) - getattr(out_s, name)).abs().max())
            for name in TICK_BOUNDS}
    print(f"[{preset}] per-env variant with the shared constants vs tick_kernel<Plane>: "
          f"max|gap| {gaps}")
    for name, tol in TICK_BOUNDS.items():
        assert torch.isfinite(getattr(out_t, name)).all() and gaps[name] < tol, (name, gaps)
    assert torch.allclose(e_t, e_s, rtol=2e-3, atol=1e-3)
    assert torch.equal(out_t.t, out_s.t)


def test_art_rollout_launches_tick_kernel(cuda):
    mpc, gait = ra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                        admm_polish=False, kinv_ns_iters=10)
    n, ticks = 64, 3
    worlds = ra.init_art_world(mpc, n, device=cuda)
    bipeds = BipedParams().expand(n).to(cuda)
    before = (tick.fused_tick.launches, tk.fused_qp_solve.launches, sk.fused_substeps.launches)
    out = ra.batched_art_rollout_tick_kernel(worlds, bipeds, ticks, mpc, gait)
    torch.cuda.synchronize()
    after = (tick.fused_tick.launches, tk.fused_qp_solve.launches, sk.fused_substeps.launches)
    assert [a - b for a, b in zip(after, before)] == [ticks, ticks, 0]
    assert torch.isfinite(out.sim.pos).all() and torch.isfinite(out.sim.qd).all()
    assert float(out.metrics.falls.sum()) == 0


def _bench_art_config():
    return ra.art_config_for_speed(0.3, n_admm_iters=40, admm_rho_phases=1,
                                   admm_polish=False, kinv_ns_iters=10)


def test_terrain_rollout_card_matches_cpu(cuda):
    mpc, gait = _bench_art_config()
    n, ticks = 64, 2
    terrains = Terrain.rough_batch(torch.Generator().manual_seed(0), n, amplitude=0.03,
                                   res=32, device="cpu")
    bipeds = randomize_params(torch.Generator().manual_seed(1), n, device="cpu")
    worlds = ra.init_art_world(mpc, n, device="cpu")
    kw = dict(n_substeps=5, minv_ll_hold=8)
    out_cpu = ra.batched_art_rollout_terrain(worlds, bipeds, terrains, ticks, mpc, gait, **kw)
    before = (tk.fused_qp_solve.launches, tick.fused_tick.launches, sk.fused_substeps.launches)
    out = ra.batched_art_rollout_terrain(worlds.to(cuda), bipeds.to(cuda), terrains.to(cuda),
                                         ticks, mpc, gait, **kw)
    torch.cuda.synchronize()
    after = (tk.fused_qp_solve.launches, tick.fused_tick.launches, sk.fused_substeps.launches)
    assert [a - b for a, b in zip(after, before)] == [ticks, ticks, 0]
    assert out.sim.pos.device.type == "cuda"
    for name, tol in (("pos", 1e-3), ("q", 1e-2), ("qd", 1.0)):
        err = float((getattr(out.sim, name).cpu() - getattr(out_cpu.sim, name)).abs().max())
        assert err < tol, (name, err)
    assert torch.equal(out.sim.t.cpu(), out_cpu.sim.t)
    assert torch.equal(out.metrics.falls.cpu(), out_cpu.metrics.falls)
    flat = ra.batched_art_rollout(worlds.to(cuda), bipeds.to(cuda), ticks, mpc, gait, **kw)
    assert float((out.sim.q - flat.sim.q).abs().max()) > 1e-4  # the fields were felt


def test_terrain_constructors_build_on_the_card(cuda):
    rough = Terrain.rough_batch(torch.Generator(device=cuda).manual_seed(0), 8, res=16)
    again = Terrain.rough_batch(torch.Generator(device=cuda).manual_seed(0), 8, res=16)
    assert rough.heights.device.type == "cuda" and rough.heights.shape == (8, 16, 16)
    assert torch.equal(rough.heights, again.heights)
    assert Terrain.flat(n=4).heights.device.type == "cuda"
    # an edge query on the card stays in range (no device-side assert)
    x = torch.tensor([4.0, -4.0, 100.0, -100.0, 0.0, 3.999, 1.0, 2.0], device=cuda)
    h = rough.height(x, x.flip(0))
    torch.cuda.synchronize()
    assert torch.isfinite(h).all() and torch.isfinite(rough.normal(x, x)).all()


def test_physics_wrappers_raise_on_terrain(cuda):
    """The substep wrapper refuses a shared field, and a per-env ``dt`` on a
    field per env; the tick kernel a shared field and a field per env
    without its robots; neither launches."""
    mpc, gait = _bench_art_config()
    n = 16
    model, biped = hector_model(device=cuda), BipedParams().to(cuda)
    state = ArtState.standing(n, device=cuda)
    Minv = mass_matrix_inv(model, state.q)
    flat = Terrain.flat(n=n)
    tau = torch.zeros(n, 10, device=cuda)
    before = (tick.fused_tick.launches, sk.fused_substeps.launches)
    with pytest.raises(ValueError, match="shared field"):
        sk.fused_substeps(model, state, tau, Minv, 0.005, 5, terrain=Terrain.flat())
    with pytest.raises(ValueError, match="one dt"):
        sk.fused_substeps(model, state, tau, Minv, torch.full((n,), 0.005, device=cuda), 5,
                          terrain=flat)
    args = (model, biped, mpc, gait, state, torch.zeros(n, 12, device=cuda),
            torch.ones(n, 2, device=cuda), state.t, torch.zeros(n, device=cuda),
            torch.zeros(n, 2, device=cuda), Minv)
    with pytest.raises(ValueError, match="shared field"):
        tick.fused_tick(*args, terrain=Terrain.flat(), bipeds=BipedParams().expand(n).to(cuda))
    with pytest.raises(ValueError, match="bipeds"):
        tick.fused_tick(*args, terrain=flat)
    assert (tick.fused_tick.launches, sk.fused_substeps.launches) == before


CHAIN_BOUNDS = {"pos": 1e-4, "quat": 1e-4, "v_base": 2e-3, "q": 1e-3, "qd": 2e-2}


def _counts():
    return (tk.fused_qp_solve.launches, tick.fused_tick.launches, sk.fused_substeps.launches)


def test_sweep_card_matches_cpu(cuda):
    """A gain sweep with one dt at the tick path's hold: on the card the
    tick path with the kernel's per-env variant (one QP and one tick launch
    a tick), held to the same path's plain version on the CPU
    (``batched_art_rollout_tick_kernel(per_env=)``; on the CPU ``art_sweep``
    runs the plain chain), as ``test_art_rollout_launches_tick_kernel``
    holds the flat tick path, ``t`` bit for bit."""
    from biped_mpc_py_torch.parallel.sweep import art_sweep, perturbed_worlds, stack_configs

    mpc, gait = _bench_art_config()
    configs = [dataclasses.replace(mpc, kp_hipyaw=k, kd_hipyaw=d)
               for k, d in ((2.4, 0.3), (0.0, 0.0), (3.6, 0.45), (1.2, 0.15))]
    mpc_s, per_env = stack_configs([c for c in configs for _ in range(2)], device="cpu")
    worlds = perturbed_worlds(mpc, 2, torch.Generator().manual_seed(0), device="cpu")
    worlds = worlds.map(lambda t: t.repeat((4,) + (1,) * (t.dim() - 1)))
    bipeds = BipedParams().expand(8)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    out_cpu = ra.batched_art_rollout_tick_kernel(worlds, bipeds, 2, mpc_s, gait, n_substeps=5,
                                                 per_env=per_env)
    before = _counts()
    out = art_sweep(worlds.to(cuda), bipeds.to(cuda), 2, mpc_s, gait,
                    {k: v.to(cuda) for k, v in per_env.items()}, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [2, 2, 0]
    for name, tol in CHAIN_BOUNDS.items():
        err = float((getattr(out.sim, name).cpu() - getattr(out_cpu.sim, name)).abs().max())
        assert err < tol, (name, err)
    assert torch.equal(out.sim.t.cpu(), out_cpu.sim.t)
    assert float((out.sim.q[0] - out.sim.q[2]).abs().max()) > 1e-5  # the gains were felt


def test_sweep_numerics_card_matches_cpu(cuda):
    """Per-env dt, weights, Raibert gains and ADMM numerics."""
    from biped_mpc_py_torch.parallel.sweep import art_sweep, perturbed_worlds, stack_configs

    mpc, gait = _bench_art_config()
    configs = [dataclasses.replace(mpc, dt=dt, admm_rho=rho, raibert_pitch_place=pp,
                                   raibert_pitch_nom=0.12, cmd_leak_yaw=leak,
                                   Q=tuple(w * q for q in mpc.Q))
               for dt, rho, pp, leak, w in ((0.04, 0.3, 0.0, 0.05, 1.0),
                                            (0.035, 0.1, 0.1, 0.08, 1.5),
                                            (0.045, 1.0, 0.2, 0.03, 0.7),
                                            (0.03, 3.0, 0.25, 0.05, 1.2))]
    mpc_s, per_env = stack_configs([c for c in configs for _ in range(2)], device="cpu")
    worlds = perturbed_worlds(mpc, 2, torch.Generator().manual_seed(0), device="cpu")
    worlds = worlds.map(lambda t: t.repeat((4,) + (1,) * (t.dim() - 1)))
    bipeds = BipedParams().expand(8)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    out_cpu = art_sweep(worlds, bipeds, 2, mpc_s, gait, per_env, **kw)
    before = _counts()
    out = art_sweep(worlds.to(cuda), bipeds.to(cuda), 2, mpc_s, gait,
                    {k: v.to(cuda) for k, v in per_env.items()}, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [2, 0, 0]
    for name, tol in CHAIN_BOUNDS.items():
        err = float((getattr(out.sim, name).cpu() - getattr(out_cpu.sim, name)).abs().max())
        assert err < tol, (name, err)
    assert torch.equal(out.sim.t.cpu(), out_cpu.sim.t)


def test_fused_tick_raises_on_per_env_values(cuda):
    """Per-env gains and commands go to the tick kernel's per-env variant
    (which takes each env's robot); a per-env dt, or per-env values on a
    field, are refused before a launch, and so is a per-env dt for the
    substep kernel."""
    mpc, gait = _bench_art_config()
    n = 16
    model, biped = hector_model(device=cuda), BipedParams().to(cuda)
    state = ArtState.standing(n, device=cuda)
    Minv = mass_matrix_inv(model, state.q)
    args = (model, biped, mpc, gait, state, torch.zeros(n, 12, device=cuda),
            torch.ones(n, 2, device=cuda), state.t, torch.zeros(n, device=cuda),
            torch.zeros(n, 2, device=cuda), Minv)
    bipeds = BipedParams().expand(n).to(cuda)
    fields = Terrain(heights=torch.zeros(n, 4, 4, device=cuda))
    before = _counts()
    with pytest.raises(ValueError, match="on a Terrain run the plain chain"):
        tick.fused_tick(*args, per_env={"kp_hipyaw": torch.zeros(n, device=cuda)},
                        terrain=fields, bipeds=bipeds)
    with pytest.raises(ValueError, match="on a Terrain run the plain chain"):
        tick.fused_tick(*args, x_cmd=torch.zeros(n, 12, device=cuda), terrain=fields,
                        bipeds=bipeds)
    with pytest.raises(ValueError, match="per-env dt runs the plain chain"):
        tick.fused_tick(*args, per_env={"dt": torch.full((n,), 0.035, device=cuda)},
                        bipeds=bipeds)
    with pytest.raises(ValueError, match="one dt"):
        sk.fused_substeps(model, state, torch.zeros(n, 10, device=cuda), Minv,
                          torch.full((n,), 0.005, device=cuda), 5)
    assert _counts() == before


def _bench_oracle():
    return ra.art_mpc_config(kp_hipyaw=3.0, kd_hipyaw=0.4, tau_z_max=4.0, swing_td_damp=8.0,
                             swing_z_sin2=True, n_admm_iters=40, admm_rho_phases=1,
                             admm_polish=False, kinv_ns_iters=10)


def _assert_feedback_close(x_c, x_h):
    d = (torch.as_tensor(x_c) - torch.as_tensor(x_h)).abs()
    assert float(d[..., 0:6].max()) < 1e-4 and float(d[..., 6:12].max()) < 2e-3, d


def test_realtime_loop_card_matches_cpu(cuda):
    """Both controllers against the port's engine on the CPU as the plant
    (chip_smoke.EnginePlant), 5 ticks."""
    from torch_plants import EnginePlant
    from biped_mpc_py_torch.runtime.realtime import RealtimeLoop

    plants, launched = [], []
    for device in (cuda, torch.device("cpu")):
        plant = EnginePlant(torch, torch.device("cpu"))
        loop = RealtimeLoop(_bench_oracle(), GaitConfig(), BipedParams(), device=device)
        loop.warmup(plant)  # captures the graphs (their warm-up launches the QP kernel)
        before = _counts()
        loop.run(plant, 5, realtime=False)
        launched.append([a - b for a, b in zip(_counts(), before)])
        plants.append(plant)
    assert launched == [[5, 0, 0], [0, 0, 0]]
    _assert_feedback_close(plants[0].read_state()[0], plants[1].read_state()[0])


def test_mujoco_loop_card_matches_cpu(cuda):
    pytest.importorskip("mujoco")
    from biped_mpc_py_torch.sim.mj_driver import run_mujoco_closed_loop

    before = _counts()
    f_c, x_c, fell_c = run_mujoco_closed_loop(_bench_oracle(), GaitConfig(), 5, device=cuda)
    # 5 replays of the solve graph, and its capture's warm-up solve
    assert [a - b for a, b in zip(_counts(), before)] == [6, 0, 0]
    f_h, x_h, fell_h = run_mujoco_closed_loop(_bench_oracle(), GaitConfig(), 5, device="cpu")
    assert fell_c == fell_h
    _assert_feedback_close(x_c, x_h)
    assert abs(f_c - f_h).max() < 1.0


def test_new_entry_points_build_on_the_card(cuda):
    from biped_mpc_py_torch.parallel.sweep import perturbed_worlds, stack_configs
    from biped_mpc_py_torch.runtime.realtime import RealtimeLoop
    from biped_mpc_py_torch.sim.replay import rollout_qpos_track

    mpc, gait = _bench_art_config()
    _, per_env = stack_configs([mpc, dataclasses.replace(mpc, kd_hipyaw=0.0)])
    assert per_env["kd_hipyaw"].device.type == "cuda"
    w = perturbed_worlds(mpc, 4, torch.Generator(device=cuda).manual_seed(0))
    assert w.sim.q.device.type == "cuda" and w.ctrl.qp.z.device.type == "cuda"
    loop = RealtimeLoop(mpc, gait, BipedParams())
    assert loop.ctrl.qp.controls.device.type == "cuda"
    before = _counts()
    qpos, times, falls = rollout_qpos_track(mpc, gait, 2, n_substeps=5, minv_ll_hold=8)
    # 2 replays of the plain chain's graph, and the capture's warm-up tick
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]
    assert qpos.shape == (2, 17) and falls == 0.0 and 0.45 < qpos[:, 2].min()


SHARD_ENVS, SHARD_TICKS = 1024, 50
WALK = (0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0)


def _shard_setup(mesh):
    """The smoke's SRB walk at the bench budget, the bf16 knobs off: 1024
    randomized robots (seed 0) from standing, sharded over ``mesh``. The
    two ranks' rows are held against one rank's pointwise, which the bf16
    K^-1 product's rounding flips would not leave (chip_smoke.py::
    phase_kernel)."""
    from biped_mpc_py_torch.parallel import sharding

    mpc = _bench(x_cmd=WALK)
    bipeds = randomize_params(torch.Generator().manual_seed(0), SHARD_ENVS, device="cuda")
    return (mpc, bipeds, sharding.make_sharded_batch(mpc, SHARD_ENVS, mesh),
            sharding.shard_world(bipeds, mesh))


def _two_ranks_on_card(mesh, dcp_dir):
    """One of two ranks sharing the card: its half of the worlds for 50
    ticks, its shards saved at tick 25 (and the world gathered whole into
    an npz file beside them)."""
    from biped_mpc_py_torch.parallel import sharding
    from biped_mpc_py_torch.utils.checkpoint import save_pytree, save_pytree_dcp

    mpc, _, ws, bs = _shard_setup(mesh)
    mid, _ = sharding.sharded_rollout(ws, bs, SHARD_TICKS // 2, mpc, GaitConfig(), mesh)
    save_pytree_dcp(dcp_dir, mid)
    save_pytree(dcp_dir + ".npz", mid)
    out, summary = sharding.sharded_rollout(mid, bs, SHARD_TICKS - SHARD_TICKS // 2, mpc,
                                            GaitConfig(), mesh)
    return dict(mid=mid, x_fb=out.sim.x_fb, summary=summary)


@pytest.fixture(scope="module")
def two_ranks_on_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (torch.cuda.is_available() is false)")
    from biped_mpc_py_torch.parallel import sharding

    dcp_dir = str(tmp_path_factory.mktemp("two_ranks") / "dcp")
    return dcp_dir, sharding.spawn_env_group(2, _two_ranks_on_card, dcp_dir, device="cuda",
                                             timeout=600)


@pytest.fixture
def one_nccl_rank(cuda, tmp_path):
    from biped_mpc_py_torch.parallel import sharding

    with sharding.env_group(str(tmp_path / "store"), "nccl"):
        yield sharding.env_mesh("cuda")


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        elif dataclasses.is_dataclass(x):
            _same(x, y)


def test_sharded_rollout_one_nccl_rank_is_the_unsharded_loop(one_nccl_rank):
    """One rank over NCCL runs ``batched_rollout`` on all 1024 rows: every
    leaf bit-equal, one QP launch a tick, the summary the local sums."""
    from biped_mpc_py_torch.parallel import sharding

    mpc, bipeds, ws, bs = _shard_setup(one_nccl_rank)
    before = tk.fused_qp_solve.launches
    out, summary = sharding.sharded_rollout(ws, bs, SHARD_TICKS, mpc, GaitConfig(),
                                            one_nccl_rank)
    assert tk.fused_qp_solve.launches == before + SHARD_TICKS
    whole = batched_rollout(batch_worlds(mpc, SHARD_ENVS, device="cuda"), bipeds, SHARD_TICKS,
                            mpc, GaitConfig())
    _same(out.map(lambda t: t.to_local()), whole)
    assert float(summary["n_steps"]) == SHARD_TICKS * SHARD_ENVS
    assert float(summary["falls"]) == 0
    assert summary["n_steps"].device.type == "cuda"


def test_sharded_rollout_two_ranks_on_one_card(cuda, two_ranks_on_card):
    """Two gloo ranks of 512 rows on the card against the unsharded loop of
    1024: x_fb within 1.5e-3 (tests/test_rollout.py:273-281), the
    all-reduced summary equal (height rtol 1e-5)."""
    _, ranks = two_ranks_on_card
    mpc = _bench(x_cmd=WALK)
    bipeds = randomize_params(torch.Generator().manual_seed(0), SHARD_ENVS, device=cuda)
    whole = batched_rollout(batch_worlds(mpc, SHARD_ENVS, device=cuda), bipeds, SHARD_TICKS,
                            mpc, GaitConfig())
    x = torch.cat([r["x_fb"] for r in ranks]).to(cuda)
    assert float((x - whole.sim.x_fb).abs().max()) <= 1.5e-3
    s = [{k: float(v) for k, v in r["summary"].items()} for r in ranks]
    m = whole.metrics
    assert s[0] == s[1]
    assert s[0]["n_steps"] == float(m.n_steps.sum()) and s[0]["falls"] == float(m.falls.sum())
    assert abs(s[0]["height_rmse_sum"] - float(m.height_err_sq.sum())) <= 1e-5 * s[0][
        "height_rmse_sum"]


def test_dcp_two_ranks_reshard_into_one_on_card(two_ranks_on_card, one_nccl_rank):
    """The two ranks' tick-25 shards loaded into a one-rank NCCL mesh:
    bit-equal to their rows, as is the world they gathered into npz."""
    from biped_mpc_py_torch.parallel import sharding
    from biped_mpc_py_torch.utils.checkpoint import load_pytree, load_pytree_dcp

    dcp_dir, ranks = two_ranks_on_card
    mpc = _bench(x_cmd=WALK)
    like = sharding.make_sharded_batch(mpc, SHARD_ENVS, one_nccl_rank)
    loaded = load_pytree_dcp(dcp_dir, like).map(lambda t: t.to_local())
    rows = _cat_rows([r["mid"] for r in ranks])
    _same(loaded, rows)
    _same(load_pytree(dcp_dir + ".npz", batch_worlds(mpc, SHARD_ENVS, device="cuda")), rows)


def _cat_rows(structs):
    """The ranks' rows, in rank order, as one nest on the card."""
    changes = {}
    for f in dataclasses.fields(structs[0]):
        parts = [getattr(x, f.name) for x in structs]
        if isinstance(parts[0], torch.Tensor):
            changes[f.name] = torch.cat(parts).cuda()
        elif dataclasses.is_dataclass(parts[0]):
            changes[f.name] = _cat_rows(parts)
    return dataclasses.replace(structs[0], **changes)


# --- the compiled entry points: one tick captured as a CUDA graph -----------

GRAPH_TICKS = {"srb": 10, "tick": 10, "substep": 5, "plain": 3, "terrain": 3, "sweep": 3}


def _graph_case(path, device):
    """(eager(k), factory(k), the fn's inputs, launches per tick as
    ``_counts()``) at 1024 envs, the bench budget (chip_smoke phase 22)."""
    if path == "srb":
        mpc = fast_mpc_config(x_cmd=WALK)
        w = batch_worlds(mpc, 1024, device=device)
        b = randomize_params(torch.Generator().manual_seed(0), 1024, device=device)
        return (lambda k: batched_rollout(w, b, k, mpc, GaitConfig()),
                lambda k: batched_rollout_fn(k, mpc, GaitConfig()), (w, b), (1, 0, 0))
    mpc, gait = _bench_art_config()
    w = ra.init_art_world(mpc, 1024, device=device)
    gen = torch.Generator().manual_seed(0)
    qd = w.sim.qd + (0.01 * torch.randn(1024, 10, generator=gen)).to(device)
    w = dataclasses.replace(w, sim=dataclasses.replace(w.sim, qd=qd))
    b = BipedParams().expand(1024).to(device)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    if path == "tick":
        return (lambda k: ra.batched_art_rollout_tick_kernel(w, b, k, mpc, gait),
                lambda k: ra.batched_art_rollout_tick_kernel_fn(k, mpc, gait), (w, b),
                (1, 1, 0))
    if path == "substep":
        return (lambda k: ra.batched_art_rollout_kernel(w, b, k, mpc, gait),
                lambda k: ra.batched_art_rollout_kernel_fn(k, mpc, gait), (w, b), (1, 0, 8))
    if path == "plain":
        return (lambda k: ra.batched_art_rollout(w, b, k, mpc, gait, **kw),
                lambda k: ra.batched_art_rollout_fn(k, mpc, gait, **kw), (w, b), (1, 0, 0))
    if path == "terrain":
        fields = Terrain.rough_batch(torch.Generator().manual_seed(1), 1024, amplitude=0.03,
                                     device=device)
        return (lambda k: ra.batched_art_rollout_terrain(w, b, fields, k, mpc, gait, **kw),
                lambda k: ra.batched_art_rollout_terrain_fn(k, mpc, gait, **kw),
                (w, b, fields), (1, 1, 0))
    from biped_mpc_py_torch.parallel.sweep import art_sweep, art_sweep_fn, stack_configs

    configs = [dataclasses.replace(mpc, kp_hipyaw=2.4 * g, kd_hipyaw=0.3 * h, admm_rho=r)
               for g, r in ((0.0, 0.3), (0.5, 1.0), (1.0, 0.1), (1.5, 0.3))
               for h in (0.0, 0.5, 1.0, 1.5)]
    mpc_s, per_env = stack_configs([c for c in configs for _ in range(64)], device=device)
    # one dt and the tick path's hold: the tick kernel's per-env variant
    return (lambda k: art_sweep(w, b, k, mpc_s, gait, per_env, **kw),
            lambda k: art_sweep_fn(k, mpc_s, gait, **kw), (w, b, per_env), (1, 1, 0))


@pytest.mark.parametrize("path", list(GRAPH_TICKS))
def test_graph_replay_is_bit_equal_to_eager(cuda, path):
    """1024 envs: a replayed ``*_fn`` gives every leaf of the eager loop bit
    for bit, and its call counts the launches its replays made (the Ruiz
    kernel's too: one a tick)."""
    from biped_mpc_py_torch.utils.graphs import leaves

    k = GRAPH_TICKS[path]
    eager, factory, inputs, per_tick = _graph_case(path, cuda)
    want = eager(k)
    fn = factory(k)
    fn(*inputs)  # captures
    (graph,) = fn.graphs.values()
    assert graph.graph is not None
    before, ruiz = _counts(), rk.fused_ruiz.launches
    out = fn(*inputs)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_counts(), before)] == [k * p for p in per_tick]
    assert rk.fused_ruiz.launches - ruiz == k  # one Ruiz launch a tick, on every path
    assert all(torch.equal(x, y) for x, y in zip(leaves(out), leaves(want), strict=True))


def test_sharded_fns_one_nccl_rank_are_the_eager_loops(one_nccl_rank):
    """One NCCL rank: ``sharded_rollout_fn`` and ``sharded_art_rollout_fn``
    replay one graph over the rank's rows, bit-equal to the eager sharded
    loops, one QP launch a tick, the same summary."""
    from biped_mpc_py_torch.parallel import sharding

    mpc, _, ws, bs = _shard_setup(one_nccl_rank)
    eager, s_eager = sharding.sharded_rollout(ws, bs, 5, mpc, GaitConfig(), one_nccl_rank)
    fn = sharding.sharded_rollout_fn(5, mpc, GaitConfig(), one_nccl_rank)
    fn(ws, bs)  # captures
    before = _counts()
    out, summary = fn(ws, bs)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_counts(), before)] == [5, 0, 0]
    _same(out.map(lambda t: t.to_local()), eager.map(lambda t: t.to_local()))
    assert {k: float(v) for k, v in summary.items()} == {k: float(v) for k, v in s_eager.items()}
    amp, gait = _bench_art_config()
    aw = sharding.shard_world(ra.init_art_world(amp, 256), one_nccl_rank)
    ab = sharding.shard_world(BipedParams().expand(256).to("cuda"), one_nccl_rank)
    kw = dict(n_substeps=5, minv_ll_hold=8)
    a_eager, _ = sharding.sharded_art_rollout(aw, ab, 2, amp, gait, one_nccl_rank, **kw)
    a_out, a_summary = sharding.sharded_art_rollout_fn(2, amp, gait, one_nccl_rank, **kw)(aw, ab)
    _same(a_out.map(lambda t: t.to_local()), a_eager.map(lambda t: t.to_local()))
    assert sorted(a_summary) == ["falls", "height_rmse_sum", "n_steps"]


def test_n1_graphs_on_the_card(cuda):
    """The N = 1 graphs on the card: ``MjController`` walks
    ``chip_smoke.EnginePlant`` for 25 ticks (one QP launch a tick), replay's
    frames equal the eager loop's, and the demo's tick equals
    ``control_tick``."""
    from torch_plants import EnginePlant
    from biped_mpc_py_torch.control.controller import control_tick
    from biped_mpc_py_torch.demo import compiled_tick
    from biped_mpc_py_torch.sim.mj_driver import MjController
    from biped_mpc_py_torch.sim.replay import rollout_qpos_track

    plant = EnginePlant(torch, cuda)
    ctl = MjController(ra.art_mpc_config(), GaitConfig())
    ctl.warmup(plant.qpos_qvel)  # the capture's warm-up launches once
    before = _counts()
    for k in range(25):
        ctl.tick(plant.qpos_qvel, lambda tau: plant.apply(tau, 0.005), k * 0.04)
    assert [a - c for a, c in zip(_counts(), before)] == [25, 0, 200]
    assert all(g.graph is not None for g in ctl.graphs) and plant.z() > 0.4

    mpc, gait = _bench_art_config()
    kw = dict(n_substeps=5, minv_ll_hold=8)
    qpos, times, _ = rollout_qpos_track(mpc, gait, 3, **kw)
    w = ra.init_art_world(mpc, 1)
    model, biped = hector_model(device=cuda), BipedParams().to(cuda)
    for k in range(3):
        w = ra.art_closed_loop_tick(w, mpc, gait, biped, model, **kw)
        frame = torch.cat([w.sim.pos, w.sim.quat, w.sim.q], -1)[0].cpu().numpy()
        assert (frame == qpos[k]).all() and float(w.sim.t[0]) == times[k]

    x = torch.tensor([[0, 0, 0, 0, 0, 0.53, 0, 0, 0, 0, 0, 0]], device=cuda)
    q = torch.tensor([[0, 0, -0.7853982, 1.5707964, -0.7853982] * 2], device=cuda)
    qd, t = torch.zeros(1, 10, device=cuda), torch.zeros(1, device=cuda)
    tau, _, sol = control_tick(x, q, qd, t, MpcConfig(), GaitConfig(), biped)
    tick_graph = compiled_tick(x, q, qd, t, MpcConfig(), GaitConfig(), biped)
    tick_graph.replay()
    assert tick_graph.graph is not None
    assert torch.equal(tick_graph.carry[4], tau) and torch.equal(tick_graph.carry[6], sol.controls)


def test_realtime_loop_on_graphs_walks_engine_plant(cuda):
    """``RealtimeLoop`` replays its solve and low-level graphs at N = 1
    against ``chip_smoke.EnginePlant`` on the card for 50 ticks: the robot
    stays up, one QP launch a tick (the plant's own 8 substep launches a
    tick beside it)."""
    from torch_plants import EnginePlant
    from biped_mpc_py_torch.runtime.realtime import RealtimeLoop

    plant = EnginePlant(torch, cuda)
    loop = RealtimeLoop(ra.art_mpc_config(), GaitConfig(), BipedParams())
    loop.warmup(plant)
    assert all(g.graph is not None for g in loop._graphs)
    before = _counts()
    stats = loop.run(plant, 50, realtime=False)
    assert [a - c for a, c in zip(_counts(), before)] == [50, 0, 400]
    assert stats.n_ticks == 50 and plant.z() > 0.4


def test_no_garbage_collection_inside_a_capture(cuda):
    """The warm-up runs with the cyclic collector on, the capture with it
    off (a collection there may free a graph of a dropped cycle, which
    invalidates the capture), and it is on again after."""
    from biped_mpc_py_torch.utils.graphs import graphed

    seen = []

    def step(c):
        seen.append(gc.isenabled())
        return c + 1

    graphed(step, 1)(torch.zeros(4, device=cuda))
    assert seen == [True, False] and gc.isenabled()


def test_capture_raises_on_a_host_sync(cuda):
    """A step that synchronizes (``.item()``) raises at capture; nothing
    runs it eagerly instead, and the input is left as it was. (Last in the
    file: a failed capture must leave the card usable, which the check
    after it shows.)"""
    from biped_mpc_py_torch.utils.graphs import graphed

    calls = []

    def step(c):
        calls.append(1)
        return c * c.sum().item()

    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        graphed(step, 3)(x)
    assert len(calls) == 2  # the warm-up on a scratch copy, then the capture
    assert torch.equal(x, torch.ones(4, device=cuda))
    assert float((x + 1).sum()) == 8.0


@pytest.mark.parametrize("env, per_tick", [
    ({}, {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 0, "fused_ruiz": 1}),
    ({"BENCH_MODE": "art"},
     {"fused_qp_solve": 1, "fused_tick": 1, "fused_substeps": 0, "fused_ruiz": 1}),
    ({"BENCH_MODE": "art", "BENCH_ART_BACKEND": "kernel"},
     {"fused_qp_solve": 1, "fused_tick": 0, "fused_substeps": 8, "fused_ruiz": 1}),
], ids=["srb", "tick", "kernel"])
def test_bench_runs_on_the_card(cuda, env, per_tick):
    """``biped_mpc_py_torch.bench`` on the card by default: the card's name,
    the path's launches a tick in the timed call, finite states, and a
    repeated run that holds under 1 MiB more afterwards (the kernels'
    constant buffers of its config objects), where a new warm-up stream
    per capture held a 32 MiB cuBLAS workspace each."""
    from biped_mpc_py_torch import bench

    env = env | {"BENCH_ENVS": "64", "BENCH_STEPS": "3"}
    result = bench.run(env)
    assert result["device"] == torch.cuda.get_device_name(0)
    assert result["launches"] == {k: 3 * v for k, v in per_tick.items()}
    assert result["checks"]["finite"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    bench.run(env)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < 2**20

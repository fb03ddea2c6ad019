"""The kernels' bounds (``utils/roofline.py``) and the build's kept
``-Xptxas -v`` report (``ops/cuda/build.py::ptxas_report``), on the CPU.

The QP solve's work is counted from its shapes and budget; the numbers here
are the hand count for 1024 envs of 10 steps of 12 controls and 24 rows at
the bench budget (1 phase of 40 ADMM steps, 10 NS steps, no polish). The
physics kernels' derived counts are held against the operations their
plain PyTorch versions do (:func:`count_ops`), which repeat the same
arithmetic one op at a time and so do at least as much.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from biped_mpc_py_torch import BipedParams
from biped_mpc_py_torch.ops.cuda import build
from biped_mpc_py_torch.utils import roofline
from torch_threads import one_torch_thread  # noqa: F401

BENCH = dict(n_iters=40, n_phases=1, ns_iters=10, polish=False)
DEFAULT = dict(n_iters=60, n_phases=3, ns_iters=14, polish=True)

_FREE = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "permute", "t", "transpose", "squeeze",
    "unsqueeze", "select", "slice", "as_strided", "diagonal", "unbind", "split",
    "split_with_sizes", "narrow", "alias", "detach", "clone", "copy_", "_to_copy",
    "contiguous", "lift_fresh", "lift_fresh_copy", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill_", "fill", "zero_",
    "scalar_tensor", "arange", "eye", "cat", "stack", "index", "index_select", "gather",
    "repeat", "_local_scalar_dense", "expand_copy", "slice_scatter", "select_scatter",
    "index_put_", "index_put", "set_", "resize_",
))
_MATMUL = frozenset(("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"))
_REDUCE = frozenset(("sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
                     "linalg_vector_norm", "any", "all", "argmax", "argmin", "cumsum"))


class _OpCounter(TorchDispatchMode):
    """One operation per output element of an elementwise op, per input
    element of a reduction, 2mnk for a matrix product, nothing for views,
    copies, indexing and tensor creation."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _MATMUL:
            a, b = [x for x in args if isinstance(x, torch.Tensor)][-2:]
            if name in ("mv", "addmv", "dot"):
                self.ops += 2 * a.numel()
            else:
                k = a.shape[-1]
                self.ops += 2 * (a.numel() // k) * b.shape[-1] * k
        elif name in _REDUCE:
            self.ops += max((x.numel() for x in args if isinstance(x, torch.Tensor)), default=0)
        elif name not in _FREE:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.ops += max((o.numel() for o in outs if isinstance(o, torch.Tensor)), default=0)
        return out


def count_ops(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the operations its PyTorch ops did)."""
    with _OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.ops


def test_qp_solve_work_bench():
    w = roofline.qp_solve_work(1024, 10, 24, **BENCH, rho=0.1)
    n, m = 120, 240
    assert w["ns_flops"] == 1024 * 9 * 2 * 2 * n ** 3  # the first NS step is elementwise
    assert w["bytes"] == 4 * 1024 * (n * n + 12 * m + 3 * n + 6 * m)
    admm = 40 * (2 * n * n + 48 * m + 12 * m + 5 * n)
    inverse = (12 * m + 288 * m + 144 * 10 + n) + (3 * n * n + 2 * n) + (n * n + n) + 2 * n * n
    assert w["flops"] == 1024 * (9 * 2 * 2 * n ** 3 + inverse + admm)
    ms, by = roofline.bound_ms(w["flops"], w["bytes"])
    assert by == "operations" and ms == pytest.approx(0.97999, abs=1e-5)
    assert roofline.qp_solve_bound_ms(w) == (pytest.approx(0.41530, abs=1e-5), "operations")


def test_qp_solve_work_default_budget_counts_every_inverse():
    w = roofline.qp_solve_work(1024, 10, 24, **DEFAULT)
    assert w["ns_flops"] == 1024 * 4 * 13 * 2 * 2 * 120 ** 3  # 3 phases + polish
    assert roofline.bound_ms(w["flops"], w["bytes"])[0] == pytest.approx(5.5476, abs=1e-4)
    assert roofline.qp_solve_bound_ms(w)[0] == pytest.approx(2.2849, abs=1e-4)


def test_qp_solve_work_without_newton_schulz():
    w = roofline.qp_solve_work(1, 10, 24, **{**BENCH, "ns_iters": 0})
    assert w["ns_flops"] == 0
    assert roofline.qp_solve_work(1, 10, 24, **{**BENCH, "ns_iters": 1})["ns_flops"] == 0


def test_bound_is_the_larger_time():
    assert roofline.bound_ms(67e9, 1.0) == (pytest.approx(1.0), "operations")
    assert roofline.bound_ms(1.0, 3.35e9) == (pytest.approx(1.0), "bytes")


def test_count_ops():
    a, b = torch.randn(4, 5, 6), torch.randn(4, 6, 7)
    v = torch.randn(5)
    _, ops = count_ops(lambda: torch.bmm(a, b))
    assert ops == 2 * 4 * 5 * 7 * 6
    _, ops = count_ops(lambda: torch.einsum("nij,njk->nik", a, b))
    assert ops == 2 * 4 * 5 * 7 * 6
    _, ops = count_ops(lambda: (torch.sin(v) + 1.0).sum())
    assert ops == 5 + 5 + 5  # sin, add, sum over 5 inputs
    _, ops = count_ops(lambda: a.reshape(20, 6).t().contiguous()[1:3].clone())
    assert ops == 0  # views, copies and indexing move data only


def _art_inputs(n):
    from biped_mpc_py_torch.sim.engine import ArtState, mass_matrix_inv
    from biped_mpc_py_torch.sim.model import hector_model

    gen = torch.Generator().manual_seed(0)
    model = hector_model(device="cpu")
    s = ArtState.standing(n, device="cpu")
    state = type(s)(pos=s.pos + 0.02 * torch.randn(n, 3, generator=gen) - torch.tensor([0, 0, 0.03]),
                    quat=s.quat, v_base=0.3 * torch.randn(n, 6, generator=gen),
                    q=s.q + 0.05 * torch.randn(n, 10, generator=gen),
                    qd=0.5 * torch.randn(n, 10, generator=gen), t=s.t)
    tau = 5.0 * torch.randn(n, 10, generator=gen)
    return model, state, tau, mass_matrix_inv(model, state.q), gen


# The plain versions count 1.70x the derived operations: they also do both
# sides of every select, whole-tensor masks and dense 3 x 3 rotations where
# the kernel rotates about one axis.
@pytest.mark.parametrize("kernel", ["substeps", "tick"])
def test_physics_ops_against_plain_count(kernel):
    from biped_mpc_py_torch.ops.cuda.substep_kernel import fused_substeps_reference
    from biped_mpc_py_torch.ops.cuda.tick_kernel import fused_tick_reference
    from biped_mpc_py_torch.parallel.rollout_art import art_config_for_speed

    n = 8
    model, state, tau, Minv, gen = _art_inputs(n)
    if kernel == "substeps":
        _, plain = count_ops(fused_substeps_reference, model, state, tau, Minv, 0.005, 5)
        derived = roofline.substep_ops(n, 5)
    else:
        mpc, gait = art_config_for_speed(0.3)
        u0 = 30.0 * torch.randn(n, 12, generator=gen)
        c0 = (torch.rand(n, 2, generator=gen) < 0.5).float()
        t0, yaw = 0.4 * torch.rand(n, generator=gen), 0.3 * torch.randn(n, generator=gen)
        v_int = 0.1 * torch.randn(n, 2, generator=gen)
        _, plain = count_ops(fused_tick_reference, model, BipedParams(), mpc, gait,
                             state, u0, c0, t0, yaw, v_int, Minv)
        derived = roofline.tick_ops(n, 8, 5)
    assert roofline.SUBSTEP_OPS == 4324 and roofline.PERIOD_OPS == 2117
    assert 1.69 < plain / derived < 1.71, (kernel, plain / derived)


def test_tensor_bytes():
    x = torch.zeros(3, 4)
    assert roofline.tensor_bytes(x, [x, (x.double(),)]) == 48 + 48 + 96


def test_ptxas_report(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    log = build._library_path(src).with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 243 registers, used 1 barriers\n"
    )
    assert build.ptxas_report(src) == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 243 registers, used 1 barriers",
    ]

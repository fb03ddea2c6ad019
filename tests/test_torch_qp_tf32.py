"""A CPU rehearsal of the QP kernel's split-TF32 Newton-Schulz arithmetic.

``csrc/qp_admm.cu`` runs the Newton-Schulz products of the K^-1 inverse on
the tensor cores: each f32 operand v is rounded to TF32 (10 mantissa bits,
to nearest, ties away from zero, as ``cvt.rna`` rounds) as hi, the
remainder v - hi is rounded again as lo, and each 16x8 tile sums hi*hi in
one f32 accumulator and lo*hi + hi*lo in another, added once at the end
(3xTF32); the last ``FOUR_LAST`` NS steps also form lo*lo, and the first
step, whose products are with the diagonal X0, is elementwise f32. Here the same
split is emulated in plain torch (the rounding by integer arithmetic on the
f32 bit pattern), and the plain NS inverse and the plain solve run with it
(``ops.qp.ns_inverse`` monkeypatched) on real MPC QPs, built as
``tests/test_torch_cuda.py::_mpc_qps`` builds them. The solves here run the
bench budget with the JAX package's bf16 knobs off (``BENCH_F32``), where
every NS step after the first is a 3xTF32 one.

The kernel's bf16 NS steps (``MpcConfig.kinv_bf16_iters``: one bf16
m16n8k16 product per tile, operands rounded to nearest even) are emulated
by :func:`mm_bf16_mma`; ``tests/test_torch_qp_bf16.py`` holds that hybrid
against the JAX package's.

The tensor cores' f32 accumulation truncates (rounds toward zero) instead of
rounding to nearest. :func:`mm_tf32` emulates that at each k-step of 8: the
step's products summed exactly (f64), added to the accumulator and
truncated to f32. ``accumulators=1`` feeds all terms into one sum, the
layout the kernel avoids.

Bounds:
- at the bench budget (NS 10, not converged, where the iteration amplifies
  product errors) the unscaled controls stay within the kernel's bound of
  0.05 N of the f32 plain version, with and without the torsional cone;
- on the K matrices the emulated inverse's distance to the same iteration
  in f64 stays within 2x the f32 plain version's distance (relative max
  norm; measured 0.9-1.0x); its median distance stays within 1.15x, and
  one accumulator or no lo*lo product is further off.
The 1xTF32 emulation (one product of the rounded operands) is printed
beside them: it misses both bounds by orders of magnitude, which is why the
kernel splits.

Run as a script, it prints the solve-level comparison behind these choices
(median |du| and envs past 0.1 N against the f32 plain solve over N QPs at
both budgets; ``--rn`` accumulates to nearest instead):

    python -m tests.test_torch_qp_tf32 256
    python -m tests.test_torch_qp_tf32 1024 --rn
"""

import dataclasses
import sys

import pytest
import torch

from biped_mpc_py_torch import MpcConfig, fast_mpc_config
from biped_mpc_py_torch.ops import qp as tqp
from biped_mpc_py_torch.ops.cuda import qp_kernel as tk
from tests.test_torch_cuda import _mpc_qps
from torch_threads import one_torch_thread  # noqa: F401

N_QPS = 128
BOUND_CONTROLS = 0.05  # N, the kernel's bench-budget bound (chip_smoke.BOUND_BENCH)
INVERSE_FACTOR = 2.0
MEDIAN_FACTOR = 1.15
FOUR_LAST = 2  # the kernel's kFourLast: NS steps, at the end, that form lo*lo
# the bench budget with the bf16 knobs off: every NS step after the first in 3xTF32
BENCH_F32 = dataclasses.replace(fast_mpc_config(), kinv_bf16_iters=0, admm_bf16_matvec=False,
                                ruiz_bf16_norms=False)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (to nearest, ties away from zero), as the
    f32 value: add half of the 13 dropped bits to the magnitude bits, then
    clear them (a carry moves into the exponent, as rounding up should)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_f32_rz(v: torch.Tensor) -> torch.Tensor:
    """f64 ``v`` to f32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


_RZ_MASK = -(1 << 29)  # clears the 29 low mantissa bits an f32 does not hold


def rz64(v: torch.Tensor) -> torch.Tensor:
    """:func:`to_f32_rz` kept in f64 (``rz64(v).float()`` is exact and
    equal to it for values in f32's normal range): the mantissa bits below
    f32's are cleared, which rounds the magnitude down."""
    return (v.view(torch.int64) & _RZ_MASK).view(torch.float64)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int = 3, accumulators: int = 2,
            truncate: bool = True) -> torch.Tensor:
    """a @ b as the kernel forms it: per k-step of 8, hi*hi into one f32
    accumulator and lo*hi + hi*lo (with ``products=4`` also lo*lo, first)
    into another, the two added at the end; ``accumulators=1`` sums all
    terms into one. Each accumulation truncates (``truncate``) or rounds to
    nearest."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    if not truncate:
        small = al @ bl + al @ bh if products == 4 else al @ bh
        return (small + ah @ bl) + ah @ bh
    # the accumulators hold f32 values in f64 (rz64 keeps them so)
    ah, bh, al, bl = (t.double() for t in (ah, bh, al, bl))
    big = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    cor = torch.zeros_like(big)
    pairs = ((al, bl), (al, bh), (ah, bl)) if products == 4 else ((al, bh), (ah, bl))
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)

        def step(x, y):
            return x[..., ks] @ y[..., ks, :]

        if accumulators == 1:
            for x, y in (*pairs, (ah, bh)):
                big = rz64(big + step(x, y))
        else:
            for x, y in pairs:
                cor = rz64(cor + step(x, y))
            big = rz64(big + step(ah, bh))
    return big.float() + cor.float()


def mm_bf16_mma(a: torch.Tensor, b: torch.Tensor, truncate: bool = True) -> torch.Tensor:
    """a @ b as the kernel's bf16 steps form it: operands rounded to bf16
    (to nearest even), one product per tile, the f32 accumulator truncated
    (``truncate``) or rounded to nearest after each k-step of 16."""
    ab, bb = (t.to(torch.bfloat16).double() for t in (a, b))
    if not truncate:
        return tqp.mm_bf16(a, b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k in range(0, a.shape[-1], 16):
        acc = rz64(acc + ab[..., k:k + 16] @ bb[..., k:k + 16, :])
    return acc.float()


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def mm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Another f32 product: exact sums, rounded once."""
    return (a.double() @ b.double()).float()


def ns_inverse_with(mm, mm_last=None, n_last: int = FOUR_LAST, mm_first=None,
                    mm_bf16=tqp.mm_bf16):
    """``ops.qp.ns_inverse`` (``ns_inverse(K, n_iters, bf16_iters)``) with
    its two products formed by ``mm_bf16`` in the first ``bf16_iters``
    steps, and after them by ``mm``, by ``mm_last`` (if given) in the last
    ``n_last`` steps and by ``mm_first`` (if given) in the first."""

    def ns_inverse(K, n_iters=14, bf16_iters=0):
        n = K.shape[-1]
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        s = torch.rsqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30))
        Khat = K * s[..., :, None] * s[..., None, :]
        X = eye / torch.amax(torch.sum(torch.abs(Khat), dim=-1), dim=-1)[..., None, None]
        for it in range(n_iters):
            f = mm_last if mm_last is not None and it >= n_iters - n_last else mm
            f = mm_first if mm_first is not None and it == 0 else f
            f = mm_bf16 if it < bf16_iters else f
            X = f(X, 2.0 * eye - f(Khat, X))
        return X * s[..., :, None] * s[..., None, :]

    return ns_inverse


def kernel_ns_inverse(accumulators: int = 2, truncate: bool = True):
    """The kernel's NS inverse: the first ``bf16_iters`` steps by
    :func:`mm_bf16_mma` (the first of them, with the diagonal X0, exact as
    the kernel's elementwise step is), else the first step in f32 (its
    products are with the diagonal X0, which the kernel forms
    elementwise), then 3xTF32 products, four in the last steps."""
    return ns_inverse_with(
        lambda a, b: mm_tf32(a, b, 3, accumulators, truncate),
        lambda a, b: mm_tf32(a, b, 4, accumulators, truncate), mm_first=torch.matmul,
        mm_bf16=lambda a, b: mm_bf16_mma(a, b, truncate))


def _kkt_of(mpc, n_qps):
    """The first phase's K matrices of ``n_qps`` real MPC QPs."""
    qp = _mpc_qps(n_qps, "cpu", mpc)
    Ph, _, Ah, lh, uh, *_ = tqp.ruiz_equilibrate(qp, mpc.ruiz_iters, mpc.ruiz_bf16_norms)
    rho = torch.where((uh - lh) < 1e-6, mpc.admm_rho * tk.EQ_RHO_BOOST, mpc.admm_rho)
    return tk._kkt(Ph, Ah, rho, mpc.admm_sigma)


def _distances(K, iters, inverses):
    """Relative max-norm distance of each of ``inverses`` (NS inverse
    functions) to the f64 iteration, per QP."""
    X64 = tqp.ns_inverse(K.double(), iters)
    scale = X64.abs().amax((1, 2))
    return {name: (inv(K, iters).double() - X64).abs().amax((1, 2)) / scale
            for name, inv in inverses.items()}


def test_tf32_rounding():
    one = torch.tensor(1.0)
    ulp = 2.0 ** -10  # TF32 spacing at 1
    vals = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0])
    want = torch.tensor([1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0])
    assert torch.equal(tf32_rna(vals), want)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21
    assert torch.equal(tf32_rna(one), one)


def test_truncating_accumulation():
    v = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0], dtype=torch.float64)
    assert torch.equal(to_f32_rz(v), torch.tensor([1.0, -1.0, 3.0]))
    w = torch.randn(4096, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    w = torch.cat([w, w * 1e-30, w * 1e30, torch.zeros(1, dtype=torch.float64)])
    assert torch.equal(rz64(w).float(), to_f32_rz(w))
    gen = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 24, 40, generator=gen), torch.randn(2, 40, 16, generator=gen)
    exact = a.double() @ b.double()
    for products in (3, 4):
        for truncate in (True, False):
            got = mm_tf32(a, b, products, truncate=truncate)
            assert float((got - exact).abs().max() / exact.abs().max()) < 2e-6


@pytest.mark.parametrize("cone", [False, True])
def test_bench_controls_within_kernel_bound(cone, monkeypatch):
    mpc = dataclasses.replace(BENCH_F32, mu_z=0.03) if cone else BENCH_F32
    qp = _mpc_qps(N_QPS, "cpu", mpc)
    base = tqp.solve_qp(qp, mpc)
    du = {}
    for name, inv in (("kernel", kernel_ns_inverse()), ("1xtf32", ns_inverse_with(mm_1xtf32))):
        with monkeypatch.context() as m:
            m.setattr(tqp, "ns_inverse", inv)
            sol = tqp.solve_qp(qp, mpc)
        du[name] = float((sol.controls - base.controls).abs().max())
    print(f"bench budget{' + cone' if cone else ''}: max|du| vs f32 plain: "
          f"kernel's split {du['kernel']:.4f} N, 1xTF32 {du['1xtf32']:.3f} N "
          f"(bound {BOUND_CONTROLS} N)")
    assert du["kernel"] < BOUND_CONTROLS
    assert du["1xtf32"] > BOUND_CONTROLS  # why the kernel does not use 1xTF32


@pytest.mark.parametrize("budget", ["bench", "default"])
def test_inverse_close_to_f64(budget):
    mpc = BENCH_F32 if budget == "bench" else MpcConfig()
    d = {k: float(v.max()) for k, v in _distances(
        _kkt_of(mpc, N_QPS // 4), mpc.kinv_ns_iters,
        {"f32": tqp.ns_inverse, "kernel": kernel_ns_inverse(),
         "1xtf32": ns_inverse_with(mm_1xtf32)}).items()}
    print(f"{budget} budget, NS {mpc.kinv_ns_iters}: relative max distance to the f64 "
          "iteration: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    assert d["kernel"] <= INVERSE_FACTOR * d["f32"]
    assert d["1xtf32"] > 100 * d["f32"]


def test_kernel_split_keeps_f32_accuracy():
    """Median over QPs of the inverse's distance to the f64 iteration, at
    the default budget: the kernel's scheme stays within MEDIAN_FACTOR of
    the f32 plain version; one accumulator, or no lo*lo product in the last
    steps, falls further behind."""
    mpc = MpcConfig()
    d = {k: float(v.median()) for k, v in _distances(
        _kkt_of(mpc, N_QPS // 4), mpc.kinv_ns_iters,
        {"f32": tqp.ns_inverse, "kernel": kernel_ns_inverse(),
         "one accumulator": kernel_ns_inverse(accumulators=1),
         "three products": ns_inverse_with(lambda a, b: mm_tf32(a, b, 3))}).items()}
    print("default budget: median relative distance to the f64 iteration: "
          + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    assert d["kernel"] <= MEDIAN_FACTOR * d["f32"]
    assert d["one accumulator"] > d["kernel"]
    assert d["three products"] > d["kernel"]


def main(n_qps: int, truncate: bool) -> None:
    """Median and max |du| of the unscaled controls, and the envs past
    0.1 N, against the f32 plain solve at both budgets, for each emulated
    product."""
    inverses = {
        "f64 products, rounded to f32": ns_inverse_with(mm_f64),
        "kernel (3xTF32, four products in the last 2 steps)": kernel_ns_inverse(2, truncate),
        "3xTF32 in every step": ns_inverse_with(lambda a, b: mm_tf32(a, b, 3, 2, truncate)),
        "four products in every step": ns_inverse_with(lambda a, b: mm_tf32(a, b, 4, 2, truncate)),
        "kernel, one accumulator": kernel_ns_inverse(1, truncate),
    }
    saved = tqp.ns_inverse
    for budget, mpc in (("bench", BENCH_F32), ("default", MpcConfig())):
        qp = _mpc_qps(n_qps, "cpu", mpc)
        base = tqp.solve_qp(qp, mpc)
        for name, inv in inverses.items():
            tqp.ns_inverse = inv
            try:
                sol = tqp.solve_qp(qp, mpc)
            finally:
                tqp.ns_inverse = saved
            du = (sol.controls - base.controls).abs().flatten(1).amax(1)
            print(f"{budget} budget, {n_qps} QPs, {'truncating' if truncate else 'to nearest'}, "
                  f"{name}: median |du| {float(du.median()):.5f} N, max {float(du.max()):.4f} N, "
                  f"envs past 0.1 N {int((du > 0.1).sum())}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128, "--rn" not in sys.argv)

// Fused ADMM solve of a batch of Ruiz-scaled MPC box QPs, for Hopper (sm_90a).
//
// Replaces the TPU kernel biped_mpc_py_tpu/ops/pallas/qp_kernel.py::
// fused_qp_solve. One CTA solves one env's whole QP in one launch:
//
//   for each rho phase:
//     K = P + sigma I + blkdiag(A_k' diag(rho_k) A_k)   (equality rows rho x1e3)
//     K^-1 by Jacobi-preconditioned Newton-Schulz       (ns_iters steps)
//     n_iters/n_phases over-relaxed ADMM steps (clip to [l,u], dual update)
//     OSQP rho re-pick from the residual ratio, clipped to [1e-2, 1e2]
//   optional polish: rho_pol = 1e4 on the detected active rows, a second
//   NS inverse, 3 augmented-Lagrangian steps, exact-penalty merit accept.
//
// Two bf16 knobs of the JAX package's solver (MpcConfig.kinv_bf16_iters and
// admm_bf16_matvec, one value per launch) change what is computed, as in its
// ops/qp.py::solve_qp: bf16_iters > 0 forms both products of the first
// bf16_iters Newton-Schulz steps of every inverse from bf16 operands (rounded
// to nearest even) with f32 accumulation; bf16_matvec rounds K^-1 (once per
// rho phase) and each ADMM step's right-hand side to bf16 before the
// f32-accumulated product. The polish's K^-1 product stays f32.
//
// rho, sigma and alpha are one value per launch, or one per env (a config
// sweep gives each env its own ADMM numerics): a non-null per-env pointer
// replaces the scalar argument, and each CTA reads its env's three floats
// once, before the phase loop. The equality boost and the OSQP re-pick then
// start from the env's own rho. One env per CTA, so an env's result does not
// depend on the other envs' values.
//
// The algorithm is that of the plain version fused_qp_solve_reference in
// ops/cuda/qp_kernel.py (the scaled core of ops/qp.py::solve_qp in the JAX
// package); the two differ in f32 summation order, and the Newton-Schulz
// products here run on the tensor cores (below): the bf16 steps in one bf16
// product, the others in split TF32 where the plain version's are f32.
//
// What bounds it on this card: the Newton-Schulz products. Each NS step is
// two dense 120x120x120 products, 2 * 2 * 120^3 = 6.9 MFLOP, after a first
// step that is elementwise (X0 is diagonal). At the bench budget (1 phase,
// NS 10, no polish) that is 62 MFLOP per env per tick; at the default
// budget (3 phases + polish, NS 14: 4 inverses) 359 MFLOP. The ADMM
// iterations add ~0.04 MFLOP each: short, latency-bound passes. At the
// JAX bench budget (bf16_iters 8) steps 2-8 of the 10 are one bf16 product
// each, steps 9-10 the 3xTF32 split with lo*lo.
//
// What the design does about it:
//  - One CTA of 256 threads (8 warps) per env. K, X and one scratch matrix
//    live in dynamic shared memory with row stride 120, 3 x 57.6 KB, plus
//    the per-step A blocks (h x m x 12) and the vectors: ~203 KB, under the
//    227 KB a block may use (needs cudaFuncSetAttribute).
//  - The NS products run on the tensor cores, mma.sync m16n8k8 with TF32
//    operands, at f32 accuracy by the 3xTF32 split: each operand v is
//    rounded to TF32 (to nearest, ties away, by integer arithmetic on its
//    bits, as cvt.rna does; the conversion instruction issues at a quarter
//    of the integer rate) as hi, the remainder v - hi (exact) rounded again
//    as lo. Each tile sums hi*hi in one f32 accumulator and the small terms
//    lo*hi + hi*lo in another, added once at the end:
//      * two accumulators, because the tensor cores' accumulation truncates
//        at the accumulator's scale, so small terms fed into the hi*hi sum
//        lose their low bits at every step;
//      * in the last two NS steps also lo*lo (2^-22 relative, 4x an f32
//        rounding). NS corrects the errors of earlier steps, so the last
//        steps' products set K^-1's accuracy. With three products in every
//        step the default-budget solve on the H100 put 34 of 1024 envs past
//        0.1 N of the f32 plain version, one more than the noise floor's
//        rule allows (chip_smoke.py::phase_kernel).
//    Both choices are emulated in tests/test_torch_qp_tf32.py. No product
//    runs in 1xTF32 or fp16. mma.sync with TF32 operands runs far below the
//    tensor cores' TF32 peak (chip_smoke.py prints the rate it reaches over
//    the time the NS products add; PERF.md keeps it), so these products set
//    the kernel's time; wgmma would need the B operand's hi and lo planes in
//    shared memory, which does not hold them beside K, X and T.
//  - The bf16 steps (the first bf16_iters, when the caller asks for them):
//    the first step stays elementwise, with Khat, 1/||Khat|| and
//    T = 2I - Khat X0 rounded to bf16 where the plain version rounds them
//    (its products are then exact). Steps 2..bf16_iters are one mma.sync
//    m16n8k16 with bf16 operands per tile and one f32 accumulator, the
//    operands rounded to nearest even (cvt.rn, not the TF32 split's ties
//    away) as the fragments load from the f32 tiles: an A register is a
//    float2 of two neighbouring k of one row (conflict-free at stride 120),
//    a B register two rows 120 floats apart (2-way bank conflicts: rows
//    2t and 2t + 1 land on the banks of rows 2t + 4 and 2t + 5). No bf16
//    copy of a plane is kept: 28.8 KB more does not fit beside the ~203 KB.
//    k runs in 8 steps of 16 over 128 columns; columns and rows from n on
//    are zero fragments (at n = 120, columns 120..127 would read the next
//    row). The tensor cores truncate this accumulation too, as the TPU's
//    MXU rounds its bf16 passes; the f32-accurate steps after them correct
//    it (tests/test_torch_qp_bf16.py emulates the scheme).
//  - The 8 warps tile the 128-row padded product 2 x 4: warp (r, c) owns
//    rows 64r..64r+63 (4 m-tiles of 16; rows 120..127 are zero fragments,
//    not storage) and n-tiles 4c..4c+3 of the 15 (2 x 64 accumulators a
//    thread); k runs in 15 steps of 8. Per k-step a warp splits 16 A and 8
//    B fragment words for 48 (64) mma.sync, against 34 for 45 in a 16-row
//    stripe. Stride 120 makes the B loads bank-conflict-free; the A loads
//    are 2-way (no stride makes both free: A needs stride = 4 * odd mod 32,
//    B needs 8 or 24).
//  - X <- X T in place: every warp finishes its tiles in registers, the
//    CTA synchronizes, then the tiles are stored.
//  - After each inverse, K^-1 (with the Jacobi scaling folded in) moves
//    into registers: thread t < 240 holds half of row t mod 120, 60 floats,
//    and reads rhs by broadcast from shared memory as float4. An ADMM step
//    is two passes with one barrier each: the half-row partial products,
//    then half a warp per horizon step that sums the halves, updates x, z,
//    y for the step's variables and rows, and forms the step's rhs for the
//    next iteration from them (no shuffle reductions, only __syncwarp). The
//    polish's augmented-Lagrangian steps use the same two passes. With
//    bf16_matvec each of the 60 floats is rounded to bf16 as it moves into
//    registers after a rho phase's inverse, and each rhs entry as it is
//    formed; the products of bf16 values are exact, the sums f32.
//  - A is kept as its h per-step blocks, never as the dense block-diagonal
//    (the TPU layout); P is read from global memory (through L2) only to
//    build K and for the rho re-pick and merit products, as float4 loads
//    issued in batches (one CTA per SM leaves little else to hide their
//    latency).
//  - All reductions (residual maxima, merit sums) stay inside the CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNu = 12;                  // controls per horizon step
constexpr int kHMax = 10;                // horizon steps held
constexpr int kNMax = kHMax * kNu;       // 120 variables
constexpr int kLd = kNMax;               // shared row stride (see the note above)
constexpr int kMat = kNMax * kLd;
constexpr int kMsMax = 28;               // constraint rows per step held
constexpr int kMMax = kHMax * kMsMax;    // 280 rows
constexpr int kTiles = kNMax / 8;        // 15 n- and k-tiles of the mma
constexpr int kMT = 4;                   // m-tiles of 16 rows a warp holds
constexpr int kNT = 4;                   // n-tiles of 8 columns a warp holds
constexpr int kHalf = kNMax / 2;         // K^-1 floats a thread holds
static_assert(kNMax % 8 == 0 && kWarps == 8, "2 x 4 warps tile the product");
static_assert(2 * 16 * kMT >= kNMax && 4 * kNT >= kTiles, "the warps cover K");
static_assert(2 * kNMax <= kThreads && kHalf % 4 == 0, "two threads per row of K^-1");
static_assert(kMsMax <= 32 && kNu <= 16 && 2 * kWarps >= kHMax, "half a warp per horizon step");

constexpr int kVecN = 8;                 // q, x, v, rhs, s, xp, part (2 halves)
constexpr int kVecM = 11;                // l, u, z, y, rhov, wgt, wact, bact, lam, av, w
constexpr int kSmemFloats =
    3 * kMat + kHMax * kMsMax * kNu + kVecN * kNMax + kVecM * kMMax + 64;

constexpr int kFourLast = 2;             // NS steps, at the end, with lo*lo
constexpr float kEqBoost = 1e3f;
constexpr float kRhoPolish = 1e4f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// CTA-wide max / sum; every thread gets the result. red holds kWarps floats.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

// v rounded to TF32 (to nearest, ties away from zero), as the mma operand
// bits: half of the 13 dropped bits added to the magnitude, then cleared (a
// carry moves into the exponent). The same bits as cvt.rna.tf32.f32.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo: hi = tf32(v), lo = tf32(v - hi) (v - hi is exact).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// v rounded to bf16 (to nearest, ties to even), as an f32 value.
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two f32 rounded to bf16 (to nearest even) in one mma operand register:
// lo in the low 16 bits (the lower k), hi in the high.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b for one 16x8x16 tile with bf16 operands (a: 16x16 row-major,
// b: 16x8 column-major), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for one 16x8x8 tile (a: 16x8 row-major, b: 8x8 column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How matmul forms its products: bf16 operands (one product a tile), split
// TF32 (three), split TF32 with lo*lo (four).
enum Prec { kBf16, kTf32x3, kTf32x4 };

// C = A B (kTwoMinus: C = 2I - A B) for n x n matrices in shared memory with
// row stride kLd, on the tensor cores as kPrec says; entries beyond n are
// zero on input. C may alias A or B: every tile is finished in registers
// before any is stored. Ends with a CTA barrier.
template <bool kTwoMinus, Prec kPrec>
__device__ void matmul(const float* A, const float* B, float* C, int n) {
  constexpr bool kFour = kPrec == kTf32x4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment row group / column
  const int r0 = (warp >> 2) * 16 * kMT;      // this warp's first row
  const int j0 = (warp & 3) * kNT;            // this warp's first n-tile
  const int nt = (n + 7) >> 3;                // k- and n-tiles that hold K
  float acc[kMT][kNT][4], cor[kMT][kNT][4];   // hi*hi; (lo*lo +) lo*hi + hi*lo
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = cor[m][j][e] = 0.f;
  if (kPrec == kBf16 && r0 < n && j0 < nt) {
    const float2 zero2 = make_float2(0.f, 0.f);
    for (int kb = 0; kb < n; kb += 16) {  // the same trip count in every lane
      const int k0 = kb + 2 * t4;           // this thread's k (and k + 1, + 8, + 9)
      const bool k_lo = k0 < n, k_hi = k0 + 8 < n;  // n is even: k + 1 < n with k
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int ra = r0 + 16 * m + g, rb = ra + 8;
        const bool on = r0 + 16 * m < n, on_b = on && rb < kNMax;
        const float2* a_top = reinterpret_cast<const float2*>(A + ra * kLd + k0);
        const float2* a_bot = reinterpret_cast<const float2*>(A + rb * kLd + k0);
        const float2 t0 = on && k_lo ? a_top[0] : zero2, t1 = on && k_hi ? a_top[4] : zero2;
        const float2 b0 = on_b && k_lo ? a_bot[0] : zero2, b1 = on_b && k_hi ? a_bot[4] : zero2;
        a[m][0] = pack_bf16(t0.x, t0.y);
        a[m][1] = pack_bf16(b0.x, b0.y);
        a[m][2] = pack_bf16(t1.x, t1.y);
        a[m][3] = pack_bf16(b1.x, b1.y);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j0 + j < nt) {
          const float* b = B + k0 * kLd + 8 * (j0 + j) + g;
          const uint32_t b0 = k_lo ? pack_bf16(b[0], b[kLd]) : 0u;
          const uint32_t b1 = k_hi ? pack_bf16(b[8 * kLd], b[9 * kLd]) : 0u;
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            if (r0 + 16 * m < n) mma_bf16(acc[m][j], a[m], b0, b1);
        }
      }
    }
  } else if (kPrec != kBf16 && r0 < n && j0 < nt) {
    for (int kt = 0; kt < nt; ++kt) {
      const int k = kt * 8 + t4;
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int ra = r0 + 16 * m + g, rb = ra + 8;  // rb passes the matrix at 120
        const bool on = r0 + 16 * m < n;
        const float* a_top = A + ra * kLd + k;
        const float* a_bot = A + rb * kLd + k;
        split_tf32(on ? a_top[0] : 0.f, ah[m][0], al[m][0]);
        split_tf32(on && rb < kNMax ? a_bot[0] : 0.f, ah[m][1], al[m][1]);
        split_tf32(on ? a_top[4] : 0.f, ah[m][2], al[m][2]);
        split_tf32(on && rb < kNMax ? a_bot[4] : 0.f, ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j0 + j < nt) {
          const float* b_top = B + k * kLd + 8 * (j0 + j) + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b_top[0], bh0, bl0);
          split_tf32(b_top[4 * kLd], bh1, bl1);
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            if (r0 + 16 * m < n) {
              if (kFour) mma_tf32(cor[m][j], al[m], bl0, bl1);  // smallest first
              mma_tf32(cor[m][j], al[m], bh0, bh1);
              mma_tf32(cor[m][j], ah[m], bl0, bl1);
              mma_tf32(acc[m][j], ah[m], bh0, bh1);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  if (r0 < n && j0 < nt) {
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int ra = r0 + 16 * m + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (r0 + 16 * m < n && j0 + j < nt) {
          const int c = 8 * (j0 + j) + 2 * t4;
          float2 top = make_float2(acc[m][j][0], acc[m][j][1]);
          float2 bot = make_float2(acc[m][j][2], acc[m][j][3]);
          if (kPrec != kBf16) {
            top = make_float2(top.x + cor[m][j][0], top.y + cor[m][j][1]);
            bot = make_float2(bot.x + cor[m][j][2], bot.y + cor[m][j][3]);
          }
          if (kTwoMinus) {
            top = make_float2((ra == c ? 2.f : 0.f) - top.x, (ra == c + 1 ? 2.f : 0.f) - top.y);
            bot = make_float2((rb == c ? 2.f : 0.f) - bot.x, (rb == c + 1 ? 2.f : 0.f) - bot.y);
          }
          *reinterpret_cast<float2*>(C + ra * kLd + c) = top;
          if (rb < kNMax) *reinterpret_cast<float2*>(C + rb * kLd + c) = bot;
        }
      }
    }
  }
  __syncthreads();
}

// out[i] = sum_j P[i][j] v[j] for P in global memory (row-major n x n, 16-byte
// aligned, n a multiple of 4): thread t < 2n takes half of row t / 2 as
// float4 loads, all issued before the sums; the halves meet by one shuffle.
// No barrier.
__device__ void matvec_global(const float* __restrict__ P, const float* v,
                              float* out, int n) {
  constexpr int kMax4 = (kNMax / 4 + 1) / 2;  // float4 a thread loads at most
  const int t = threadIdx.x, row = t >> 1, half = t & 1;
  const int n4 = n / 4, h4 = (n4 + 1) / 2;
  const int c_begin = half * h4, c_end = min(n4, c_begin + h4);
  float acc = 0.f;
  if (row < n) {
    const float4* p4 = reinterpret_cast<const float4*>(P + row * n);
    float4 pv[kMax4];
#pragma unroll
    for (int c = 0; c < kMax4; ++c)
      pv[c] = c_begin + c < c_end ? __ldg(p4 + c_begin + c) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMax4; ++c) {
      if (c_begin + c < c_end) {
        const float* vv = v + 4 * (c_begin + c);
        acc = fmaf(pv[c].x, vv[0], acc);
        acc = fmaf(pv[c].y, vv[1], acc);
        acc = fmaf(pv[c].z, vv[2], acc);
        acc = fmaf(pv[c].w, vv[3], acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (row < n && half == 0) out[row] = acc;
}

// (A v)_j for every constraint row j = k*ms + r (A held per step).
__device__ __forceinline__ float row_dot(const float* sA, const float* v, int j,
                                         int ms) {
  const int k = j / ms;
  const float* a = sA + j * kNu;
  const float* vk = v + k * kNu;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kNu; ++c) acc = fmaf(a[c], vk[c], acc);
  return acc;
}

// (A' w)_i for variable i = 12k + c.
__device__ __forceinline__ float col_dot(const float* sA, const float* w, int i,
                                         int ms) {
  const int k = i / kNu, c = i % kNu;
  float acc = 0.f;
  for (int r = 0; r < ms; ++r) {
    const int j = k * ms + r;
    acc = fmaf(sA[j * kNu + c], w[j], acc);
  }
  return acc;
}

// K = P + sigma I + blkdiag(A_k' diag(wgt_k) A_k), into shared K (n x n):
// P copied in as float4 loads issued 8 at a time, then the h diagonal
// blocks added.
__device__ void build_kkt(const float* __restrict__ P, const float* sA,
                          const float* wgt, float* K, int n, int ms, float sigma) {
  constexpr int kBatch = 8;
  const int n4 = n / 4, total = n * n4;
  const float4* P4 = reinterpret_cast<const float4*>(P);
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float4 pv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * kThreads;
      if (idx < total) pv[b] = __ldg(P4 + idx);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * kThreads;
      if (idx < total) {
        const int i = idx / n4, j = 4 * (idx % n4);
        *reinterpret_cast<float4*>(K + i * kLd + j) = pv[b];
      }
    }
  }
  __syncthreads();
  const int h = n / kNu;
  for (int e = threadIdx.x; e < h * kNu * kNu; e += kThreads) {
    const int k = e / (kNu * kNu), ci = (e / kNu) % kNu, cj = e % kNu;
    const float* a = sA + k * ms * kNu;
    const float* w = wgt + k * ms;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four chains, loads ahead
    int r = 0;
    for (; r + 4 <= ms; r += 4) {
      a0 = fmaf(a[r * kNu + ci] * w[r], a[r * kNu + cj], a0);
      a1 = fmaf(a[(r + 1) * kNu + ci] * w[r + 1], a[(r + 1) * kNu + cj], a1);
      a2 = fmaf(a[(r + 2) * kNu + ci] * w[r + 2], a[(r + 2) * kNu + cj], a2);
      a3 = fmaf(a[(r + 3) * kNu + ci] * w[r + 3], a[(r + 3) * kNu + cj], a3);
    }
    for (; r < ms; ++r) a0 = fmaf(a[r * kNu + ci] * w[r], a[r * kNu + cj], a0);
    const int i = k * kNu + ci, j = k * kNu + cj;
    const float pij = K[i * kLd + j];
    K[i * kLd + j] = (i == j ? pij + sigma : pij) + ((a0 + a1) + (a2 + a3));
  }
  __syncthreads();
}

// Xhat = Khat^-1 by Jacobi-preconditioned Newton-Schulz: Khat = S K S with
// S = diag(1/sqrt(diag K)) (diag clamped at 1e-30), X0 = I/||Khat||_inf,
// X <- X (2I - Khat X), the first step elementwise, the others on the
// tensor cores; the first bf16_iters steps from bf16 operands. K is
// overwritten by Khat, X by Xhat, T is scratch; s keeps S's diagonal
// (K^-1 = S Xhat S, formed by load_kinv).
__device__ void ns_inverse(float* K, float* X, float* T, float* s, float* red,
                           int n, int iters, int bf16_iters) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) s[i] = rsqrtf(fmaxf(K[i * kLd + i], 1e-30f));
  __syncthreads();
  const int w = tid >> 5, lane = tid & 31;
  float row_max = 0.f;
  for (int i = w; i < n; i += kWarps) {  // Khat, and its rows' |.| sums
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float kij = K[i * kLd + j] * s[i] * s[j];
      K[i * kLd + j] = kij;
      acc += fabsf(kij);
    }
    row_max = fmaxf(row_max, warp_sum(acc));
  }
  const float inv_nrm = 1.f / block_max(row_max, red);
  // X0 = inv_nrm I, so the first step is elementwise: Khat X0 = inv_nrm Khat
  // and X1 = inv_nrm T1, each entry one f32 product, rounded as a product
  // with the diagonal X0 rounds (the plain version's arithmetic, exactly;
  // __fmul_rn keeps the compiler from fusing it into the subtraction). A
  // bf16 first step rounds Khat, inv_nrm and T1 to bf16 first, as the plain
  // version's bf16 operands are; its two products are then exact.
  const bool bf16_first = bf16_iters > 0;
  const float inv_b = bf16_rn(inv_nrm);
  for (int i = w; i < kNMax; i += kWarps) {
    for (int j = lane; j < kLd; j += 32) {
      const int idx = i * kLd + j;
      const float two = i == j ? 2.f : 0.f;
      if (i >= n || j >= n) X[idx] = 0.f;
      else if (iters == 0) X[idx] = i == j ? inv_nrm : 0.f;
      else if (bf16_first)
        X[idx] = __fmul_rn(inv_b, bf16_rn(two - __fmul_rn(bf16_rn(K[idx]), inv_b)));
      else X[idx] = inv_nrm * (two - __fmul_rn(K[idx], inv_nrm));
    }
  }
  __syncthreads();
  for (int it = 1; it < iters; ++it) {
    if (it < bf16_iters) {
      matmul<true, kBf16>(K, X, T, n);   // T = 2I - Khat X
      matmul<false, kBf16>(X, T, X, n);  // X = X T, in place
    } else if (it < iters - kFourLast) {
      matmul<true, kTf32x3>(K, X, T, n);
      matmul<false, kTf32x3>(X, T, X, n);
    } else {
      matmul<true, kTf32x4>(K, X, T, n);
      matmul<false, kTf32x4>(X, T, X, n);
    }
  }
}

// This thread's half row of K^-1 = S Xhat S into registers: thread t < 240
// holds row t mod 120, columns 60 (t / 120) .. +59; zero beyond n; each
// rounded to bf16 with `round`.
__device__ __forceinline__ void load_kinv(const float* X, const float* s,
                                          float (&kinv)[kHalf], int n, bool round) {
  const int t = threadIdx.x;
  const int r = t % kNMax, c0 = (t / kNMax) * kHalf;
  const bool on = t < 2 * kNMax && r < n;
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const float v = (on && c0 + c < n) ? X[r * kLd + c0 + c] * s[r] * s[c0 + c] : 0.f;
    kinv[c] = round ? bf16_rn(v) : v;
  }
}

// part[half][r] = sum over this thread's half row of K^-1 times rhs; the
// two halves sum to (K^-1 rhs)_r. rhs beyond n is zero.
__device__ __forceinline__ void kinv_matvec(const float (&kinv)[kHalf], const float* rhs,
                                            float* part, int n) {
  const int t = threadIdx.x;
  const int r = t % kNMax, half = t / kNMax;
  if (t < 2 * kNMax && r < n) {
    const float4* v4 = reinterpret_cast<const float4*>(rhs + half * kHalf);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int c = 0; c < kHalf / 4; ++c) {
      const float4 b = v4[c];
      a0 = fmaf(kinv[4 * c], b.x, a0);
      a1 = fmaf(kinv[4 * c + 1], b.y, a1);
      a2 = fmaf(kinv[4 * c + 2], b.z, a2);
      a3 = fmaf(kinv[4 * c + 3], b.w, a3);
    }
    part[half * kNMax + r] = (a0 + a1) + (a2 + a3);
  }
}

// The vectors of one env in shared memory.
struct Vecs {
  float *q, *x, *v, *rhs, *s, *xp, *part;
  float *l, *u, *z, *y, *rhov, *wgt, *wact, *bact, *lam, *av, *w;
};

enum Pass { kAdmmRhs, kAdmmStep, kPolishRhs, kPolishStep };

// Half a warp per horizon step k = 2 warp + lane / 16 (warps 0..4 for
// h = 10): lane l = lane % 16 owns the step's constraint rows j = k ms + l
// and k ms + l + 16 (those < ms), and for l < 12 its variable i = 12k + l.
// A *Step pass first takes v = K^-1 rhs from the two half-row sums in part
// (into v) and updates the step's iterates (ADMM: x, z, y; polish: xp,
// lam); every pass then forms the step's rhs for the next K^-1 product:
//   ADMM:   rhs = sigma x - q + A'(rho z - y)   (rounded to bf16 with round_rhs)
//   polish: rhs = -q + A'(wact (rho_pol bact - lam))
template <Pass kPass>
__device__ __forceinline__ void step_pass(const Vecs& V, const float* sA, int h, int ms,
                                          float sigma, float alpha, bool round_rhs) {
  constexpr bool kStep = kPass == kAdmmStep || kPass == kPolishStep;
  constexpr bool kPolish = kPass == kPolishRhs || kPass == kPolishStep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (2 * warp >= h) return;  // whole warps only: the __syncwarp below stay convergent
  const int l = lane & 15, k = 2 * warp + (lane >> 4);
  const bool on = k < h;
  const int i = k * kNu + l;
  if (kStep) {
    if (on && l < kNu) {
      const float v = V.part[i] + V.part[kNMax + i];
      V.v[i] = v;
      if (kPolish) V.xp[i] = v;
      else V.x[i] = alpha * v + (1.f - alpha) * V.x[i];
    }
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = l + 16 * rr, j = k * ms + r;
      if (on && r < ms) {
        const float* a = sA + j * kNu;
        const float* vk = V.v + k * kNu;
        float av = 0.f;
#pragma unroll
        for (int c = 0; c < kNu; ++c) av = fmaf(a[c], vk[c], av);
        if (kPolish) {
          V.lam[j] = V.lam[j] + kRhoPolish * ((av - V.bact[j]) * V.wact[j]);
        } else {
          const float zt = alpha * av + (1.f - alpha) * V.z[j];
          const float zn = fminf(fmaxf(zt + V.y[j] / V.rhov[j], V.l[j]), V.u[j]);
          V.y[j] = V.y[j] + V.rhov[j] * (zt - zn);
          V.z[j] = zn;
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = l + 16 * rr, j = k * ms + r;
    if (on && r < ms)
      V.w[j] = kPolish ? V.wact[j] * (kRhoPolish * V.bact[j] - V.lam[j])
                       : V.rhov[j] * V.z[j] - V.y[j];
  }
  __syncwarp();
  if (on && l < kNu) {
    // (A'w)_i over the step's rows, four partial sums (a short chain)
    const float* a = sA + k * ms * kNu + l;
    const float* w = V.w + k * ms;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int r = 0;
    for (; r + 4 <= ms; r += 4) {
      a0 = fmaf(a[r * kNu], w[r], a0);
      a1 = fmaf(a[(r + 1) * kNu], w[r + 1], a1);
      a2 = fmaf(a[(r + 2) * kNu], w[r + 2], a2);
      a3 = fmaf(a[(r + 3) * kNu], w[r + 3], a3);
    }
    for (; r < ms; ++r) a0 = fmaf(a[r * kNu], w[r], a0);
    const float r_i = (kPolish ? -V.q[i] : sigma * V.x[i] - V.q[i]) + ((a0 + a1) + (a2 + a3));
    V.rhs[i] = !kPolish && round_rhs ? bf16_rn(r_i) : r_i;
  }
}

// iters steps of x_{k+1} = step(K^-1 rhs_k) from the rhs of the current
// iterates, with K^-1 in registers: two barriers per step.
template <Pass kRhs, Pass kStep>
__device__ __forceinline__ void kinv_iterations(const float (&kinv)[kHalf], const Vecs& V,
                                const float* sA, int h, int ms, int n, int iters,
                                float sigma, float alpha, bool round_rhs) {
  step_pass<kRhs>(V, sA, h, ms, sigma, alpha, round_rhs);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    kinv_matvec(kinv, V.rhs, V.part, n);
    __syncthreads();
    step_pass<kStep>(V, sA, h, ms, sigma, alpha, round_rhs);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
qp_admm_kernel(const float* __restrict__ P_all, const float* __restrict__ Ah_all,
               const float* __restrict__ q_all, const float* __restrict__ l_all,
               const float* __restrict__ u_all, const float* __restrict__ x0_all,
               const float* __restrict__ z0_all, const float* __restrict__ y0_all,
               float* __restrict__ x_out, float* __restrict__ z_out,
               float* __restrict__ y_out, int h, int ms, float rho, float sigma,
               float alpha, const float* __restrict__ rho_env,
               const float* __restrict__ sigma_env, const float* __restrict__ alpha_env,
               int n_iters, int n_phases, int ns_iters, int polish, int bf16_iters,
               int bf16_matvec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Km = smem;
  float* Xm = Km + kMat;
  float* Tm = Xm + kMat;
  float* sA = Tm + kMat;
  float* vn = sA + kHMax * kMsMax * kNu;
  float* vm = vn + kVecN * kNMax;
  Vecs V;
  V.q = vn;
  V.x = V.q + kNMax;
  V.v = V.x + kNMax;
  V.rhs = V.v + kNMax;
  V.s = V.rhs + kNMax;
  V.xp = V.s + kNMax;
  V.part = V.xp + kNMax;  // two halves
  V.l = vm;
  V.u = V.l + kMMax;
  V.z = V.u + kMMax;
  V.y = V.z + kMMax;
  V.rhov = V.y + kMMax;
  V.wgt = V.rhov + kMMax;
  V.wact = V.wgt + kMMax;
  V.bact = V.wact + kMMax;
  V.lam = V.bact + kMMax;
  V.av = V.lam + kMMax;
  V.w = V.av + kMMax;
  float* red = vm + kVecM * kMMax;
  float *q = V.q, *x = V.x, *v = V.v, *rhs = V.rhs, *xp = V.xp;
  float *l = V.l, *u = V.u, *z = V.z, *y = V.y, *rhov = V.rhov, *av = V.av;

  const int tid = threadIdx.x;
  const int n = h * kNu;
  const int M = h * ms;
  const long env = blockIdx.x;
  const float* P = P_all + env * n * n;
  if (rho_env != nullptr) rho = rho_env[env];
  if (sigma_env != nullptr) sigma = sigma_env[env];
  if (alpha_env != nullptr) alpha = alpha_env[env];

  static_assert(kSmemFloats % 4 == 0, "shared memory zeroed as float4");
  for (int i = tid; i < kSmemFloats / 4; i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < M * kNu; i += kThreads) sA[i] = Ah_all[env * M * kNu + i];
  for (int i = tid; i < n; i += kThreads) {
    q[i] = q_all[env * n + i];
    x[i] = x0_all[env * n + i];
  }
  for (int j = tid; j < M; j += kThreads) {
    l[j] = l_all[env * M + j];
    u[j] = u_all[env * M + j];
    z[j] = z0_all[env * M + j];
    y[j] = y0_all[env * M + j];
  }
  __syncthreads();

  float kinv[kHalf];
  const int iters_per_phase = n_iters / n_phases > 1 ? n_iters / n_phases : 1;
  for (int p = 0; p < n_phases; ++p) {
    for (int j = tid; j < M; j += kThreads)
      rhov[j] = (u[j] - l[j]) < 1e-6f ? rho * kEqBoost : rho;
    __syncthreads();
    build_kkt(P, sA, rhov, Km, n, ms, sigma);
    ns_inverse(Km, Xm, Tm, V.s, red, n, ns_iters, bf16_iters);
    load_kinv(Xm, V.s, kinv, n, bf16_matvec != 0);
    kinv_iterations<kAdmmRhs, kAdmmStep>(kinv, V, sA, h, ms, n, iters_per_phase, sigma,
                                         alpha, bf16_matvec != 0);

    if (p < n_phases - 1) {
      // OSQP rho re-pick from the scaled primal / dual residual ratio
      for (int j = tid; j < M; j += kThreads) av[j] = row_dot(sA, x, j, ms);
      for (int i = tid; i < n; i += kThreads) rhs[i] = col_dot(sA, y, i, ms);
      matvec_global(P, x, v, n);  // v = P x
      __syncthreads();
      float m_avz = 0.f, m_av = 0.f, m_z = 0.f;
      for (int j = tid; j < M; j += kThreads) {
        m_avz = fmaxf(m_avz, fabsf(av[j] - z[j]));
        m_av = fmaxf(m_av, fabsf(av[j]));
        m_z = fmaxf(m_z, fabsf(z[j]));
      }
      float m_res = 0.f, m_px = 0.f, m_aty = 0.f, m_q = 0.f;
      for (int i = tid; i < n; i += kThreads) {
        m_res = fmaxf(m_res, fabsf(v[i] + q[i] + rhs[i]));
        m_px = fmaxf(m_px, fabsf(v[i]));
        m_aty = fmaxf(m_aty, fabsf(rhs[i]));
        m_q = fmaxf(m_q, fabsf(q[i]));
      }
      m_avz = block_max(m_avz, red);
      m_av = block_max(m_av, red);
      m_z = block_max(m_z, red);
      m_res = block_max(m_res, red);
      m_px = block_max(m_px, red);
      m_aty = block_max(m_aty, red);
      m_q = block_max(m_q, red);
      const float rp = m_avz / (fmaxf(m_av, m_z) + kEps);
      const float rd = m_res / (fmaxf(fmaxf(m_px, m_aty), m_q) + kEps);
      rho = fminf(fmaxf(rho * sqrtf(rp / (rd + kEps)), 1e-2f), 1e2f);
      __syncthreads();
    }
  }

  if (polish) {
    const float tol = 1e-5f;
    for (int j = tid; j < M; j += kThreads) {
      const float act = (z[j] <= l[j] + tol || z[j] >= u[j] - tol) ? 1.f : 0.f;
      V.wact[j] = act;
      V.bact[j] = fminf(fmaxf(z[j], l[j]), u[j]);
      V.wgt[j] = kRhoPolish * act;
      V.lam[j] = 0.f;
    }
    __syncthreads();
    build_kkt(P, sA, V.wgt, Km, n, ms, sigma);
    ns_inverse(Km, Xm, Tm, V.s, red, n, ns_iters, bf16_iters);
    load_kinv(Xm, V.s, kinv, n, false);  // the polish's K^-1 product stays f32
    kinv_iterations<kPolishRhs, kPolishStep>(kinv, V, sA, h, ms, n, 3, sigma, alpha, false);
    // exact-penalty merit 0.5 v'Pv + q'v + 1e4 sum|Av - clip(Av)| of x and xp
    matvec_global(P, x, v, n);
    matvec_global(P, xp, rhs, n);
    __syncthreads();
    float vpv = 0.f, qv = 0.f, ppv = 0.f, qpv = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      vpv += x[i] * v[i];
      qv += q[i] * x[i];
      ppv += xp[i] * rhs[i];
      qpv += q[i] * xp[i];
    }
    float viol = 0.f, viol_p = 0.f;
    for (int j = tid; j < M; j += kThreads) {
      const float a = row_dot(sA, x, j, ms);
      const float ap = row_dot(sA, xp, j, ms);
      av[j] = ap;
      viol += fabsf(a - fminf(fmaxf(a, l[j]), u[j]));
      viol_p += fabsf(ap - fminf(fmaxf(ap, l[j]), u[j]));
    }
    const float merit_x =
        0.5f * block_sum(vpv, red) + block_sum(qv, red) + 1e4f * block_sum(viol, red);
    const float merit_p =
        0.5f * block_sum(ppv, red) + block_sum(qpv, red) + 1e4f * block_sum(viol_p, red);
    if (merit_p <= merit_x) {
      for (int i = tid; i < n; i += kThreads) x[i] = xp[i];
      for (int j = tid; j < M; j += kThreads) z[j] = fminf(fmaxf(av[j], l[j]), u[j]);
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) x_out[env * n + i] = x[i];
  for (int j = tid; j < M; j += kThreads) {
    z_out[env * M + j] = z[j];
    y_out[env * M + j] = y[j];
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t; 0 = the legacy default stream) of
// device `device`. rho_env, sigma_env, alpha_env: null, or n_env floats on
// the device that replace rho, sigma, alpha per env. bf16_iters >= 0: NS
// steps, from the first, with bf16 operands; bf16_matvec: the ADMM steps'
// K^-1 product from bf16 operands. Returns the cudaError_t of the launch (0
// = success); the kernel allocates nothing and does not synchronize.
extern "C" int qp_admm_solve(const float* P, const float* Ah, const float* q,
                             const float* l, const float* u, const float* x0,
                             const float* z0, const float* y0, float* x, float* z,
                             float* y, int n_env, int h, int ms, float rho,
                             float sigma, float alpha, const float* rho_env,
                             const float* sigma_env, const float* alpha_env,
                             int n_iters, int n_phases, int ns_iters, int polish,
                             int bf16_iters, int bf16_matvec, int device, void* stream) {
  if (h < 1 || h > kHMax || ms < 1 || ms > kMsMax || n_phases < 1 || n_iters < 0 ||
      ns_iters < 0 || bf16_iters < 0 || n_env < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(qp_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qp_admm_kernel<<<n_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, Ah, q, l, u, x0, z0, y0, x, z, y, h, ms, rho, sigma, alpha, rho_env, sigma_env,
      alpha_env, n_iters, n_phases, ns_iters, polish, bf16_iters, bf16_matvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qp_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Modified-Ruiz equilibration of a batch of MPC QPs, with the scaled warm
// start, for Hopper (sm_90a): the stage qp.ruiz of ops/qp.py::solve_qp.
//
// Replaces no TPU kernel. The JAX package's Ruiz is plain jnp
// (biped_mpc_py_tpu/ops/qp.py:445, ruiz_equilibrate), and so is the plain
// version here (ops/qp.py::ruiz_equilibrate and scaled_warm_start), which
// stays the CPU path and the yardstick of the card tests. On the card the
// plain version forms the full-batch product |P| D as separate ATen kernels
// twice an iteration and reduces it: some 20 round trips over the (N, n, n)
// batch a solve, the largest stage of the batched tick. This kernel reads
// each env's P once and writes the scaled P once.
//
// What it computes, per env (n = 12 h variables, h steps of m rows, A the
// (m, 12) rows of every step):
//   D = 1 (n), E = 1 (h x m), c = 1; iters times:
//     colP_j  = (c D_j) max_i |P_ij| D_i
//     colA_kj = max_i (E_ki |A_ij|) D_kj
//     D'      = D / sqrt(max(colP, colA, 1e-8))
//     E'_ki   = min(E_ki / sqrt(max(max_j (E_ki |A_ij|) D_kj, 1e-8)), 1e6)
//     gamma   = 1 / max(mean_j (c D'_j) max_i |P_ij| D'_i, 1e-8)
//     D, E, c = D', E', c gamma
//   Ph = c D P D, qh = c D q, Ah_k = E_k A D_k, lh = E l, uh = E u; the
//   warm start x0 = controls / D, z0 = E z, y0 = c y / E (zeros without one).
// The f32 products keep the plain version's order ((c D_j) colmax_j,
// ((c P_ij) D_i) D_j, ...) and no product is contracted into an FMA with a
// sum. Maxima propagate NaN, as torch.amax and torch.maximum do. With bf16
// norms (MpcConfig.ruiz_bf16_norms, a template flag) |P| and D are rounded
// to bf16 (nearest even), each product is rounded to bf16 (mul.bf16x2) and
// the column maximum is taken in bf16 before it returns to f32: maxima are
// exact, so the column norms equal the plain version's for the same D bit
// for bit. The one sum, the n-term mean behind gamma, is added in the order
// of torch.mean over the last axis of a contiguous (N, n) f32 tensor on the
// card for n <= 128 (ATen's reduce kernel, not vectorized there: `lanes`
// threads a row, each folding the elements lane, lane + lanes, ... into 4
// accumulators by turns and adding them in order, then a tree over the
// lanes, times the f32 factor 1/n), so on the card the kernel and the
// plain version agree bit for bit at the repo's shapes (n = 60, 84, 120);
// on the CPU torch.mean divides a sum taken in another order. That order is
// ATen's as of torch 2.11.0 (CUDA 12.8), the version it was matched against
// on the card: a torch whose reduce kernel sizes its blocks otherwise adds
// the mean in another order, and the card tests' 0-ulp comparison
// (tests/test_torch_cuda.py::test_ruiz_kernel_matches_plain) then fails by a
// few ulps, from c on, while the kernel is still right.
//
// What bounds it on this card: bytes. At 4096 envs, h = 10, m = 24 a solve
// moves P in and Ph out (2 x 235.9 MB), Ah out (47.2 MB), A, q, l, u in and
// qh, lh, uh, D, E, c out (~30 MB) and the warm start in and out (19.7 MB):
// ~569 MB, 0.170 ms at 3.35 TB/s. The arithmetic, ~0.16 M max-products an
// env (iters + 1 column passes over n^2), runs out of shared memory; its 10
// iterations are chains of dependent phases behind barriers, and they, not
// the bytes, take most of the time (PERF.md: without its iterations the
// kernel moves its bytes at ~82% of the bound).
//
// What the design does about it:
//  - One CTA of 256 threads per env. One thread issues a 1-D bulk copy
//    (cp.async.bulk, TMA) of the env's contiguous P (57.6 KB at n = 120) into
//    shared memory, completing on an mbarrier, while the other threads load
//    A, set D and E and take the first E |A| maxima. ~70 KB a CTA: three
//    CTAs share an SM, so one CTA's load and stores overlap another's passes.
//  - Every iteration runs out of shared memory and registers. A column pass
//    gives each warp a group of rows and each lane 4 neighbouring columns
//    (a float4 of P: neighbouring lanes read neighbouring addresses, no bank
//    conflicts), keeps the 4 running maxima in registers and leaves a
//    partial maximum per row group; one thread per column reduces the
//    groups. With bf16 norms |P| is rounded to bf16 pairs as it is read
//    (cvt.rn.bf16x2), so no second copy of P takes shared memory. The plain
//    version's second pass of an iteration, over the new D, is the next
//    iteration's first: iters + 1 passes, not 2 iters.
//  - An iteration's time is its chain of dependent phases: pass, norms,
//    mean, new D. The A-side norms over (h, m, 12) are kept off that chain: the
//    column maxima of E |A| are taken in parts by the threads past n while
//    the others reduce the norms, the row norms (the new E) by the warps
//    past the column warps while those form the new D.
//  - Then Ph (a row a warp) and Ah (a row of a step a thread) are written
//    once as coalesced 16-byte stores, and qh, lh, uh, D, E, c and the warm
//    start once as coalesced 4-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNu = 12;  // controls per horizon step
constexpr int kColParts = 4;  // threads a float4 of columns of E |A| takes, at most

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }

// Lanes a column pass gives one row group: the power of two that holds the
// n / 4 float4 columns of a row.
__host__ __device__ constexpr int group_lanes(int n) {
  int lanes = 1;
  while (lanes < n / 4) lanes *= 2;
  return lanes;
}

// Offsets, in floats, of the shared arrays; every array starts on 16 bytes.
struct Layout {
  int P, A, D0, D1, Db, E0, E1, norm, part, colA, terms, mean, bar, total;
};

__host__ __device__ inline Layout layout(int h, int m) {
  const int n = kNu * h;
  Layout s;
  int o = 0;
  s.P = o;      o += n * n;                // n = 12 h: n^2 floats are 16-byte multiples
  s.A = o;      o += up4(kNu * m);
  s.D0 = o;     o += up4(n);
  s.D1 = o;     o += up4(n);
  s.Db = o;     o += up4(n);               // the D of a pass as bf16 pairs (d, d)
  s.E0 = o;     o += up4(h * m);
  s.E1 = o;     o += up4(h * m);
  s.norm = o;   o += up4(n);
  s.part = o;   o += 4 * kThreads;         // row groups x n <= 4 x threads
  s.colA = o;   o += kColParts * up4(n);    // partial maxima of E |A| by column
  s.terms = o;  o += up4(n);               // the terms of the mean
  s.mean = o;   o += 4;                    // the mean
  s.bar = o;    o += 4;                    // the mbarrier (8 bytes)
  s.total = o;
  return s;
}

struct Args {
  const float* P;   // (N, n, n)
  const float* q;   // (N, n)
  const float* A;   // (N, m, 12)
  const float* l;   // (N, h, m)
  const float* u;   // (N, h, m)
  const float* wx;  // warm controls (N, h, 12), or null (cold start)
  const float* wz;  // warm z (N, h, m), or null
  const float* wy;  // warm y (N, h, m), or null
  float* Ph;
  float* qh;
  float* Ah;        // (N, h, m, 12)
  float* lh;
  float* uh;
  float* D;         // (N, h, 12)
  float* E;         // (N, h, m)
  float* c;         // (N,)
  float* x0;
  float* z0;
  float* y0;
  int h, m, iters;
  int lanes;        // threads a row of torch.mean's reduction (mean_lanes)
};

// max and min that return NaN where either operand is NaN (torch.maximum,
// torch.amax, torch.clamp), not the other operand as fmaxf does.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The env's P, bytes long, into shared memory by one bulk copy that
// completes the transaction count of the mbarrier bar (one arrival).
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// One column pass: part[g n + j] = max over the rows i of group g of
// |P_ij| D_i (bf16: of bf16(|P_ij|) bf16(D_i) rounded to bf16, |P| rounded
// as it is read). Lane q of a group holds columns 4q..4q+3; groups with no
// rows leave zeros.
template <bool kBf16>
__device__ __forceinline__ void column_pass(const float* sP, const float* D,
                                            const __nv_bfloat162* Db, float* part, int n) {
  const int nq = n / 4, lanes = group_lanes(n), groups = kThreads / lanes;
  const int rows = (n + groups - 1) / groups;
  const int q = threadIdx.x % lanes, g = threadIdx.x / lanes;
  if (q >= nq) return;
  const int i0 = min(g * rows, n), i1 = min(i0 + rows, n);
  const float4* p = reinterpret_cast<const float4*>(sP) + i0 * nq + q;
  float4 r;
  if (kBf16) {
    __nv_bfloat162 m0 = __float2bfloat162_rn(0.f), m1 = m0;
#pragma unroll 4
    for (int i = i0; i < i1; ++i, p += nq) {
      const float4 v = *p;
      const __nv_bfloat162 d = Db[i];
      m0 = __hmax2_nan(m0, __hmul2(__floats2bfloat162_rn(fabsf(v.x), fabsf(v.y)), d));
      m1 = __hmax2_nan(m1, __hmul2(__floats2bfloat162_rn(fabsf(v.z), fabsf(v.w)), d));
    }
    r = make_float4(__low2float(m0), __high2float(m0), __low2float(m1), __high2float(m1));
  } else {
    r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = i0; i < i1; ++i, p += nq) {
      const float4 v = *p;
      const float d = D[i];
      r.x = max_nan(r.x, fabsf(v.x) * d);
      r.y = max_nan(r.y, fabsf(v.y) * d);
      r.z = max_nan(r.z, fabsf(v.z) * d);
      r.w = max_nan(r.w, fabsf(v.w) * d);
    }
  }
  reinterpret_cast<float4*>(part + g * n)[q] = r;
}

// The column norm of column j from the row groups' partial maxima.
__device__ __forceinline__ float group_max(const float* part, int n, int j) {
  const int groups = kThreads / group_lanes(n);
  float v = part[j];
  for (int g = 1; g < groups; ++g) v = max_nan(v, part[g * n + j]);
  return v;
}

// The sum of the n terms of a row as torch.mean's reduction on the card
// adds them (ATen's reduce kernel as of torch 2.11.0: its block sizing picks
// `lanes`, mean_lanes below), computed by the 32 lanes of one warp (every
// lane gets it). Each
// of `lanes` row threads takes the elements t, t + lanes, ... (at most 4:
// n <= 4 lanes), each into its own accumulator from 0, and adds the 4
// accumulators in order; threads past the warp's 32 are added into it by
// halving (ATen's shared-memory steps), then the warp adds by shuffles down
// at offsets lanes / 2, ..., 2, 1 (ATen's block_x_reduce).
__device__ float torch_row_sum(const float* terms, int n, int lanes) {
  const int lane = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = lane + 32 * r;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t < lanes && t + k * lanes < n) acc[k] = __fadd_rn(acc[k], terms[t + k * lanes]);
    v[r] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
  if (lanes > 64) {
    v[0] = __fadd_rn(v[0], v[2]);
    v[1] = __fadd_rn(v[1], v[3]);
  }
  if (lanes > 32) v[0] = __fadd_rn(v[0], v[1]);
  float x = v[0];
  for (int off = min(lanes, 32) / 2; off >= 1; off /= 2)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return __shfl_sync(0xffffffffu, x, 0);
}

// c after one iteration: c gamma, gamma = 1 / max(mean of the terms, 1e-8),
// the mean the sum times the f32 factor 1/n (torch.mean's). One warp.
__device__ __forceinline__ float next_c(float c, const float* terms, int n, int lanes) {
  const float mean = __fmul_rn(torch_row_sum(terms, n, lanes), 1.f / static_cast<float>(n));
  return c * __frcp_rn(max_nan(mean, 1e-8f));
}

// The partial maxima of E |A| by column: for each float4 group f of 4
// columns of step k (threads n.. of the CTA, `parts` threads a group), part
// p takes max over the rows i = p, p + parts, ... of E_ki |A_ij| into
// colA[p n + j].
__device__ __forceinline__ void colA_parts(const float* E, const float* sA, float* colA, int n,
                                           int m, int parts) {
  const int t = static_cast<int>(threadIdx.x) - n, p = t % parts;
  if (t < 0) return;
  for (int f = t / parts; f < n / 4; f += (kThreads - n) / parts) {
    const int k = f / 3, jj = 4 * (f - 3 * k);  // a step's 12 columns in 3 float4
    const float* Ek = E + k * m;
    float4 mx = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int i = p; i < m; i += parts) {
      const float e = Ek[i];
      const float4 av = *reinterpret_cast<const float4*>(sA + i * kNu + jj);
      mx.x = max_nan(mx.x, e * fabsf(av.x));
      mx.y = max_nan(mx.y, e * fabsf(av.y));
      mx.z = max_nan(mx.z, e * fabsf(av.z));
      mx.w = max_nan(mx.w, e * fabsf(av.w));
    }
    *reinterpret_cast<float4*>(colA + p * n + k * kNu + jj) = mx;
  }
}

// One iteration t takes D_t, E_t, c_t and the norms of D_t to D_{t+1},
// E_{t+1}, c_{t+1} in three phases, a barrier after each. Only the chain
// pass -> norms and terms -> mean -> D_{t+1} -> pass is sequential; the A
// side runs beside it:
//   A  the column warps: c_t from the last iteration's terms (warp 0 keeps
//      it in shared memory), then D_{t+1} of 4 columns a thread from colP
//      and colA (its partial maxima, over E_t, made in the last phase C,
//      times D_t); the other warps, a row (k, i) a thread: E_{t+1} from the
//      row norms of E_t |A| D_t;
//   B  the column pass over D_{t+1};
//   C  threads j < n: the norms of D_{t+1} and the mean's terms; threads
//      n..: the partial maxima of E_{t+1} |A| by column, for the next A.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 3) ruiz_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  const int h = a.h, m = a.m, n = kNu * h, nq = n / 4, hm = h * m, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int colw = (nq + 31) & ~31;  // threads of the column warps
  // threads a float4 group of E |A| columns takes: as many as threads n.. hold
  const int parts = nq * kColParts <= kThreads - n ? kColParts
                    : nq * 2 <= kThreads - n       ? 2
                                                   : 1;
  const Layout s = layout(h, m);
  const long env = blockIdx.x;
  float* sP = smem + s.P;
  float* sA = smem + s.A;
  __nv_bfloat162* Db = reinterpret_cast<__nv_bfloat162*>(smem + s.Db);
  float* norm = smem + s.norm;
  float* part = smem + s.part;
  float* colA = smem + s.colA;
  float* terms = smem + s.terms;
  float* cs = smem + s.mean;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + s.bar);

  if (tid == 0) {
    bulk_load(sP, a.P + env * n * n, n * n * sizeof(float), bar);
    *cs = 1.f;
  }
  float *D = smem + s.D0, *Dn = smem + s.D1, *E = smem + s.E0, *En = smem + s.E1;
  for (int i = tid; i < kNu * m; i += kThreads) sA[i] = a.A[env * kNu * m + i];
  for (int j = tid; j < n; j += kThreads) {
    D[j] = 1.f;
    Db[j] = __float2bfloat162_rn(1.f);
  }
  for (int r = tid; r < hm; r += kThreads) E[r] = 1.f;
  __syncthreads();  // the mbarrier's init, sA and E before any thread reads them
  colA_parts(E, sA, colA, n, m, parts);
  bulk_wait(bar);
  column_pass<kBf16>(sP, D, Db, part, n);
  __syncthreads();
  if (tid < n) norm[tid] = group_max(part, n, tid);
  __syncthreads();

  float c = 1.f;  // c_t, kept by the column warps
  for (int it = 0; it < a.iters; ++it) {
    if (tid < colw) {
      if (it > 0) c = next_c(c, terms, n, a.lanes);
      if (tid == 0) *cs = c;
      if (tid < nq) {
        const int j = 4 * tid;
        float4 ca = *reinterpret_cast<const float4*>(colA + j);
        for (int p = 1; p < parts; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(colA + p * n + j);
          ca = make_float4(max_nan(ca.x, v.x), max_nan(ca.y, v.y), max_nan(ca.z, v.z),
                           max_nan(ca.w, v.w));
        }
        const float4 d = *reinterpret_cast<const float4*>(D + j);
        const float4 nm = *reinterpret_cast<const float4*>(norm + j);
        const float cav[4] = {ca.x * d.x, ca.y * d.y, ca.z * d.z, ca.w * d.w};
        const float cp[4] = {(c * d.x) * nm.x, (c * d.y) * nm.y, (c * d.z) * nm.z,
                             (c * d.w) * nm.w};
        const float dv[4] = {d.x, d.y, d.z, d.w};
        float out[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          out[u] = dv[u] * __frcp_rn(__fsqrt_rn(max_nan(max_nan(cp[u], cav[u]), 1e-8f)));
          if (kBf16) Db[j + u] = __float2bfloat162_rn(out[u]);
        }
        *reinterpret_cast<float4*>(Dn + j) = make_float4(out[0], out[1], out[2], out[3]);
      }
    } else {
      for (int r = tid - colw; r < hm; r += kThreads - colw) {
        const int k = r / m, i = r - k * m;
        const float e = E[r];
        const float4* Ai = reinterpret_cast<const float4*>(sA + i * kNu);
        const float4* Dk = reinterpret_cast<const float4*>(D + k * kNu);
        float row = 0.f;
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const float4 av = Ai[u], dv = Dk[u];
          row = max_nan(row, (e * fabsf(av.x)) * dv.x);
          row = max_nan(row, (e * fabsf(av.y)) * dv.y);
          row = max_nan(row, (e * fabsf(av.z)) * dv.z);
          row = max_nan(row, (e * fabsf(av.w)) * dv.w);
        }
        En[r] = min_nan(e * __frcp_rn(__fsqrt_rn(max_nan(row, 1e-8f))), 1e6f);
      }
    }
    __syncthreads();
    column_pass<kBf16>(sP, Dn, Db, part, n);
    __syncthreads();
    if (tid < n) {
      const float nj = group_max(part, n, tid);
      norm[tid] = nj;
      terms[tid] = (*cs * Dn[tid]) * nj;
    } else {
      colA_parts(En, sA, colA, n, m, parts);
    }
    __syncthreads();
    float* t = D;
    D = Dn;
    Dn = t;
    t = E;
    E = En;
    En = t;
  }
  if (a.iters > 0 && tid < 32) {
    c = next_c(c, terms, n, a.lanes);
    if (tid == 0) *cs = c;
  }
  __syncthreads();
  c = *cs;

  // Ph = ((c P_ij) D_i) D_j, a row a warp, and Ah = (A_ij E_ki) D_kj, a row
  // (k, i) a thread, as 16-byte stores
  for (int i = warp; i < n; i += kThreads / 32) {
    const float4* P4 = reinterpret_cast<const float4*>(sP + i * n);
    float4* out = reinterpret_cast<float4*>(a.Ph + (env * n + i) * n);
    const float di = D[i];
    for (int q = lane; q < nq; q += 32) {
      const float4 p = P4[q], dj = *reinterpret_cast<const float4*>(D + 4 * q);
      out[q] = make_float4(((c * p.x) * di) * dj.x, ((c * p.y) * di) * dj.y,
                           ((c * p.z) * di) * dj.z, ((c * p.w) * di) * dj.w);
    }
  }
  for (int r = tid; r < hm; r += kThreads) {
    const int k = r / m, i = r - k * m;
    const float4* Ai = reinterpret_cast<const float4*>(sA + i * kNu);
    const float4* Dk = reinterpret_cast<const float4*>(D + k * kNu);
    float4* ah = reinterpret_cast<float4*>(a.Ah + (env * hm + r) * kNu);
    const float e = E[r];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float4 av = Ai[u], dv = Dk[u];
      ah[u] = make_float4((av.x * e) * dv.x, (av.y * e) * dv.y, (av.z * e) * dv.z,
                          (av.w * e) * dv.w);
    }
  }
  for (int j = tid; j < n; j += kThreads) {
    const long g = env * n + j;
    a.qh[g] = (c * D[j]) * a.q[g];
    a.D[g] = D[j];
    a.x0[g] = a.wx ? a.wx[g] / D[j] : 0.f;
  }
  for (int r = tid; r < hm; r += kThreads) {
    const long g = env * hm + r;
    const float e = E[r];
    a.lh[g] = e * a.l[g];
    a.uh[g] = e * a.u[g];
    a.E[g] = e;
    a.z0[g] = a.wz ? e * a.wz[g] : 0.f;
    a.y0[g] = a.wy ? (c * a.wy[g]) / e : 0.f;
  }
  if (tid == 0) a.c[env] = c;
}

int last_pow2(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The threads a row that torch.mean's reduction over the last axis of a
// contiguous (n_env, n) f32 tensor takes on the card (ATen's
// ReduceConfig::set_block_dimension, 512 threads a block, as of torch
// 2.11.0), for n <= 128.
int mean_lanes(int n_env, int n) {
  const int max_threads = 512;
  const int dim0 = n < max_threads ? last_pow2(n) : max_threads;
  const int dim1 = n_env < max_threads ? last_pow2(n_env) : max_threads;
  int width = dim0 < 32 ? dim0 : 32;
  const int height = dim1 < max_threads / width ? dim1 : max_threads / width;
  width = dim0 < max_threads / height ? dim0 : max_threads / height;
  return n > 128 ? 128 : width;  // past 128 ATen vectorizes: another order, not emulated
}

}  // namespace

// Shared memory, in bytes, of one CTA for h steps of m rows.
extern "C" int ruiz_smem_bytes(int h, int m, int bf16_norms) {
  return layout(h, m).total * static_cast<int>(sizeof(float));
}

// Launch on `stream` (a cudaStream_t) of device `device`: one CTA per env.
// P must be 16-byte aligned (the bulk copy); wx, wz, wy all null (a cold
// start) or all given. Returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue for a shape the kernel does
// not take, P past the shared memory a block may use included. The kernel
// allocates nothing and does not synchronize.
extern "C" int ruiz_scale(const float* P, const float* q, const float* A, const float* l,
                          const float* u, const float* wx, const float* wz, const float* wy,
                          float* Ph, float* qh, float* Ah, float* lh, float* uh, float* D,
                          float* E, float* c, float* x0, float* z0, float* y0, int n_env,
                          int h, int m, int iters, int bf16_norms, int device, void* stream) {
  if (h < 1 || kNu * h >= kThreads || m < 1 || iters < 0 || n_env < 0 ||
      (wx == nullptr) != (wz == nullptr) ||
      (wx == nullptr) != (wy == nullptr) || reinterpret_cast<uintptr_t>(P) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = ruiz_smem_bytes(h, m, bf16_norms);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bf16_norms ? ruiz_kernel<true> : ruiz_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{P, q, A, l, u, wx, wz, wy, Ph, qh, Ah, lh, uh, D, E, c, x0, z0, y0,
                  h, m, iters, mean_lanes(n_env, kNu * h)};
  kernel<<<n_env, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ruiz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

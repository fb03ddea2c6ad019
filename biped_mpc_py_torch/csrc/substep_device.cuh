// Device code shared by the fused articulated kernels (substep.cu, tick.cu):
// the constant buffer's layout and the packed form a block stages it in, the
// staging of a block's mass-matrix inverses, small rotation and
// spatial-vector helpers, and substep(), one semi-implicit substep of one
// env on the two lanes that share it.
//
// substep() is the counterpart of the Pallas kernels' shared _substep
// (biped_mpc_py_tpu/ops/pallas/substep_kernel.py); see substep.cu for what
// it computes and what bounds it. Everything here has internal linkage: each
// kernel source includes it once and builds into its own library.
//
// The ground is a template parameter of substep(): Plane, the plane z = 0
// (the flat kernels, and the TPU kernels' only ground), or Field, one env's
// height field (substep.cu's substep_kernel<true>). The two share every
// line of the substep but the contact force at a toe or heel point, which
// each computes from the point's world position and velocity.
//
// The lane split. An env belongs to two neighbouring lanes of a warp (lane
// 2s and 2s + 1 hold slot s of the block's 16 envs), one per leg. A lane
// keeps its own leg's five joints (q, qd, tau, their cos and sin) and a copy
// of the base state (pos, quat, v_base). Per substep the lanes exchange, by
// __shfl_xor_sync(.., 1): the leg's root force (6 values) and the leg's
// joint right-hand sides (5 values). Each lane then forms the same
// right-hand side (16) and takes 8 rows of Minv times it: its own 5 joint
// rows and 3 of the 6 base rows (lane 0 the angular, lane 1 the linear),
// which the lanes exchange (3 values); then it integrates its copy of the
// base and its own joints. Measured against all 6 base rows on both lanes:
// the exchange is the faster by 5% of a tick.
//
// Why the two copies of the base cannot drift. They start from the same
// loads. Everything that updates them is computed by both lanes with the
// same instructions from values that are bit-equal on both: the base copy
// itself, and the exchanged quantities, which enter only as
// __fadd_rn(own, other) (an IEEE add is commutative, and the intrinsic is
// never contracted into a fused multiply-add with the operation that made
// `own`, which would round the two lanes differently) or as a select by the
// lane's leg that puts leg 0's values first on both lanes (a base
// acceleration is computed by one lane and is the same number on both).
// No other base arithmetic depends on the lane's leg. So lane 0's copy, the
// one that is written out, is also the one lane 1 computed its leg from.
// tests/test_torch_lane_split.py writes the same split out in plain torch
// and asserts the bit-equality after every substep.
//
// No lane leaves early: a lane past the batch's end works on the last env
// (a clamped index) and only its stores are guarded, so every lane reaches
// every shuffle and barrier.

#pragma once

#include <cuda_runtime.h>

namespace {

// constant buffer layout (ops/cuda/substep_kernel.py::model_constants)
constexpr int kOffJoint = 0;      // joint offsets, 10 x 3
constexpr int kOffContact = 30;   // contact points, 4 x 3 (toe, heel per foot)
constexpr int kOffI6 = 42;        // spatial inertias, 11 x 6 x 6 row-major
constexpr int kOffScalar = 438;   // k, d, mu, vslip^2, joint damping, limit k, limit d, g
constexpr int kOffLimits = 446;   // joint limits, 10 x [min, max]
constexpr int kNConst = 466;

// The model as a block stages it in shared memory, in 16-byte groups so that
// a lane reads a body in four 128-bit loads. A spatial inertia about the
// frame origin is [[I, m cx], [m cx', m 1]] (sim/spatial.py::
// spatial_inertia), so a body keeps the rotational block I (9), h = m c (3)
// and m (1), and I6 v = [I w + h x v ; m v + w x h]; its last three floats
// are the offset of the joint that carries it (zero for the torso).
constexpr int kSBody = 0;        // 11 bodies x 16: I (9), h (3), m, joint offset (3)
constexpr int kSContact = 176;   // 4 contact points x 4: xyz, pad
constexpr int kSLimits = 192;    // joint limits, 10 x [min, max]
constexpr int kSScalar = 212;    // the 8 scalars of kOffScalar
constexpr int kNStaged = 220;

constexpr int kThreads = 32;       // one warp per block
constexpr int kEnvsPerBlock = 16;  // two lanes per env
// An env's 16 x 16 Minv in shared memory starts every 260 floats: 16-byte
// aligned, and 260 mod 32 = 4 puts the four envs of a quarter warp (the unit
// of a 128-bit shared load) on four different 16-byte bank groups, where a
// stride of 256 would put them all on one.
constexpr int kMinvStride = 260;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the other lane's value (the env's other leg)
__device__ __forceinline__ float other_leg(float v) { return __shfl_xor_sync(0xffffffffu, v, 1); }

// own + other, the same bits on both lanes of the pair (see the note above)
__device__ __forceinline__ float pair_sum(float v) { return __fadd_rn(v, other_leg(v)); }

// Asynchronous copies global -> shared (cp.async): a lane starts its copies,
// async_commit() closes a group of them, async_wait<N>() returns when all
// but the lane's N newest groups have landed and the block has met, so that
// every lane sees every lane's copies.
__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncthreads();
}

// Start staging the model into S (kNStaged floats): the packed layout is a
// gather of the buffer, so each float is one 4-byte asynchronous copy from
// where the buffer has it and no lane waits on a load here; the pads are
// plain stores.
__device__ __forceinline__ void stage_model_async(float* __restrict__ S,
                                                  const float* __restrict__ consts) {
  for (int i = threadIdx.x; i < kNStaged; i += kThreads) {
    int src;
    if (i < kSContact) {
      const int b = i >> 4, k = i & 15, I6 = kOffI6 + 36 * b;
      if (k < 9) src = I6 + 6 * (k / 3) + k % 3;
      else if (k == 9) src = I6 + 2 * 6 + 4;  // m cx = [[0,-hz,hy],[hz,0,-hx],[-hy,hx,0]]
      else if (k == 10) src = I6 + 0 * 6 + 5;
      else if (k == 11) src = I6 + 1 * 6 + 3;
      else if (k == 12) src = I6 + 35;
      else src = b > 0 ? kOffJoint + 3 * (b - 1) + (k - 13) : -1;
    } else if (i < kSLimits) {
      const int k = i - kSContact;
      src = (k & 3) < 3 ? kOffContact + 3 * (k >> 2) + (k & 3) : -1;
    } else if (i < kSScalar) {
      src = kOffLimits + (i - kSLimits);
    } else {
      src = kOffScalar + (i - kSScalar);
    }
    if (src >= 0) async_copy4(S + i, consts + src); else S[i] = 0.f;
  }
}

// Start the asynchronous copy of the block's 16 Minv (envs e0 .. e0 + 15,
// clamped to the batch) from global memory into M at kMinvStride: 16 bytes a
// lane and request, neighbouring lanes on neighbouring addresses. It
// overlaps whatever the caller does until it waits for the group.
__device__ __forceinline__ void stage_minv_async(float* __restrict__ M,
                                                 const float* __restrict__ minv_in, int e0,
                                                 int n_env) {
  for (int i = threadIdx.x; i < kEnvsPerBlock * 64; i += kThreads) {
    const int slot = i >> 6, within = i & 63;
    const int e = min(e0 + slot, n_env - 1);
    const float* src = minv_in + 256 * static_cast<size_t>(e) + 4 * within;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(M + kMinvStride * slot + 4 * within));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  }
}

// joint axis (0 = x, 1 = y, 2 = z) at level l of a leg
__device__ __forceinline__ int axis_of(int l) { return l == 0 ? 2 : (l == 1 ? 0 : 1); }

// o = R_pc v for the rotation about coordinate axis ax by (c, s)
__device__ __forceinline__ void rot_pc(int ax, float c, float s, const float v[3], float o[3]) {
  if (ax == 2) {
    o[0] = c * v[0] - s * v[1]; o[1] = s * v[0] + c * v[1]; o[2] = v[2];
  } else if (ax == 0) {
    o[0] = v[0]; o[1] = c * v[1] - s * v[2]; o[2] = s * v[1] + c * v[2];
  } else {
    o[0] = c * v[0] + s * v[2]; o[1] = v[1]; o[2] = -s * v[0] + c * v[2];
  }
}

// o = R_pc^T v
__device__ __forceinline__ void rot_cp(int ax, float c, float s, const float v[3], float o[3]) {
  if (ax == 2) {
    o[0] = c * v[0] + s * v[1]; o[1] = -s * v[0] + c * v[1]; o[2] = v[2];
  } else if (ax == 0) {
    o[0] = v[0]; o[1] = c * v[1] + s * v[2]; o[2] = -s * v[1] + c * v[2];
  } else {
    o[0] = c * v[0] - s * v[2]; o[1] = v[1]; o[2] = s * v[0] + c * v[2];
  }
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// o += w x (s e_ax): the cross product with a vector along a coordinate axis
__device__ __forceinline__ void add_cross_axis(int ax, const float w[3], float s, float o[3]) {
  if (ax == 2) {
    o[0] += w[1] * s; o[1] -= w[0] * s;
  } else if (ax == 0) {
    o[1] += w[2] * s; o[2] -= w[1] * s;
  } else {
    o[0] -= w[2] * s; o[2] += w[0] * s;
  }
}

// Rw <- Rw R_pc, row by row
__device__ __forceinline__ void rotate_frame(int ax, float c, float s, float Rw[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float row[3];
    rot_cp(ax, c, s, Rw[i], row);
    Rw[i][0] = row[0]; Rw[i][1] = row[1]; Rw[i][2] = row[2];
  }
}

// motion vector parent -> child coordinates: [R' w ; R' (v - off x w)]
__device__ __forceinline__ void motion_to_child(int ax, float c, float s, const float off[3],
                                                float m[6]) {
  float t[3], d[3], w[3];
  cross3(off, &m[0], t);
  d[0] = m[3] - t[0]; d[1] = m[4] - t[1]; d[2] = m[5] - t[2];
  rot_cp(ax, c, s, &m[0], w);
  rot_cp(ax, c, s, d, &m[3]);
  m[0] = w[0]; m[1] = w[1]; m[2] = w[2];
}

// force vector child -> parent coordinates: [R n + off x (R f) ; R f]
__device__ __forceinline__ void force_to_parent(int ax, float c, float s, const float off[3],
                                                float f[6]) {
  float fa[3], na[3], t[3];
  rot_pc(ax, c, s, &f[3], fa);
  rot_pc(ax, c, s, &f[0], na);
  cross3(off, fa, t);
  f[0] = na[0] + t[0]; f[1] = na[1] + t[1]; f[2] = na[2] + t[2];
  f[3] = fa[0]; f[4] = fa[1]; f[5] = fa[2];
}

// spatial force cross product v x* f
__device__ __forceinline__ void crf(const float v[6], const float f[6], float o[6]) {
  float a[3], b[3];
  cross3(&v[0], &f[0], a);
  cross3(&v[3], &f[3], b);
  o[0] = a[0] + b[0]; o[1] = a[1] + b[1]; o[2] = a[2] + b[2];
  cross3(&v[0], &f[3], &o[3]);
}

// A staged body: b0 = I00 I01 I02 I10, b1 = I11 I12 I20 I21, b2 = I22 hx hy hz,
// b3 = m and the joint offset.
struct Body {
  float4 b0, b1, b2, b3;
};

__device__ __forceinline__ Body load_body(const float* p) {
  return Body{ld4(p), ld4(p + 4), ld4(p + 8), ld4(p + 12)};
}

// o = I6 v = [I w + h x vl ; m vl + w x h]
__device__ __forceinline__ void inertia_apply(const Body& B, const float v[6], float o[6]) {
  const float h[3] = {B.b2.y, B.b2.z, B.b2.w};
  float hv[3], wh[3];
  cross3(h, &v[3], hv);
  cross3(&v[0], h, wh);
  o[0] = B.b0.x * v[0] + B.b0.y * v[1] + B.b0.z * v[2] + hv[0];
  o[1] = B.b0.w * v[0] + B.b1.x * v[1] + B.b1.y * v[2] + hv[1];
  o[2] = B.b1.z * v[0] + B.b1.w * v[1] + B.b2.x * v[2] + hv[2];
  const float m = B.b3.x;
  o[3] = m * v[3] + wh[0]; o[4] = m * v[4] + wh[1]; o[5] = m * v[5] + wh[2];
}

// the body's force I a + v x* I v
__device__ __forceinline__ void body_force(const Body& B, const float v[6], const float a[6],
                                           float f[6]) {
  float Iv[6], Ia[6], cf[6];
  inertia_apply(B, v, Iv);
  inertia_apply(B, a, Ia);
  crf(v, Iv, cf);
#pragma unroll
  for (int k = 0; k < 6; ++k) f[k] = Ia[k] + cf[k];
}

__device__ __forceinline__ void quat_to_rotm(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

// cos and sin of the lane's five joint angles
__device__ __forceinline__ void joint_sincos(const float q5[5], float cs[5], float sn[5]) {
#pragma unroll
  for (int l = 0; l < 5; ++l) sincosf(q5[l], &sn[l], &cs[l]);
}

// one row of Minv (16 floats in shared memory) times rhs
__device__ __forceinline__ float minv_row(const float* __restrict__ row, const float rhs[16]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 m = ld4(row + 4 * k);
    acc = fmaf(m.x, rhs[4 * k], acc);
    acc = fmaf(m.y, rhs[4 * k + 1], acc);
    acc = fmaf(m.z, rhs[4 * k + 2], acc);
    acc = fmaf(m.w, rhs[4 * k + 3], acc);
  }
  return acc;
}

// The plane z = 0: spring-damper normal force gated by penetration,
// regularized Coulomb friction in the plane. contact() takes a point's world
// position pt and velocity vp, writes its world force fw and returns whether
// the point is below the ground.
struct Plane {
  __device__ __forceinline__ bool contact(const float pt[3], const float vp[3], float stiff,
                                          float damp, float mu, float vslip2,
                                          float fw[3]) const {
    const float pen = fmaxf(-pt[2], 0.f);
    const float in_c = pen > 0.f ? 1.f : 0.f;
    const float fn = fmaxf(stiff * pen - damp * vp[2] * in_c, 0.f) * in_c;
    const float speed = sqrtf(vp[0] * vp[0] + vp[1] * vp[1] + vslip2);
    const float scale = -mu * fn / speed;
    fw[0] = scale * vp[0]; fw[1] = scale * vp[1]; fw[2] = fn;
    return in_c > 0.f;
  }
};

// Where a query lies on one axis of a height field of n >= 2 samples over
// `extent` meters (sim/contact.py::Terrain.height): the grid coordinate
// clamped below n - 1 so that the cell's far corner stays on the grid, the
// cell's index i0 and the fraction f into it. A NaN query gives the fraction
// NaN, so its height reads NaN, and the index 0: fminf and fmaxf drop a NaN
// and a float-to-int conversion of one is undefined, so the index is taken
// from a NaN-free value and clamped as an integer.
__device__ __forceinline__ void grid_axis(float x, float extent, int n, float& f, int& i0) {
  const float g = (x / extent + 0.5f) * static_cast<float>(n - 1);
  const float hi = static_cast<float>(n - 1.001);  // as torch casts the Python float
  const float gc = isnan(g) ? g : fminf(fmaxf(g, 0.f), hi);
  const float g0 = floorf(gc);
  f = gc - g0;
  i0 = min(max(__float2int_rz(fmaxf(g0, 0.f)), 0), n - 2);
}

// clamp(x, min=0) that keeps a NaN, as torch.clamp does
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// One env's height field: H x W heights (row-major, y by x) over extent x
// extent meters centred on the origin, sampled bilinearly, with contact along
// the surface normal (sim/contact.py::contact_force_world on a Terrain):
//   h, n    the height and the normal from five bilinear samples, the
//           gradient by central differences at a half-cell step (eps)
//   phi = (p_z - h) n_z, phi_dot = v.n, pen = max(-phi, 0)
//   f_n = max(k pen - d phi_dot sign(pen), 0) (pen > 0)
//   f = f_n n + f_t, f_t = -mu f_n v_t / sqrt(|v_t|^2 + vslip^2), v_t = v - phi_dot n
// The friction's factor -mu f_n / speed is formed first, as Plane forms
// it. A NaN point gives a NaN force, as the plain version does (fmaxf would
// drop the NaN).
struct Field {
  const float* __restrict__ h;  // the env's heights
  int H, W;
  float extent, eps_x, eps_y;

  __device__ __forceinline__ bool contact(const float pt[3], const float vp[3], float stiff,
                                          float damp, float mu, float vslip2,
                                          float fw[3]) const {
    // the five samples: centre, x + eps, x - eps, y + eps, y - eps; each
    // one's four corners are loaded together, all twenty before any is used,
    // so that the point waits for one round trip to memory
    const float sx[5] = {pt[0], pt[0] + eps_x, pt[0] - eps_x, pt[0], pt[0]};
    const float sy[5] = {pt[1], pt[1], pt[1], pt[1] + eps_y, pt[1] - eps_y};
    float fx[5], fy[5], c[5][4];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      int ix, iy;
      grid_axis(sx[j], extent, W, fx[j], ix);
      grid_axis(sy[j], extent, H, fy[j], iy);
      const float* p = h + iy * W + ix;
      c[j][0] = __ldg(p); c[j][1] = __ldg(p + 1);
      c[j][2] = __ldg(p + W); c[j][3] = __ldg(p + W + 1);
    }
    float hs[5];
#pragma unroll
    for (int j = 0; j < 5; ++j)
      hs[j] = c[j][0] * (1.f - fx[j]) * (1.f - fy[j]) + c[j][1] * fx[j] * (1.f - fy[j]) +
              c[j][2] * (1.f - fx[j]) * fy[j] + c[j][3] * fx[j] * fy[j];
    const float dhdx = (hs[1] - hs[2]) / (2.f * eps_x);
    const float dhdy = (hs[3] - hs[4]) / (2.f * eps_y);
    const float nrm = sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
    const float n[3] = {-dhdx / nrm, -dhdy / nrm, 1.f / nrm};

    const float phi = (pt[2] - hs[0]) * n[2];
    const float phi_dot = vp[0] * n[0] + vp[1] * n[1] + vp[2] * n[2];
    const float pen = clamp0(-phi);
    // in_c stands for sign(pen) too: they differ only at a NaN pen, where k
    // pen is NaN already
    const float in_c = pen > 0.f ? 1.f : 0.f;
    const float fn = clamp0(stiff * pen - damp * phi_dot * in_c) * in_c;
    float vt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) vt[i] = vp[i] - phi_dot * n[i];
    const float speed = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + (vt[2] * vt[2] + vslip2));
    const float scale = -mu * fn / speed;
#pragma unroll
    for (int i = 0; i < 3; ++i) fw[i] = fn * n[i] + scale * vt[i];
    return in_c > 0.f;
  }
};

// One semi-implicit substep of one env, in place on the registers of the
// lane that holds leg `leg` (0 or 1) of it; both lanes of the pair call it
// together. S: the staged model; minv: the env's Minv in shared memory; cs,
// sn: cos and sin of q5 on entry, and of the new q5 on exit if `refresh`;
// ground: what the leg's toe and heel touch. Returns the leg's points below
// the ground at the substep's start: bit 0 the toe, bit 1 the heel.
template <class Ground = Plane>
__device__ __forceinline__ int substep(const float* __restrict__ S, int leg,
                                       const float* __restrict__ minv, float pos[3],
                                       float quat[4], float vb[6], float q5[5], float qd5[5],
                                       float cs[5], float sn[5], const float tau5[5], float dt,
                                       bool refresh, const Ground& ground = Ground()) {
  float R0[3][3];
  quat_to_rotm(quat, R0);
  const float4 sc0 = ld4(S + kSScalar), sc1 = ld4(S + kSScalar + 4);
  const float stiff = sc0.x, damp = sc0.y, mu = sc0.z, vslip2 = sc0.w;
  const float jdamp = sc1.x, kls = sc1.y, kld = sc1.z, g = sc1.w;
  const float a_base[6] = {0.f, 0.f, 0.f, g * R0[2][0], g * R0[2][1], g * R0[2][2]};
  const float* bodies = S + kSBody + 16 * (1 + 5 * leg);  // the leg's five bodies

  float Rw[3][3], pw[3], v[6], a[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pw[i] = pos[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) Rw[i][k] = R0[i][k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) { v[i] = vb[i]; a[i] = a_base[i]; }

  // forward pass: pose, velocity, acceleration and force of each level
  float fs[5][6];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int ax = axis_of(l);
    const float c = cs[l], s = sn[l];
    const Body B = load_body(bodies + 16 * l);
    const float off[3] = {B.b3.y, B.b3.z, B.b3.w};
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[i] += Rw[i][0] * off[0] + Rw[i][1] * off[1] + Rw[i][2] * off[2];
    rotate_frame(ax, c, s, Rw);
    motion_to_child(ax, c, s, off, v);
    v[ax] += qd5[l];
    motion_to_child(ax, c, s, off, a);
    add_cross_axis(ax, &v[0], qd5[l], &a[0]);  // crm(v, [qd e_ax; 0])
    add_cross_axis(ax, &v[3], qd5[l], &a[3]);
    body_force(B, v, a, fs[l]);
  }

  // toe/heel contact with the ground; Rw, pw, v are now the foot's
  float n_sum[3] = {0.f, 0.f, 0.f}, f_sum[3] = {0.f, 0.f, 0.f};
  int below = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float4 r4 = ld4(S + kSContact + 4 * (2 * leg + k));
    const float rr[3] = {r4.x, r4.y, r4.z};
    float wr[3], vpb[3], pt[3], vp[3];
    cross3(&v[0], rr, wr);
    vpb[0] = v[3] + wr[0]; vpb[1] = v[4] + wr[1]; vpb[2] = v[5] + wr[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pt[i] = pw[i] + (Rw[i][0] * rr[0] + Rw[i][1] * rr[1] + Rw[i][2] * rr[2]);
      vp[i] = Rw[i][0] * vpb[0] + Rw[i][1] * vpb[1] + Rw[i][2] * vpb[2];
    }
    float fw[3];
    if (ground.contact(pt, vp, stiff, damp, mu, vslip2, fw)) below |= 1 << k;
    float fb[3], nb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) fb[i] = Rw[0][i] * fw[0] + Rw[1][i] * fw[1] + Rw[2][i] * fw[2];
    cross3(rr, fb, nb);
#pragma unroll
    for (int i = 0; i < 3; ++i) { n_sum[i] += nb[i]; f_sum[i] += fb[i]; }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) { fs[4][i] -= n_sum[i]; fs[4][3 + i] -= f_sum[i]; }

  // backward pass: joint bias, subtree force toward the torso
  float f[6], bias[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) f[k] = fs[4][k];
#pragma unroll
  for (int l = 4; l >= 0; --l) {
    const int ax = axis_of(l);
    bias[l] = f[ax];
    const float4 b3 = ld4(bodies + 16 * l + 12);
    const float off[3] = {b3.y, b3.z, b3.w};
    force_to_parent(ax, cs[l], sn[l], off, f);
    if (l > 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) f[k] += fs[l - 1][k];
    }
  }

  // the leg's joint right-hand sides: tau_eff - bias
  float own[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const float2 lim = *reinterpret_cast<const float2*>(S + kSLimits + 2 * (5 * leg + l));
    const float over = fmaxf(q5[l] - lim.y, 0.f), under = fmaxf(lim.x - q5[l], 0.f);
    const float viol = (over > 0.f || under > 0.f) ? 1.f : 0.f;
    const float tlim = -kls * (over - under) - kld * qd5[l] * viol;
    own[l] = ((tau5[l] + tlim) - jdamp * qd5[l]) - bias[l];
  }

  // From here on both lanes hold the same values, but for their own joints:
  // rhs = [-(torso force + both legs' root forces); leg 0's; leg 1's].
  float rhs[16];
  {
    const Body B0 = load_body(S + kSBody);
    float tf[6];
    body_force(B0, vb, a_base, tf);
#pragma unroll
    for (int k = 0; k < 6; ++k) rhs[k] = -(tf[k] + pair_sum(f[k]));
  }
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const float other = other_leg(own[l]);
    rhs[6 + l] = leg == 0 ? own[l] : other;
    rhs[11 + l] = leg == 0 ? other : own[l];
  }

  // qdd = Minv rhs: three base rows (angular on lane 0, linear on lane 1),
  // exchanged, and the lane's own joint rows; then the semi-implicit Euler
  // step
  {
    float mine[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) mine[i] = minv_row(minv + 16 * (3 * leg + i), rhs);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float theirs = other_leg(mine[i]);
      vb[i] += (leg == 0 ? mine[i] : theirs) * dt;
      vb[3 + i] += (leg == 0 ? theirs : mine[i]) * dt;
    }
  }
  const float* rows = minv + 16 * (6 + 5 * leg);
#pragma unroll
  for (int l = 0; l < 5; ++l) qd5[l] += minv_row(rows + 16 * l, rhs) * dt;
  float om[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    om[i] = R0[i][0] * vb[0] + R0[i][1] * vb[1] + R0[i][2] * vb[2];
    pos[i] += (R0[i][0] * vb[3] + R0[i][1] * vb[4] + R0[i][2] * vb[5]) * dt;
  }
  // exponential-map quaternion step, renormalized
  const float hx = 0.5f * dt * om[0], hy = 0.5f * dt * om[1], hz = 0.5f * dt * om[2];
  const float th2 = hx * hx + hy * hy + hz * hz;
  const float th = sqrtf(th2 + 1e-24f);
  float sin_th, aw;
  sincosf(th, &sin_th, &aw);
  const float sinc = th2 > 1e-12f ? sin_th / th : 1.f - th2 / 6.f;
  const float ax = sinc * hx, ay = sinc * hy, az = sinc * hz;
  const float bw = quat[0], bx = quat[1], by = quat[2], bz = quat[3];
  const float ow = aw * bw - ax * bx - ay * by - az * bz;
  const float ox = aw * bx + ax * bw + ay * bz - az * by;
  const float oy = aw * by - ax * bz + ay * bw + az * bx;
  const float oz = aw * bz + ax * by - ay * bx + az * bw;
  const float nrm = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
  quat[0] = ow / nrm; quat[1] = ox / nrm; quat[2] = oy / nrm; quat[3] = oz / nrm;
#pragma unroll
  for (int l = 0; l < 5; ++l) q5[l] += qd5[l] * dt;
  if (refresh) joint_sincos(q5, cs, sn);
  return below;
}

}  // namespace

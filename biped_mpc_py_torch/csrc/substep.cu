// Fused articulated physics substeps of a batch of HECTOR envs, for Hopper
// (sm_90a): two kernels, one per ground.
//
// substep_kernel<false> replaces the TPU kernel biped_mpc_py_tpu/ops/pallas/
// substep_kernel.py::fused_substeps. One launch advances every env by n_steps
// semi-implicit substeps of dt under held joint torques tau (10) and a held
// mass-matrix inverse Minv (16x16), on the plane z = 0. Each substep:
//
//   per leg, 5 levels: joint rotation, world pose, body velocity and
//     acceleration (gravity trick: the base accelerates up by g), body
//     force I a + v x* I v                                   (RNEA forward)
//   toe/heel penalty contact at the foot: spring-damper normal force gated
//     by penetration, regularized Coulomb friction           (foot wrench)
//   RNEA backward pass: joint bias = axis component of the subtree force
//   soft joint limits and viscous damping on the torques
//   qdd = Minv (tau_gen - bias); base rows angular first, then linear
//   v += qdd dt; q += qd dt; pos += R v_lin dt; quat <- exp(dt/2 R w) quat
//
// The semantics are those of the plain version fused_substeps_reference in
// ops/cuda/substep_kernel.py, a loop of sim/engine.py::art_substep; the two
// differ only in f32 rounding (order of sums, fused multiply-adds, the
// cos/sin entries of the joint rotations taken directly, the spatial
// inertias applied in their packed form).
//
// What bounds it on this card: latency, not throughput. The work is one
// dependent chain of scalar f32 math per env (bytes and operations are
// 1/100 of the time, utils/roofline.py), and at 1024 envs every warp has an
// SM to itself, so nothing hides a stall. Two things set the time: the
// length of the chain, and the number of instructions a warp runs through,
// since a substep is straight-line code that a single warp streams through
// the instruction caches.
//
// What the design does about it (substep_device.cuh holds the code):
//  - An env on two lanes, a leg per lane: the per-leg three quarters of a
//    substep (forward pass, contact, backward pass) run side by side and
//    exist once in the code instead of twice. 16 envs per warp, one warp
//    per block: 1024 envs are 64 blocks on 64 SMs, 4096 are 256 blocks (2
//    per SM), 16,384 are 1024 (8 per SM, the most the registers allow).
//    The lanes exchange 14 values per substep by shuffle and keep
//    bit-equal copies of the base state; the header says why they cannot
//    drift. Ragged N: a clamped env index and guarded stores, no early
//    return.
//  - Minv once per launch, by cp.async, into shared memory at a stride of
//    260 floats (no bank conflicts between a quarter warp's envs), started
//    before the state loads and waited for before the first substep. A
//    lane reads 3 base rows and its own 5 joint rows as 128-bit loads; the
//    lanes exchange the base accelerations.
//  - The model is staged packed: a body's inertia as its rotational block,
//    m c and m (13 floats for 36, I6 v in 24 multiply-adds for 36), with
//    the joint's offset in the same four 128-bit loads. The lane's leg only
//    changes the address, so both lanes' loads are two broadcasts. The
//    packing is a gather, done by 4-byte cp.async in the same group as
//    Minv: the launch's fixed cost is one round trip to global memory.
//  - sincosf shares the range reduction of each angle's cos and sin. No
//    --use_fast_math: sincosf, sqrtf and the divisions are the accurate
//    ones; the quaternion is normalized by four divisions by sqrtf of its
//    squared norm, as the plain version divides by the norm (a reciprocal
//    would spend the 1e-6 bound on quat).
// Not done: a finer split (toe and heel), constants as instruction operands
// (a __constant__ copy per launch costs more than the shared loads it saves
// here), Minv's symmetry.
//
// substep_kernel<true> runs the same substeps on a height field per env: the
// contact of sim/contact.py on a Terrain (substep_device.cuh::Field: five
// bilinear height samples per toe or heel point and substep, the normal by
// central differences, normal force and friction along it). It replaces no
// TPU kernel: the JAX package, like the port before it, steps a height field
// with the plain chain (sim/engine.py::art_step), whose 5 substeps a period
// are ~2,400 small ATen kernels on this card, 70% of a rough-ground tick at
// 4096 envs. Beyond the flat kernel's work it writes t as the plain chain
// does (n_steps f32 additions of dt) and counts, per sole point, the substeps
// that begin below the ground into the caller's counter
// (utils/profiling.py's ground count), each lane its own leg's two entries,
// so no atomics.
//
// What bounds it: latency, as the flat kernel. An env a launch reads ~3 KB
// (state, Minv, 400 height-corner loads from its 16 KB field: 20 a sole
// point and substep) and runs ~25k operations; at 4096 envs that is ~12 MB
// and ~0.1 GOP, ~0.004 ms at the card's rates. What the field adds to the
// chain is a memory round trip per substep: the 4096 fields (64 MB at 64 x
// 64) do not fit the 50 MB L2, so a point's samples come from HBM on first
// touch.
//
// What the design does about it: the flat kernel's lanes, staging and code,
// with the ground a template parameter of substep(); a point's 20 corner
// loads (5 samples x 4) issued together by __ldg before any is used, so that
// the point waits for one memory round trip, not five; the per-launch field
// constants are kernel parameters (FieldArgs).

#include "substep_device.cuh"

namespace {

// What the field kernel takes besides the flat kernel's inputs: t and its
// output, the heights (n_env, H, W) with the grid's extent and half-cell
// steps, and the (n_env, 2, 2) int32 count of sole points below the ground,
// added to in place. The flat kernel reads none of it.
struct FieldArgs {
  const float* __restrict__ t_in;
  const float* __restrict__ heights;
  float* __restrict__ t_out;
  int* __restrict__ below_count;
  int H, W;
  float extent, eps_x, eps_y;
};

// n_steps substeps of every env, on the plane (kOnField false) or on the
// env's height field (kOnField true).
template <bool kOnField>
__global__ void __launch_bounds__(kThreads)
substep_kernel(const float* __restrict__ consts, const float* __restrict__ pos_in,
               const float* __restrict__ quat_in, const float* __restrict__ vb_in,
               const float* __restrict__ q_in, const float* __restrict__ qd_in,
               const float* __restrict__ tau_in, const float* __restrict__ minv_in,
               float* __restrict__ pos_out, float* __restrict__ quat_out,
               float* __restrict__ vb_out, float* __restrict__ q_out,
               float* __restrict__ qd_out, int n_env, float dt, int n_steps, FieldArgs fa) {
  __shared__ __align__(16) float S[kNStaged];
  __shared__ __align__(16) float M[kEnvsPerBlock * kMinvStride];
  const int e0 = blockIdx.x * kEnvsPerBlock;
  stage_model_async(S, consts);
  stage_minv_async(M, minv_in, e0, n_env);
  async_commit();

  const int leg = threadIdx.x & 1, slot = threadIdx.x >> 1;
  const int e_own = e0 + slot;
  const int e = min(e_own, n_env - 1);  // a lane past the end repeats the last env
  float pos[3], quat[4], vb[6], q5[5], qd5[5], tau5[5], cs[5], sn[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = pos_in[3 * e + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = quat_in[4 * e + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) vb[i] = vb_in[6 * e + i];
  const int j0 = 10 * e + 5 * leg;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    q5[l] = q_in[j0 + l];
    qd5[l] = qd_in[j0 + l];
    tau5[l] = tau_in[j0 + l];
  }
  float t = 0.f;
  if constexpr (kOnField) t = fa.t_in[e];
  const Field field{fa.heights + static_cast<size_t>(e) * fa.H * fa.W, fa.H, fa.W, fa.extent,
                    fa.eps_x, fa.eps_y};
  joint_sincos(q5, cs, sn);
  async_wait<0>();

  const float* minv = M + kMinvStride * slot;
  int toe = 0, heel = 0;
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    int below = 0;
    if constexpr (kOnField)
      below = substep(S, leg, minv, pos, quat, vb, q5, qd5, cs, sn, tau5, dt, s + 1 < n_steps,
                      field);
    else
      substep(S, leg, minv, pos, quat, vb, q5, qd5, cs, sn, tau5, dt, s + 1 < n_steps);
    toe += below & 1;
    heel += below >> 1;
    t += dt;  // the plain chain's t + dt at every substep (the field kernel's t)
  }

  if (e_own < n_env) {
    if (leg == 0) {  // the pair's copies are bit-equal: lane 0 writes the base
#pragma unroll
      for (int i = 0; i < 3; ++i) pos_out[3 * e + i] = pos[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) quat_out[4 * e + i] = quat[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) vb_out[6 * e + i] = vb[i];
      if constexpr (kOnField) fa.t_out[e] = t;
    }
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      q_out[j0 + l] = q5[l];
      qd_out[j0 + l] = qd5[l];
    }
    if constexpr (kOnField) {
      int* count = fa.below_count + 4 * e + 2 * leg;  // the lane's own two entries
      count[0] += toe;
      count[1] += heel;
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t) of device `device`; `minv` must be
// 16-byte aligned. Returns the cudaError_t of the launch (0 = success); the
// kernel allocates nothing and does not synchronize.
extern "C" int substep_launch(const float* consts, const float* pos, const float* quat,
                              const float* v_base, const float* q, const float* qd,
                              const float* tau, const float* minv, float* pos_out,
                              float* quat_out, float* v_base_out, float* q_out,
                              float* qd_out, int n_env, float dt, int n_steps, int device,
                              void* stream) {
  if (n_env < 0 || n_steps < 1 || (reinterpret_cast<size_t>(minv) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_env + kEnvsPerBlock - 1) / kEnvsPerBlock;
  substep_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, pos, quat, v_base, q, qd, tau, minv, pos_out, quat_out, v_base_out, q_out,
      qd_out, n_env, dt, n_steps, FieldArgs{});
  return static_cast<int>(cudaGetLastError());
}

// The field kernel's launch, as substep_launch's; `heights` is (n_env, H, W)
// with H, W >= 2, `below_count` (n_env, 2, 2) int32.
extern "C" int substep_field_launch(const float* consts, const float* pos, const float* quat,
                                    const float* v_base, const float* q, const float* qd,
                                    const float* tau, const float* minv, const float* t,
                                    const float* heights, float* pos_out, float* quat_out,
                                    float* v_base_out, float* q_out, float* qd_out,
                                    float* t_out, int* below_count, int n_env, int H, int W,
                                    float extent, float eps_x, float eps_y, float dt,
                                    int n_steps, int device, void* stream) {
  if (n_env < 0 || n_steps < 1 || H < 2 || W < 2 ||
      (reinterpret_cast<size_t>(minv) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_env + kEnvsPerBlock - 1) / kEnvsPerBlock;
  substep_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, pos, quat, v_base, q, qd, tau, minv, pos_out, quat_out, v_base_out, q_out,
      qd_out, n_env, dt, n_steps,
      FieldArgs{t, heights, t_out, below_count, H, W, extent, eps_x, eps_y});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fused articulated physics substeps of a batch of HECTOR envs, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel biped_mpc_py_tpu/ops/pallas/substep_kernel.py::
// fused_substeps. One launch advances every env by n_steps semi-implicit
// substeps of dt under held joint torques tau (10) and a held mass-matrix
// inverse Minv (16x16), on the plane z = 0. Each substep:
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

#include "substep_device.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
substep_kernel(const float* __restrict__ consts, const float* __restrict__ pos_in,
               const float* __restrict__ quat_in, const float* __restrict__ vb_in,
               const float* __restrict__ q_in, const float* __restrict__ qd_in,
               const float* __restrict__ tau_in, const float* __restrict__ minv_in,
               float* __restrict__ pos_out, float* __restrict__ quat_out,
               float* __restrict__ vb_out, float* __restrict__ q_out,
               float* __restrict__ qd_out, int n_env, float dt, int n_steps) {
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
  joint_sincos(q5, cs, sn);
  async_wait<0>();

  const float* minv = M + kMinvStride * slot;
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s)
    substep(S, leg, minv, pos, quat, vb, q5, qd5, cs, sn, tau5, dt, s + 1 < n_steps);

  if (e_own < n_env) {
    if (leg == 0) {  // the pair's copies are bit-equal: lane 0 writes the base
#pragma unroll
      for (int i = 0; i < 3; ++i) pos_out[3 * e + i] = pos[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) quat_out[4 * e + i] = quat[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) vb_out[6 * e + i] = vb[i];
    }
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      q_out[j0 + l] = q5[l];
      qd_out[j0 + l] = qd5[l];
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
  substep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, pos, quat, v_base, q, qd, tau, minv, pos_out, quat_out, v_base_out, q_out,
      qd_out, n_env, dt, n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

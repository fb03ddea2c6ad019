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
// cos/sin entries of the joint rotations taken directly).
//
// What bounds it on this card: one long dependent chain of scalar f32 math
// per env. A substep is ~5 kFLOP (two 5-level leg recursions with 6x6
// inertia products, 22 of them, the contact, a 16x16 mat-vec), so a
// 5-substep launch is ~25k dependent instructions per thread. Memory is
// small: 33 + 10 state and torque floats and the 1 KB Minv per env,
// re-read from L1/L2 every substep.
//
// What the design does about it (a simple, correct first version):
//  - One thread per env; the state, the per-leg level data (cos/sin and
//    the 6-vector body forces) and the bias stay in registers. Any N works.
//  - Blocks of 32 threads, so 1024 envs spread over 32 SMs; a block stages
//    the model's 466 constants (offsets, contact points, 11 spatial
//    inertias, contact and limit parameters) into shared memory, where
//    every thread reads the same address (a broadcast).
//  - The joint axes are the tree's fixed coordinate axes (sim/model.py
//    JOINT_AXES: hip yaw z, hip roll x, three pitch y), so each joint
//    rotation is a closed cos/sin form.
//  - Minv is read as float4 rows each substep, straight from global memory.
//  - No --use_fast_math: sinf, cosf, sqrtf and the divisions are the
//    accurate ones; the quaternion is normalized by dividing by sqrtf of
//    its squared norm, as the plain version divides by the norm.
// Not done yet: splitting legs or joints across a warp, Minv in shared
// memory or registers.

#include "substep_device.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
substep_kernel(const float* __restrict__ consts, const float* __restrict__ pos_in,
               const float* __restrict__ quat_in, const float* __restrict__ vb_in,
               const float* __restrict__ q_in, const float* __restrict__ qd_in,
               const float* __restrict__ tau_in, const float* __restrict__ minv_in,
               float* __restrict__ pos_out, float* __restrict__ quat_out,
               float* __restrict__ vb_out, float* __restrict__ q_out,
               float* __restrict__ qd_out, int n_env, float dt, int n_steps) {
  __shared__ float C[kNConst];
  for (int i = threadIdx.x; i < kNConst; i += kThreads) C[i] = consts[i];
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_env) return;

  float pos[3], quat[4], vb[6], q[10], qd[10], tau[10];
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = pos_in[3 * e + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = quat_in[4 * e + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) vb[i] = vb_in[6 * e + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    q[j] = q_in[10 * e + j];
    qd[j] = qd_in[10 * e + j];
    tau[j] = tau_in[10 * e + j];
  }
  const float4* minv = reinterpret_cast<const float4*>(minv_in) + 64 * static_cast<size_t>(e);
  for (int s = 0; s < n_steps; ++s) substep(C, pos, quat, vb, q, qd, tau, minv, dt);

#pragma unroll
  for (int i = 0; i < 3; ++i) pos_out[3 * e + i] = pos[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) quat_out[4 * e + i] = quat[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) vb_out[6 * e + i] = vb[i];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    q_out[10 * e + j] = q[j];
    qd_out[10 * e + j] = qd[j];
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
  const int blocks = (n_env + kThreads - 1) / kThreads;
  substep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, pos, quat, v_base, q, qd, tau, minv, pos_out, quat_out, v_base_out, q_out,
      qd_out, n_env, dt, n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

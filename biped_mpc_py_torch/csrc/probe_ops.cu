// Probe of the device math that the fused tick kernel uses, for Hopper
// (sm_90a).
//
// Replaces the TPU probe tools/probe_mosaic_ops.py::main (its pallas_call),
// which asked the TPU compiler which ops it lowers: it refused atan2, so the
// Pallas tick kernel carries a polynomial atan2 and asin, a floor-based
// modulo and no nested loops. On this card every one of those ops is native;
// the probe runs each as a toy kernel and the wrapper holds it against numpy
// (biped_mpc_py_torch/tools/probe_cuda_ops.py):
//
//   op 0  asinf(clamp(0.3 a, -1, 1))
//   op 1  the numpy-style remainder of a by 0.4 (sign of the divisor)
//   op 2  x = a; 8 times: (5 times x += 0.01 sin x), then x += 0.1 (i + 1)
//   op 3  atan2f(a, b)
//
// What bounds it: nothing on this card (one thread per element of an (8, 128)
// array, one launch per op); the point is the math. No --use_fast_math, so
// the transcendentals are the accurate ones.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void k_asin(const float* __restrict__ a, float* __restrict__ o, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = asinf(fminf(fmaxf(a[i] * 0.3f, -1.f), 1.f));
}

__global__ void k_rem(const float* __restrict__ a, float* __restrict__ o, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float d = 0.4f;
  float r = fmodf(a[i], d);
  if (r != 0.f && ((r < 0.f) != (d < 0.f))) r += d;
  o[i] = r;
}

__global__ void k_nested(const float* __restrict__ a, float* __restrict__ o, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = a[i];
  for (int k = 0; k < 8; ++k) {
    for (int j = 0; j < 5; ++j) x = x + 0.01f * sinf(x);
    x = x + static_cast<float>(0.1 * (k + 1));  // 0.1 (k + 1) rounded once, as numpy's
  }
  o[i] = x;
}

__global__ void k_atan2(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ o, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = atan2f(a[i], b[i]);
}

}  // namespace

// Launch op `op` (0-3, see above) over n floats on `stream` of `device`; `b`
// is read by op 3 only. Returns the cudaError_t of the launch (0 = success).
extern "C" int probe_launch(int op, const float* a, const float* b, float* out, int n,
                            int device, void* stream) {
  if (n < 0 || op < 0 || op > 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: k_asin<<<blocks, kThreads, 0, s>>>(a, out, n); break;
    case 1: k_rem<<<blocks, kThreads, 0, s>>>(a, out, n); break;
    case 2: k_nested<<<blocks, kThreads, 0, s>>>(a, out, n); break;
    default: k_atan2<<<blocks, kThreads, 0, s>>>(a, b, out, n); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

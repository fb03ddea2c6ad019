// Device code shared by the fused articulated kernels (substep.cu, tick.cu):
// the constant buffer's layout, small rotation and spatial-vector helpers,
// and substep(), one semi-implicit substep of one env in registers.
//
// substep() is the counterpart of the Pallas kernels' shared _substep
// (biped_mpc_py_tpu/ops/pallas/substep_kernel.py); see substep.cu for what
// it computes and what bounds it. Everything here has internal linkage: each
// kernel source includes it once and builds into its own library.

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

__device__ __forceinline__ void i6_apply(const float* I, const float v[6], float o[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = I[i * 6] * v[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = fmaf(I[i * 6 + j], v[j], acc);
    o[i] = acc;
  }
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

// one semi-implicit substep of one env, in place on its registers
__device__ __forceinline__ void substep(const float* __restrict__ C, float pos[3], float quat[4],
                                        float vb[6], float q[10], float qd[10],
                                        const float tau[10], const float4* __restrict__ minv,
                                        float dt) {
  float R0[3][3];
  quat_to_rotm(quat, R0);
  const float stiff = C[kOffScalar], damp = C[kOffScalar + 1], mu = C[kOffScalar + 2];
  const float vslip2 = C[kOffScalar + 3], jdamp = C[kOffScalar + 4];
  const float kls = C[kOffScalar + 5], kld = C[kOffScalar + 6], g = C[kOffScalar + 7];
  const float a_base[6] = {0.f, 0.f, 0.f, g * R0[2][0], g * R0[2][1], g * R0[2][2]};

  float f_legs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bias[10];
#pragma unroll
  for (int leg = 0; leg < 2; ++leg) {
    float Rw[3][3], pw[3], v[6], a[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pw[i] = pos[i];
#pragma unroll
      for (int k = 0; k < 3; ++k) Rw[i][k] = R0[i][k];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) { v[i] = vb[i]; a[i] = a_base[i]; }
    float cs[5], sn[5], fs[5][6];

    // forward pass: pose, velocity, acceleration and force of each level
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int j = 5 * leg + l, ax = axis_of(l);
      const float c = cosf(q[j]), s = sinf(q[j]);
      cs[l] = c; sn[l] = s;
      const float off[3] = {C[kOffJoint + 3 * j], C[kOffJoint + 3 * j + 1],
                            C[kOffJoint + 3 * j + 2]};
#pragma unroll
      for (int i = 0; i < 3; ++i) pw[i] += Rw[i][0] * off[0] + Rw[i][1] * off[1] + Rw[i][2] * off[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {  // Rw <- Rw R_pc, row by row
        float row[3];
        rot_cp(ax, c, s, Rw[i], row);
        Rw[i][0] = row[0]; Rw[i][1] = row[1]; Rw[i][2] = row[2];
      }
      motion_to_child(ax, c, s, off, v);
      v[ax] += qd[j];
      motion_to_child(ax, c, s, off, a);
      float vJ[3] = {0.f, 0.f, 0.f};
      vJ[ax] = qd[j];
      float t1[3], t2[3];
      cross3(&v[0], vJ, t1);  // crm(v, [vJ; 0])
      cross3(&v[3], vJ, t2);
      a[0] += t1[0]; a[1] += t1[1]; a[2] += t1[2];
      a[3] += t2[0]; a[4] += t2[1]; a[5] += t2[2];
      const float* I = C + kOffI6 + 36 * (1 + j);
      float Iv[6], Ia[6], cf[6];
      i6_apply(I, v, Iv);
      i6_apply(I, a, Ia);
      crf(v, Iv, cf);
#pragma unroll
      for (int k = 0; k < 6; ++k) fs[l][k] = Ia[k] + cf[k];
    }

    // toe/heel contact on z = 0; Rw, pw, v are now the foot's
    float n_sum[3] = {0.f, 0.f, 0.f}, f_sum[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* r = C + kOffContact + 3 * (2 * leg + k);
      const float rr[3] = {r[0], r[1], r[2]};
      float wr[3], vpb[3], pt[3], vp[3];
      cross3(&v[0], rr, wr);
      vpb[0] = v[3] + wr[0]; vpb[1] = v[4] + wr[1]; vpb[2] = v[5] + wr[2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pt[i] = pw[i] + (Rw[i][0] * rr[0] + Rw[i][1] * rr[1] + Rw[i][2] * rr[2]);
        vp[i] = Rw[i][0] * vpb[0] + Rw[i][1] * vpb[1] + Rw[i][2] * vpb[2];
      }
      const float pen = fmaxf(-pt[2], 0.f);
      const float in_c = pen > 0.f ? 1.f : 0.f;
      const float fn = fmaxf(stiff * pen - damp * vp[2] * in_c, 0.f) * in_c;
      const float speed = sqrtf(vp[0] * vp[0] + vp[1] * vp[1] + vslip2);
      const float scale = -mu * fn / speed;
      const float fw[3] = {scale * vp[0], scale * vp[1], fn};
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
    float f[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) f[k] = fs[4][k];
#pragma unroll
    for (int l = 4; l >= 0; --l) {
      const int j = 5 * leg + l, ax = axis_of(l);
      bias[j] = f[ax];
      const float off[3] = {C[kOffJoint + 3 * j], C[kOffJoint + 3 * j + 1],
                            C[kOffJoint + 3 * j + 2]};
      force_to_parent(ax, cs[l], sn[l], off, f);
      if (l > 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) f[k] += fs[l - 1][k];
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) f_legs[k] += f[k];
  }

  // torso force, then rhs = [-bias_base; tau_eff - bias_joints]
  float rhs[16];
  {
    const float* I0 = C + kOffI6;
    float Iv[6], Ia[6], cf[6];
    i6_apply(I0, vb, Iv);
    i6_apply(I0, a_base, Ia);
    crf(vb, Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) rhs[k] = -((Ia[k] + cf[k]) + f_legs[k]);
  }
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const float lo = C[kOffLimits + 2 * j], hi = C[kOffLimits + 2 * j + 1];
    const float over = fmaxf(q[j] - hi, 0.f), under = fmaxf(lo - q[j], 0.f);
    const float viol = (over > 0.f || under > 0.f) ? 1.f : 0.f;
    const float tlim = -kls * (over - under) - kld * qd[j] * viol;
    rhs[6 + j] = ((tau[j] + tlim) - jdamp * qd[j]) - bias[j];
  }

  // qdd = Minv rhs, then the semi-implicit Euler step
  float qdd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 m = minv[4 * i + k];
      acc = fmaf(m.x, rhs[4 * k], acc);
      acc = fmaf(m.y, rhs[4 * k + 1], acc);
      acc = fmaf(m.z, rhs[4 * k + 2], acc);
      acc = fmaf(m.w, rhs[4 * k + 3], acc);
    }
    qdd[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) vb[i] += qdd[i] * dt;
#pragma unroll
  for (int j = 0; j < 10; ++j) qd[j] += qdd[6 + j] * dt;
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
  const float sinc = th2 > 1e-12f ? sinf(th) / th : 1.f - th2 / 6.f;
  const float aw = cosf(th), ax = sinc * hx, ay = sinc * hy, az = sinc * hz;
  const float bw = quat[0], bx = quat[1], by = quat[2], bz = quat[3];
  const float ow = aw * bw - ax * bx - ay * by - az * bz;
  const float ox = aw * bx + ax * bw + ay * bz - az * by;
  const float oy = aw * by - ax * bz + ay * bw + az * bx;
  const float oz = aw * bz + ax * by - ay * bx + az * bw;
  const float nrm = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
  quat[0] = ow / nrm; quat[1] = ox / nrm; quat[2] = oy / nrm; quat[3] = oz / nrm;
#pragma unroll
  for (int j = 0; j < 10; ++j) q[j] += qd[j] * dt;
}

}  // namespace

// Fused articulated tick of a batch of HECTOR envs, for Hopper (sm_90a):
// the walking low-level control and the physics below one MPC tick.
//
// Replaces the TPU kernel biped_mpc_py_tpu/ops/pallas/tick_kernel.py::
// make_fused_tick (its pallas_call). One launch advances every env through
// n_lowlevel periods of ll_dt; period p runs, at t_ll = t0 + p ll_dt:
//
//   feedback: the two leg chains' world poses and body velocities, the
//     whole-body CoM position and velocity, the torso z, the Euler angles of
//     the torso rotation R0, and the sole points         (feedback_and_soles)
//   control: the walking swing clock t_ll - t_p floor(t_ll / t_p), the
//     Raibert target, the swing PD, the stance wrench mapped by J', and the
//     pivot, hip-yaw and flight-yaw channels             (low_level_control)
//   energy += sum_j max(tau_j qd_j, 0) ll_dt, with qd at the period's start
//   n_substeps calls of substep() (substep_device.cuh), tau and Minv held
//
// and writes the state and the energy; t advances by the MPC dt once, on
// the host side. The semantics are those of the plain version
// fused_tick_reference in ops/cuda/tick_kernel.py. The two differ in f32
// rounding (order of sums, fused multiply-adds, the control's rotation taken
// from the quaternion where the plain version rebuilds it from the Euler
// angles) and in one place by design: the swing clock is the floor form of
// the Pallas kernel, where the plain version takes the exact remainder, so a
// clock within an ulp of a phase boundary can read the other end of the
// phase.
//
// What bounds it on this card: latency, as substep.cu says. A tick is 8
// periods of feedback, control and 5 substeps, all straight-line scalar
// code on one dependent chain per env; a warp has an SM to itself at 1024
// envs. With one thread per env the feedback and control of a period took
// as long as three and a half substeps though they count half the
// operations of one: their code, two unrolled legs of transcendentals and
// Jacobian columns, is run once per period between 5 passes of the substep
// and is fetched anew each time.
//
// What the design does about it:
//  - An env on two lanes, a leg per lane, as in substep.cu and with its
//    geometry (16 envs per warp, one warp per block). In the feedback a
//    lane walks its own chain and the lanes exchange their bodies' CoM sums
//    (3 + 3 values); the sole point, the leg's Jacobian, swing force,
//    stance wrench and five torques are the lane's own; the lanes exchange
//    the leg's positive work (1 value). The part of the control that both
//    legs share (yaw error, swing clock, Raibert target) reads only the
//    base copy and the exchanged sums, so both lanes repeat it with the
//    same instructions and get the same bits; `side` and the leg's u0 and
//    c0 entries are what differs. The energy is formed on both lanes and
//    written by lane 0.
//  - The constants and Minv by cp.async into shared memory, two groups
//    started before the state loads; the wait for the constants comes after
//    those loads, the wait for Minv after the first period's feedback and
//    control, which hide it.
//  - cos and sin of the joint angles are carried: substep() leaves those of
//    the state it ends on, the feedback and the Jacobian read them
//    (bit-equal to recomputing). sincosf wherever an angle needs both.
//  - The model and the tick's constants (body masses and CoMs packed four
//    floats a body, the sole depth, the gains, the command, the gait
//    cadence and the Jacobian geometry) are staged in shared memory. The
//    gains are data, so one build serves every config; the four config
//    switches are the bits of `flags`.
//  - The native atan2f and asinf (the Pallas kernel's polynomials exist only
//    because the TPU compiler lacks them). No --use_fast_math.
// Not done: see substep.cu.
//
// The ground is a template parameter of the kernel, as of substep():
// tick_kernel<Plane> is the flat kernel above (tick_launch), and
// tick_kernel<Field> runs the same periods on a height field per env
// (tick_field_launch). It replaces no TPU kernel: the JAX package, like the
// port before it, runs a field with the plain chain, whose feedback and
// low-level control are ~790 short ATen, cuBLAS and gemv launches a period
// on this card. The field variant differs from the flat one only where the
// plain terrain periods (rollout_art.py::_art_tick on a Terrain) differ:
//  - the substeps are substep<Field> on the env's own field, with the
//    NaN-safe index of Field, and each lane adds its leg's sole-point counts
//    into the caller's ground counter, as substep_kernel<true> does;
//  - the swing target's height adds the field's bilinear height at the
//    target's (x, y) (control/swing.py::swing_leg_force), on each lane for
//    its own leg's target;
//  - the clock is the state's own t, advanced by n_substeps f32 additions of
//    sub_dt a period and written out, and period p's control runs at that
//    running t (the plain chain's t_ll with contact_clock off), so t stays
//    bit-equal to the plain chain's;
//  - the leg geometry of the control is each env's own (the plain chain
//    reads bipeds.jac_geometry per env): eight floats an env from global
//    memory, where the flat kernel reads one robot's from shared memory.
// What bounds it is what bounds the flat kernel, latency, with a memory
// round trip per substep and per swing target for the field's samples (the
// 4096 fields of 64 x 64, 64 MB, do not fit the 50 MB L2).
//
// A config per env (a gain, command, weight or ADMM sweep: parallel/sweep.py)
// is the third instantiation, tick_kernel<PlaneTable> (tick_table_launch):
// the flat kernel with each env's control constants, the Ctrl block of the
// tick buffer, read from a table (n_env, kNCtrl) that the wrapper forms with
// the plain chain's own expressions (ops/cuda/tick_kernel.py::tick_table),
// the leg geometry its last eight columns. A block stages its 16 envs' rows
// into shared memory with the constants, so a lane reads its env's row where
// the shared kernels read the staged Ctrl block; the model part of the tick
// buffer (masses, CoMs, sole depth) stays shared, and so do the clock's dt
// and the four switches of `flags`. The JAX package runs such a sweep on its
// plain chain (the Pallas kernel closes over one config); the port did too
// before this variant, ~800 ATen and cuBLAS launches a low-level period.

#include <type_traits>

#include "substep_device.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;

// tick constant buffer layout (ops/cuda/tick_kernel.py::tick_constants)
constexpr int kTMass = 0;        // body masses, 11
constexpr int kTCom = 11;        // body CoMs in their own frames, 11 x 3
constexpr int kTTipZ = 44;       // the sole point's z in the foot frame
constexpr int kTTotalMass = 45;  // sum of the masses
constexpr int kTCtrl = 46;       // control constants, indexed by Ctrl
enum Ctrl {
  kTp, kRate, kTwoRate, kXc2, kXc3, kXc4, kXc8, kXc9, kXc10, kKv, kKp, kKd, kH, kHRate,
  kTff, kTdDamp, kKpOver, kRetract, kYOffset, kCaptureGain, kCaptureSched, kKcBase, kAmY,
  kAmX, kPitchPlace, kPitchNom, kFf, kVint, kYawLead, kKpHipyaw, kKdHipyaw, kHipyawClip,
  kHipyawLead, kTauYawClip, kFlightYawKd, kKpPivot, kKdPivot, kLThigh, kLShank, kLFoot,
  kAbdY, kAbdYConst, kHipX, kHipY, kHipZ, kNCtrl
};
constexpr int kNTick = kTCtrl + kNCtrl;
// The leg geometry of the Jacobian, the last eight control constants, as
// leg_jacobian reads it: from the tick buffer (one robot) or per env.
enum Geom { kGThigh, kGShank, kGFoot, kGAbdY, kGAbdYConst, kGHipX, kGHipY, kGHipZ, kNGeom };
static_assert(kLThigh + kNGeom == kNCtrl && kLThigh + kGHipZ == kHipZ, "geometry block");
// As staged in shared memory: a body's CoM and mass in one 128-bit group
// (11 x 4 floats in the place of the 11 + 33), the rest where it was.
constexpr int kTSBody = 0;
// flag bits
constexpr int kSin2 = 1, kCmdBodyFrame = 2, kCompatFrame = 4, kCompatYaw = 8;

// Start staging the tick's constants into T (kNTick floats), a gather as
// stage_model_async's.
__device__ __forceinline__ void stage_tick_async(float* __restrict__ T,
                                                 const float* __restrict__ tconsts) {
  for (int i = threadIdx.x; i < kNTick; i += kThreads) {
    const int b = i >> 2, k = i & 3;
    async_copy4(T + i, tconsts + (i >= kTTipZ ? i : (k < 3 ? kTCom + 3 * b + k : kTMass + b)));
  }
}

// Start staging the block's rows of a per-env control table (envs e0 ..
// e0 + 15, clamped to the batch, as stage_minv_async's) into K, kNCtrl floats
// an env.
__device__ __forceinline__ void stage_table_async(float* __restrict__ K,
                                                  const float* __restrict__ table, int e0,
                                                  int n_env) {
  for (int i = threadIdx.x; i < kEnvsPerBlock * kNCtrl; i += kThreads) {
    const int slot = i / kNCtrl, c = i - slot * kNCtrl;
    async_copy4(K + i, table + static_cast<size_t>(min(e0 + slot, n_env - 1)) * kNCtrl + c);
  }
}

// The bilinear height of a Field at (x, y) alone (sim/contact.py::
// Terrain.height), as Field::contact forms each of its samples.
__device__ __forceinline__ float field_height(const Field& f, float x, float y) {
  float fx, fy;
  int ix, iy;
  grid_axis(x, f.extent, f.W, fx, ix);
  grid_axis(y, f.extent, f.H, fy, iy);
  const float* p = f.h + iy * f.W + ix;
  const float c0 = __ldg(p), c1 = __ldg(p + 1), c2 = __ldg(p + f.W), c3 = __ldg(p + f.W + 1);
  return c0 * (1.f - fx) * (1.f - fy) + c1 * fx * (1.f - fy) + c2 * (1.f - fx) * fy +
         c3 * fx * fy;
}

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// o = R v and o = R^T v
__device__ __forceinline__ void mv3(const float R[3][3], const float v[3], float o[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2];
}
__device__ __forceinline__ void mtv3(const float R[3][3], const float v[3], float o[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2];
}

// m (p + R c) and m R (v_lin + w x c) of a body with staged CoM and mass cm
__device__ __forceinline__ void com_terms(const float4 cm, const float R[3][3],
                                          const float p[3], const float v[6], float dp[3],
                                          float dv[3]) {
  const float c[3] = {cm.x, cm.y, cm.z};
  float wc[3], rc[3], rv[3];
  cross3(&v[0], c, wc);
  const float vc[3] = {v[3] + wc[0], v[4] + wc[1], v[5] + wc[2]};
  mv3(R, c, rc);
  mv3(R, vc, rv);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dp[i] = cm.w * (p[i] + rc[i]);
    dv[i] = cm.w * rv[i];
  }
}

// The controller's feedback x (12): [roll, pitch, yaw, CoM x, CoM y, torso z,
// R0 omega, CoM vx, CoM vy, torso vz] and R0, the same on both lanes, and
// the lane's own sole point. The lane walks its own leg; the legs' CoM sums
// are exchanged and added as own + other, then to the torso's term.
__device__ __forceinline__ void feedback(const float* __restrict__ S, const float* __restrict__ T,
                                         int leg, const float pos[3], const float quat[4],
                                         const float vb[6], const float qd5[5],
                                         const float cs[5], const float sn[5], float R0[3][3],
                                         float x[12], float sole[3]) {
  quat_to_rotm(quat, R0);
  float Rw[3][3], pw[3], v[6], p_leg[3], v_leg[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pw[i] = pos[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) Rw[i][k] = R0[i][k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = vb[i];
  const float* bodies = S + kSBody + 16 * (1 + 5 * leg);
  const float* coms = T + kTSBody + 4 * (1 + 5 * leg);
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int ax = axis_of(l);
    const float4 b3 = ld4(bodies + 16 * l + 12);
    const float off[3] = {b3.y, b3.z, b3.w};
    float ro[3];
    mv3(Rw, off, ro);
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[i] += ro[i];
    rotate_frame(ax, cs[l], sn[l], Rw);
    motion_to_child(ax, cs[l], sn[l], off, v);
    v[ax] += qd5[l];
    float dp[3], dv[3];
    com_terms(ld4(coms + 4 * l), Rw, pw, v, dp, dv);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p_leg[i] = l == 0 ? dp[i] : p_leg[i] + dp[i];
      v_leg[i] = l == 0 ? dv[i] : v_leg[i] + dv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) sole[i] = pw[i] + Rw[i][2] * T[kTTipZ];

  float p_acc[3], v_acc[3];
  com_terms(ld4(T + kTSBody), R0, pos, vb, p_acc, v_acc);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p_acc[i] += pair_sum(p_leg[i]);
    v_acc[i] += pair_sum(v_leg[i]);
  }
  const float total = T[kTTotalMass];
  float w_w[3], v_t[3];
  mv3(R0, &vb[0], w_w);
  mv3(R0, &vb[3], v_t);
  x[0] = atan2f(R0[2][1], R0[2][2]);
  x[1] = -asinf(clipf(R0[2][0], -1.f, 1.f));
  x[2] = atan2f(R0[1][0], R0[0][0]);
  x[3] = p_acc[0] / total;
  x[4] = p_acc[1] / total;
  x[5] = pos[2];
  x[6] = w_w[0]; x[7] = w_w[1]; x[8] = w_w[2];
  x[9] = v_acc[0] / total;
  x[10] = v_acc[1] / total;
  x[11] = v_t[2];
}

// Columns of the controller chain's foot-position Jacobian (jf) and joint
// axes (ax) of the lane's leg, in the body frame (models/kinematics.py::
// leg_jacobians): p(q) = Rz(q0) (hip + Rx(q1) (abd + pitch chain)). G: the
// leg geometry (Geom); cs, sn: cos and sin of q5.
__device__ __forceinline__ void leg_jacobian(const float* __restrict__ G, const float q5[5],
                                             const float cs[5], const float sn[5], float side,
                                             float jf[5][3], float ax[5][3]) {
  const float c0 = cs[0], s0 = sn[0], c1 = cs[1], s1 = sn[1];
  float lc[3], ls[3];
  lc[0] = G[kGThigh] * cs[2]; ls[0] = G[kGThigh] * sn[2];
  {
    float s, c;
    sincosf(q5[2] + q5[3], &s, &c);
    lc[1] = G[kGShank] * c; ls[1] = G[kGShank] * s;
    sincosf(q5[2] + q5[3] + q5[4], &s, &c);
    lc[2] = G[kGFoot] * c; ls[2] = G[kGFoot] * s;
  }
  const float u0 = -(ls[0] + ls[1] + ls[2]), u2 = -(lc[0] + lc[1] + lc[2]);
  const float u1 = G[kGAbdY] * side + G[kGAbdYConst];
  const float w0 = G[kGHipX] + u0;
  const float w1 = G[kGHipY] * side + (c1 * u1 - s1 * u2);
  jf[0][0] = -s0 * w0 - c0 * w1; jf[0][1] = c0 * w0 - s0 * w1; jf[0][2] = 0.f;
  const float du1 = -s1 * u1 - c1 * u2, du2 = c1 * u1 - s1 * u2;
  jf[1][0] = -s0 * du1; jf[1][1] = c0 * du1; jf[1][2] = du2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ds = 0.f, dz = 0.f;
#pragma unroll
    for (int i = k; i < 3; ++i) { ds += lc[i]; dz += ls[i]; }
    const float y = -s1 * dz;  // Rz Rx (-ds, 0, dz)
    jf[2 + k][0] = c0 * -ds - s0 * y; jf[2 + k][1] = s0 * -ds + c0 * y; jf[2 + k][2] = c1 * dz;
  }
  ax[0][0] = 0.f; ax[0][1] = 0.f; ax[0][2] = 1.f;
  ax[1][0] = c0; ax[1][1] = s0; ax[1][2] = 0.f;
#pragma unroll
  for (int k = 2; k < 5; ++k) { ax[k][0] = -s0 * c1; ax[k][1] = c0 * c1; ax[k][2] = s1; }
}

// Joint torques (5) of the lane's leg for one low-level period. K: the
// control constants (Ctrl); G: the leg geometry; f3, m3: the leg's force and
// moment of u0; c_own: the leg's contact flag; flight: (1 - c0[0]) (1 -
// c0[1]); ground: under the swing target (on a Field the target's height
// adds the field's there).
// Everything up to the leg's Jacobian reads values that both lanes hold
// alike.
template <class Ground>
__device__ __forceinline__ void control_tau(const float* __restrict__ K,
                                            const float* __restrict__ G, int flags, int leg,
                                            const float R0[3][3], const float x[12],
                                            const float sole[3], const float q5[5],
                                            const float qd5[5], const float cs[5],
                                            const float sn[5], const float f3[3],
                                            const float m3[3], float c_own, float flight,
                                            float t_ll, float cmd_yaw, const float v_int[2],
                                            const Ground& ground, float tau5[5]) {
  const float yaw = x[2];
  const float yaw_des = (flags & kCmdBodyFrame) ? cmd_yaw : K[kXc2];
  float sdy, cdy;
  sincosf(yaw_des - yaw, &sdy, &cdy);
  const float dyaw = atan2f(sdy, cdy);
  const float q_yaw_des = clipf(dyaw - K[kHipyawLead] * (x[8] - K[kXc8]), -K[kHipyawClip],
                                 K[kHipyawClip]);
  const float tau_fly = flight * clipf(K[kFlightYawKd] * (x[8] - K[kXc8]), -K[kTauYawClip],
                                        K[kTauYawClip]);

  // swing clock (walking: one clock for both legs)
  const float t_p = K[kTp];
  const float u = t_ll - t_p * floorf(t_ll / t_p);
  const float frac = u / t_p;
  const float s_ph = sinf(kPi * u / t_p);
  float fz, dfz;
  if (flags & kSin2) {
    fz = K[kH] * s_ph * s_ph;
    dfz = K[kHRate] * sinf(K[kTwoRate] * u);
  } else {
    fz = K[kH] * s_ph;
    dfz = K[kHRate] * cosf(K[kRate] * u);
  }
  const float r = clipf((frac - 0.6f) / 0.4f, 0.f, 1.f);
  const float ramp = r * r;

  // Raibert target (control/reference.py::_raibert_xy)
  float syw, cyw;
  sincosf(yaw, &syw, &cyw);
  float vcx, vcy, kv_x = 0.f, kv_y = 0.f;
  if (flags & kCmdBodyFrame) {
    vcx = cyw * K[kXc9] - syw * K[kXc10];
    vcy = syw * K[kXc9] + cyw * K[kXc10];
  } else {
    vcx = K[kXc9];
    vcy = K[kXc10];
    kv_x = K[kKv] * (x[3] - K[kXc3]);
    kv_y = K[kKv] * (x[4] - K[kXc4]);
  }
  const float ex = x[9] - vcx, ey = x[10] - vcy;
  const float gain = fminf(K[kCaptureGain] + K[kCaptureSched] * sqrtf(ex * ex + ey * ey), 1.f);
  const float kc = gain * K[kKcBase];
  const float vx_m = x[9] + K[kAmY] * x[7];
  const float vy_m = x[10] - K[kAmX] * x[6];
  const float pp = K[kPitchPlace] * (x[1] - K[kPitchNom]);
  const float fx = (x[3] + vx_m * K[kFf] + kc * (vx_m - vcx) + kv_x + pp) - K[kVint] * v_int[0];
  const float fy = (x[4] + vy_m * K[kFf] + kc * (vy_m - vcy) + kv_y) - K[kVint] * v_int[1];

  float sin_td, cos_td;
  sincosf(yaw + K[kYawLead], &sin_td, &cos_td);
  const float retract = K[kRetract] * ramp, damp = K[kTdDamp] * ramp;
  const float over = K[kKpOver] * ramp;
  const float v_des[3] = {K[kTff] * x[9], K[kTff] * x[10], K[kTff] * dfz};

  // the lane's own leg
  const float side = leg == 0 ? 1.f : -1.f;
  float jf[5][3], ax[5][3];
  leg_jacobian(G, q5, cs, sn, side, jf, ax);
  float jfqd[3], vf_w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) acc += jf[j][i] * qd5[j];
    jfqd[i] = acc;
  }
  if (flags & kCompatFrame) mtv3(R0, jfqd, vf_w); else mv3(R0, jfqd, vf_w);

  float tx, ty;
  if (flags & kCompatYaw) {
    tx = fx;
    ty = fy + 0.04f * side;  // reference Y_OFFSET (control/swing.py)
  } else {
    tx = fx - sin_td * K[kYOffset] * side;
    ty = fy + cos_td * K[kYOffset] * side;
  }
  float fz_des = fz;
  if constexpr (std::is_same_v<Ground, Field>) fz_des = fz + field_height(ground, tx, ty);
  const float foot_des[3] = {tx - retract * cyw, ty - retract * syw, fz_des};
  float f_sw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    f_sw[i] = K[kKp] * (foot_des[i] - sole[i]) + K[kKd] * (v_des[i] - vf_w[i]);
  f_sw[0] -= damp * vf_w[0];
  f_sw[1] -= damp * vf_w[1];
  f_sw[2] -= over;
  if (!(flags & kCompatFrame)) {
    const float w[3] = {f_sw[0], f_sw[1], f_sw[2]};
    mtv3(R0, w, f_sw);
  }

  float u_f[3], u_m[3];
  mtv3(R0, f3, u_f);
  mtv3(R0, m3, u_m);
#pragma unroll
  for (int i = 0; i < 3; ++i) { u_f[i] = -u_f[i]; u_m[i] = -u_m[i]; }
  const float tau_pivot = -K[kKpPivot] * clipf(dyaw, -0.3f, 0.3f)
                          - K[kKdPivot] * (qd5[0] + K[kXc8]);
  const float m_yaw = K[kKpHipyaw] * (q_yaw_des - q5[0]) - K[kKdHipyaw] * qd5[0];
  const float vec_z[3] = {R0[2][0] * m_yaw, R0[2][1] * m_yaw, R0[2][2] * m_yaw};
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float t_st = dot3(jf[j], u_f) + dot3(ax[j], u_m);
    float t_sw = dot3(jf[j], f_sw);
    if (j == 0) {
      t_st += tau_pivot;
      t_sw += tau_fly;
    }
    const float t_yaw = clipf(dot3(ax[j], vec_z), -K[kTauYawClip], K[kTauYawClip]);
    tau5[j] = t_st * c_own + (t_sw + t_yaw) * (1.f - c_own);
  }
}

// What the field variant takes besides the flat kernel's inputs: the
// heights (n_env, H, W) with the grid's extent and half-cell steps, each
// env's leg geometry (n_env, kNGeom), t's output, and the (n_env, 2, 2)
// int32 count of sole points below the ground, added to in place; last, what
// the per-env variant takes: its control table (n_env, kNCtrl). The flat
// kernel reads none of it.
struct TickFieldArgs {
  const float* __restrict__ heights;
  const float* __restrict__ geom;
  float* __restrict__ t_out;
  int* __restrict__ below_count;
  int H, W;
  float extent, eps_x, eps_y;
  const float* __restrict__ table;
};

// The plane under envs that each run their own config: tick_kernel<PlaneTable>
// steps the plane's physics (substep() on its Plane base) with the control
// constants of each env's row of TickFieldArgs::table.
struct PlaneTable : Plane {};

// The env's ground: the plane, or its own height field.
template <class Ground>
__device__ __forceinline__ Ground ground_of(const TickFieldArgs& fa, int e);
template <>
__device__ __forceinline__ Plane ground_of<Plane>(const TickFieldArgs&, int) {
  return Plane{};
}
template <>
__device__ __forceinline__ PlaneTable ground_of<PlaneTable>(const TickFieldArgs&, int) {
  return PlaneTable{};
}
template <>
__device__ __forceinline__ Field ground_of<Field>(const TickFieldArgs& fa, int e) {
  return Field{fa.heights + static_cast<size_t>(e) * fa.H * fa.W, fa.H, fa.W, fa.extent,
               fa.eps_x, fa.eps_y};
}

template <class Ground>
__global__ void __launch_bounds__(kThreads)
tick_kernel(const float* __restrict__ consts, const float* __restrict__ tconsts,
            const float* __restrict__ pos_in, const float* __restrict__ quat_in,
            const float* __restrict__ vb_in, const float* __restrict__ q_in,
            const float* __restrict__ qd_in, const float* __restrict__ u0_in,
            const float* __restrict__ c0_in, const float* __restrict__ t0_in,
            const float* __restrict__ cmd_yaw_in, const float* __restrict__ v_int_in,
            const float* __restrict__ minv_in, float* __restrict__ pos_out,
            float* __restrict__ quat_out, float* __restrict__ vb_out,
            float* __restrict__ q_out, float* __restrict__ qd_out,
            float* __restrict__ energy_out, int n_env, double ll_dt, float sub_dt,
            int n_lowlevel, int n_substeps, int flags, TickFieldArgs fa) {
  constexpr bool kOnField = std::is_same_v<Ground, Field>;
  __shared__ __align__(16) float S[kNStaged];
  __shared__ __align__(16) float T[kNTick];
  __shared__ __align__(16) float M[kEnvsPerBlock * kMinvStride];
  const int e0 = blockIdx.x * kEnvsPerBlock;
  stage_model_async(S, consts);
  stage_tick_async(T, tconsts);
  // the control constants: the tick buffer's one config, or the env's own row
  const float* K = T + kTCtrl;
  if constexpr (std::is_same_v<Ground, PlaneTable>) {
    __shared__ __align__(16) float KE[kEnvsPerBlock * kNCtrl];
    stage_table_async(KE, fa.table, e0, n_env);
    K = KE + kNCtrl * (threadIdx.x >> 1);
  }
  async_commit();
  stage_minv_async(M, minv_in, e0, n_env);
  async_commit();

  const int leg = threadIdx.x & 1, slot = threadIdx.x >> 1;
  const int e_own = e0 + slot;
  const int e = min(e_own, n_env - 1);  // a lane past the end repeats the last env
  float pos[3], quat[4], vb[6], q5[5], qd5[5], cs[5], sn[5], f3[3], m3[3];
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
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f3[i] = u0_in[12 * e + 3 * leg + i];
    m3[i] = u0_in[12 * e + 6 + 3 * leg + i];
  }
  const float c0a = c0_in[2 * e], c0b = c0_in[2 * e + 1];
  const float c_own = leg == 0 ? c0a : c0b;
  const float flight = (1.f - c0a) * (1.f - c0b);
  const float v_int[2] = {v_int_in[2 * e], v_int_in[2 * e + 1]};
  const float t0 = t0_in[e], cmd_yaw = cmd_yaw_in[e];
  const float* minv = M + kMinvStride * slot;
  const float ll_dt_f = static_cast<float>(ll_dt);
  const Ground ground = ground_of<Ground>(fa, e);
  // the leg geometry: the control constants' (the tick buffer's one robot or
  // the env's row), or on a field the env's own
  const float* G = K + kLThigh;
  if constexpr (kOnField) G = fa.geom + kNGeom * e;
  joint_sincos(q5, cs, sn);
  async_wait<1>();  // the constants; Minv may still be on its way

  float energy = 0.f;
  float t = t0;  // on a field, the running clock of the plain chain
  int toe = 0, heel = 0;
#pragma unroll 1
  for (int p = 0; p < n_lowlevel; ++p) {
    // flat: p ll_dt rounded once to f32, as the plain version adds a Python
    // float; field: the running t
    float t_ll;
    if constexpr (kOnField)
      t_ll = t;
    else
      t_ll = t0 + static_cast<float>(p * ll_dt);
    float R0[3][3], x[12], sole[3], tau5[5];
    feedback(S, T, leg, pos, quat, vb, qd5, cs, sn, R0, x, sole);
    control_tau(K, G, flags, leg, R0, x, sole, q5, qd5, cs, sn, f3, m3, c_own, flight, t_ll,
                cmd_yaw, v_int, ground, tau5);
    float work = 0.f;
#pragma unroll
    for (int l = 0; l < 5; ++l) work += fmaxf(tau5[l] * qd5[l], 0.f);
    energy += pair_sum(work) * ll_dt_f;
    if (p == 0) async_wait<0>();
#pragma unroll 1
    for (int s = 0; s < n_substeps; ++s) {
      if constexpr (kOnField) {
        const int below =
            substep(S, leg, minv, pos, quat, vb, q5, qd5, cs, sn, tau5, sub_dt, true, ground);
        toe += below & 1;
        heel += below >> 1;
        t += sub_dt;  // the plain chain's t + dt at every substep
      } else {
        substep(S, leg, minv, pos, quat, vb, q5, qd5, cs, sn, tau5, sub_dt, true);
      }
    }
  }

  if (e_own < n_env) {
    if (leg == 0) {  // the pair's copies are bit-equal: lane 0 writes the base
#pragma unroll
      for (int i = 0; i < 3; ++i) pos_out[3 * e + i] = pos[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) quat_out[4 * e + i] = quat[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) vb_out[6 * e + i] = vb[i];
      energy_out[e] = energy;
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

// The length of the tick constant buffer this build expects (the wrapper
// checks it against its own layout).
extern "C" int tick_n_consts() { return kNTick; }

// The columns of the per-env variant's control table.
extern "C" int tick_n_ctrl() { return kNCtrl; }

namespace {

// Every instantiation's launch: checks, device, grid.
template <class Ground>
int launch(const float* consts, const float* tconsts, const float* pos, const float* quat,
           const float* v_base, const float* q, const float* qd, const float* u0,
           const float* c0, const float* t0, const float* cmd_yaw, const float* v_int,
           const float* minv, float* pos_out, float* quat_out, float* v_base_out, float* q_out,
           float* qd_out, float* energy_out, int n_env, double ll_dt, float sub_dt,
           int n_lowlevel, int n_substeps, int flags, const TickFieldArgs& fa, int device,
           void* stream) {
  if (n_env < 0 || n_lowlevel < 1 || n_substeps < 1 ||
      (reinterpret_cast<size_t>(minv) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_env == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_env + kEnvsPerBlock - 1) / kEnvsPerBlock;
  tick_kernel<Ground><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, tconsts, pos, quat, v_base, q, qd, u0, c0, t0, cmd_yaw, v_int, minv, pos_out,
      quat_out, v_base_out, q_out, qd_out, energy_out, n_env, ll_dt, sub_dt, n_lowlevel,
      n_substeps, flags, fa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t) of device `device`; `minv` must be
// 16-byte aligned. Returns the cudaError_t of the launch (0 = success); the
// kernel allocates nothing and does not synchronize.
extern "C" int tick_launch(const float* consts, const float* tconsts, const float* pos,
                           const float* quat, const float* v_base, const float* q,
                           const float* qd, const float* u0, const float* c0, const float* t0,
                           const float* cmd_yaw, const float* v_int, const float* minv,
                           float* pos_out, float* quat_out, float* v_base_out, float* q_out,
                           float* qd_out, float* energy_out, int n_env, double ll_dt,
                           float sub_dt, int n_lowlevel, int n_substeps, int flags, int device,
                           void* stream) {
  return launch<Plane>(consts, tconsts, pos, quat, v_base, q, qd, u0, c0, t0, cmd_yaw, v_int,
                       minv, pos_out, quat_out, v_base_out, q_out, qd_out, energy_out, n_env,
                       ll_dt, sub_dt, n_lowlevel, n_substeps, flags, TickFieldArgs{}, device,
                       stream);
}

// The field variant's launch, as tick_launch's; t0 is the state's t, which
// the kernel advances into t_out; `heights` is (n_env, H, W) with H, W >= 2,
// `geom` (n_env, 8) in the order of the Geom enum, `below_count` (n_env, 2,
// 2) int32.
extern "C" int tick_field_launch(const float* consts, const float* tconsts, const float* pos,
                                 const float* quat, const float* v_base, const float* q,
                                 const float* qd, const float* u0, const float* c0,
                                 const float* t0, const float* cmd_yaw, const float* v_int,
                                 const float* minv, const float* heights, const float* geom,
                                 float* pos_out, float* quat_out, float* v_base_out,
                                 float* q_out, float* qd_out, float* energy_out, float* t_out,
                                 int* below_count, int n_env, int H, int W, float extent,
                                 float eps_x, float eps_y, double ll_dt, float sub_dt,
                                 int n_lowlevel, int n_substeps, int flags, int device,
                                 void* stream) {
  if (H < 2 || W < 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Field>(consts, tconsts, pos, quat, v_base, q, qd, u0, c0, t0, cmd_yaw, v_int,
                       minv, pos_out, quat_out, v_base_out, q_out, qd_out, energy_out, n_env,
                       ll_dt, sub_dt, n_lowlevel, n_substeps, flags,
                       TickFieldArgs{heights, geom, t_out, below_count, H, W, extent, eps_x,
                                     eps_y},
                       device, stream);
}

// The per-env variant's launch, as tick_launch's, with `table` (n_env,
// kNCtrl) in the order of the Ctrl enum: each env's control constants.
extern "C" int tick_table_launch(const float* consts, const float* tconsts, const float* pos,
                                 const float* quat, const float* v_base, const float* q,
                                 const float* qd, const float* u0, const float* c0,
                                 const float* t0, const float* cmd_yaw, const float* v_int,
                                 const float* minv, const float* table, float* pos_out,
                                 float* quat_out, float* v_base_out, float* q_out,
                                 float* qd_out, float* energy_out, int n_env, double ll_dt,
                                 float sub_dt, int n_lowlevel, int n_substeps, int flags,
                                 int device, void* stream) {
  TickFieldArgs fa{};
  fa.table = table;
  return launch<PlaneTable>(consts, tconsts, pos, quat, v_base, q, qd, u0, c0, t0, cmd_yaw,
                            v_int, minv, pos_out, quat_out, v_base_out, q_out, qd_out,
                            energy_out, n_env, ll_dt, sub_dt, n_lowlevel, n_substeps, flags, fa,
                            device, stream);
}

extern "C" const char* tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

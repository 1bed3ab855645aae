// Device functions of the hover kernels (K1 hover_step.cu, K2 and its
// A/B variants hover_rollout.cu): the motor model and one PYB substep of
// a CF2X, with the exact or the small-angle quaternion update.
//
// Transcribes the plain PyTorch version (ops/hover_step.py:
// _motor, substep_plain) operation for operation, in its order, which is
// the order of the JAX kernels (ops/pallas_step.py::_kernel :33,
// _rollout_kernel :202). Every constant arrives folded on the host
// (HoverConsts); built with -fmad=false and without fast math, each
// + - * / sqrt rounds as PyTorch's elementwise ops round it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adrp {

constexpr int HOVER_LANE = 128;
constexpr int HOVER_CH = 13;   // pos xyz, quat xyzw, vel xyz, omega(body) xyz
constexpr int HOVER_ACT = 4;

// Mirrors ops/hover_step.py::HoverConsts field for field.
struct HoverConsts {
  int n_substeps;
  int max_ep_steps;
  float dt, kf, km, arm_s;
  float inv_m_dt, g_dt;        // dt / m, dt * G m / m
  float cwx, cwy, cwz;         // dt / J
  float hdt, hdt2;             // dt / 2, (dt / 2)^2
  float ground_z;
  float hover_rpm, act_mul;    // act_mul = 2 * act_scale
  float tx, ty, tz, init_z;
  float ps1, ps2;              // sin(t)/t = 1 + t2 (ps1 + t2 ps2)
  float pc1, pc2, pc3;         // cos(t) = 1 + t2 (pc1 + t2 (pc2 + t2 pc3))
  float tan04, sin04;
};

// Thrust along body z and the angular-rate increment of one substep,
// constant over a control step (pallas_step.py:40-49).
struct Motor {
  float thrust, dwx, dwy, dwz;
};

__device__ __forceinline__ Motor motor(const float rpm[4],
                                       const HoverConsts& c) {
  float f[4], t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = rpm[i] * rpm[i] * c.kf;
    t[i] = rpm[i] * rpm[i] * c.km;
  }
  Motor m;
  m.thrust = f[0] + f[1] + f[2] + f[3];
  const float tx = (f[0] + f[1] - f[2] - f[3]) * c.arm_s;
  const float ty = (-f[0] + f[1] + f[2] - f[3]) * c.arm_s;
  const float tz = t[0] - t[1] + t[2] - t[3];
  m.dwx = c.cwx * tx;
  m.dwy = c.cwy * ty;
  m.dwz = c.cwz * tz;
  return m;
}

// One PYB substep of the 13 channels in s[] (pallas_step.py:52-119 with
// SMALL = false; :225-293 with either). SMALL: sin(theta)/|omega| and
// cos(theta) as Horner polynomials in theta^2 (no sqrt, no division,
// identity at omega = 0); otherwise sqrtf, sinf, cosf and a true division.
template <bool SMALL>
__device__ __forceinline__ void substep(float s[HOVER_CH], const Motor& m,
                                        const HoverConsts& c) {
  float px = s[0], py = s[1], pz = s[2];
  float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
  float vx = s[7], vy = s[8], vz = s[9];
  float wx = s[10], wy = s[11], wz = s[12];

  const float fx = 2.0f * (qx * qz + qy * qw) * m.thrust;
  const float fy = 2.0f * (qy * qz - qx * qw) * m.thrust;
  const float fz = (1.0f - 2.0f * (qx * qx + qy * qy)) * m.thrust;
  vx = vx + fx * c.inv_m_dt;
  vy = vy + fy * c.inv_m_dt;
  vz = vz + fz * c.inv_m_dt - c.g_dt;
  wx = wx + m.dwx;
  wy = wy + m.dwy;
  wz = wz + m.dwz;
  px = px + c.dt * vx;
  py = py + c.dt * vy;
  pz = pz + c.dt * vz;

  // world angular velocity = R(q) @ omega_body
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r01 = 2.0f * (qx * qy - qz * qw);
  const float r02 = 2.0f * (qx * qz + qy * qw);
  const float r10 = 2.0f * (qx * qy + qz * qw);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r12 = 2.0f * (qy * qz - qx * qw);
  const float r20 = 2.0f * (qx * qz - qy * qw);
  const float r21 = 2.0f * (qy * qz + qx * qw);
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float ox = r00 * wx + r01 * wy + r02 * wz;
  const float oy = r10 * wx + r11 * wy + r12 * wz;
  const float oz = r20 * wx + r21 * wy + r22 * wz;

  // q' = (axis sin(theta), cos(theta)) (x) q, world frame, left multiply
  if (SMALL) {
    const float t2 = (ox * ox + oy * oy + oz * oz) * c.hdt2;
    const float s_n = c.hdt * (1.0f + t2 * (c.ps1 + t2 * c.ps2));
    const float cc = 1.0f + t2 * (c.pc1 + t2 * (c.pc2 + t2 * c.pc3));
    const float ux = ox * s_n, uy = oy * s_n, uz = oz * s_n;
    const float nqx = cc * qx + qw * ux + (uy * qz - uz * qy);
    const float nqy = cc * qy + qw * uy + (uz * qx - ux * qz);
    const float nqz = cc * qz + qw * uz + (ux * qy - uy * qx);
    const float nqw = cc * qw - (ux * qx + uy * qy + uz * qz);
    qx = nqx;
    qy = nqy;
    qz = nqz;
    qw = nqw;
  } else {
    const float n = sqrtf(ox * ox + oy * oy + oz * oz);
    const float safe = fmaxf(n, 1e-12f);
    const float theta = n * c.hdt;
    const float s_n = sinf(theta) / safe;
    const float cc = cosf(theta);
    const float ux = ox * s_n, uy = oy * s_n, uz = oz * s_n;
    const float nqx = cc * qx + qw * ux + (uy * qz - uz * qy);
    const float nqy = cc * qy + qw * uy + (uz * qx - ux * qz);
    const float nqz = cc * qz + qw * uz + (ux * qy - uy * qx);
    const float nqw = cc * qw - (ux * qx + uy * qy + uz * qz);
    const bool keep = n <= 1e-8f;
    qx = keep ? qx : nqx;
    qy = keep ? qy : nqy;
    qz = keep ? qz : nqz;
    qw = keep ? qw : nqw;
  }

  // analytic ground contact (dynamics.pyb_substep)
  if (pz < c.ground_z) {
    pz = c.ground_z;
    vx = 0.0f;
    vy = 0.0f;
    vz = fmaxf(vz, 0.0f);
    wx = 0.0f;
    wy = 0.0f;
    wz = 0.0f;
  }

  s[0] = px; s[1] = py; s[2] = pz;
  s[3] = qx; s[4] = qy; s[5] = qz; s[6] = qw;
  s[7] = vx; s[8] = vy; s[9] = vz;
  s[10] = wx; s[11] = wy; s[12] = wz;
}

}  // namespace adrp

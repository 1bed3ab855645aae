// The race firmware window as one device function, shared by the
// race_window kernel (race_window.cu, K3) and the fused race step kernel
// (race_step.cu, K4).
//
// Replaces the body of gym_pybullet_adrp_tpu/ops/pallas_race.py
// (_window_loop :178): 20 ticks at 500 Hz of PYB physics, the commander's
// poly7 setpoint, the Mellinger sensor biquads, tick gating + tumble, the
// control law, and power distribution + motor pipeline, for ONE agent.
// The statement order follows ops/race_window.py::window_loop_plain, which
// transcribes the Pallas kernel; with -fmad=false every + - * / and sqrt
// rounds as PyTorch's elementwise kernels round, so kernel and plain
// version agree to the last bit except where a libm function (sinf/cosf)
// may differ. A division by a constant is a multiplication by its float32
// reciprocal on both sides (how XLA evaluates it), passed in from Python.
//
// What bounds it on the card: the 58 state channels plus ~60 temporaries
// live in registers for the whole window (all state indices are
// compile-time constants once the tick body is inlined), so the window is
// register- and latency-bound: ~1,500 scalar flops per tick and 232 bytes
// of state read and written once per launch. Spills of the state to local
// memory are what to watch in `-Xptxas -v`.
//
// Mapping: window_loop<COEFFS, L> runs one agent on a group of L
// consecutive lanes of one warp (L = 1 or 4). Every lane of the group
// holds the whole state and computes the serial chains (the quaternion
// update, the control law's rotation chain) itself; the independent items
// of a tick whose cost outweighs a shuffle are dealt out: the three Euler
// angles (two cephes atan2 and an asin, one instruction stream with
// per-lane operands, euler_item), the four motors' PWM pipeline and
// thrust-noise round trip, and, with the planner (COEFFS), the four poly7
// channels x, y, z, yaw: rank c evaluates channel c from its own eight
// coefficients (the kernel loads only those, so a rank holds 8 of the 32
// in registers; all 32 on every rank measured no faster than L = 1,
// PERF.md). Item i is computed by rank i and sent to
// every rank with __shfl_sync, so every value comes from the same
// operations in the same order as with L = 1; with L = 1 the lane
// computes every item with a compile-time index, which folds the
// dealt-out code to each function's own operations. (L = 2, two rounds of
// items, measured slower than both: PERF.md.) Items whose operands would
// need a per-lane select chain (the biquads, the per-axis integrals) or
// that cost less than the shuffle (the motor forces, the per-axis
// velocity) stay redundant. The race_window kernel (K3) picks L from the
// agent count (ops/race_window.py, lane_count); K4 and K5 run L = 4
// without the policy and L = 1 with it (race_step.cuh says why).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace adrp {

constexpr int S_CH = 58;
constexpr int W_CH = 57;
constexpr int NOISE_CH = 7;
constexpr int LANE = 128;

// A Python float literal as JAX sees it next to a float32 row: the
// decimal is rounded to double first, then to float.
#define F(x) ((float)(x))

constexpr double PI_D = 3.141592653589793;
constexpr double RAD2DEG_D = 180.0 / PI_D;
constexpr double DEG2RAD_D = PI_D / 180.0;

// Mirrors ops/race_window.py::WindowConsts (ctypes) field for field.
struct WindowConsts {
  int n_ticks;
  float dt, kf, km, arm_s, inv_dt, inv_dt_g, ground_z, qdt2, hdt, inv_kf;
  float tick_recip;  // x / (1/dt) is evaluated as x * tick_recip
  float acc[5];   // b0 b1 b2 a1 a2 of the accelerometer biquad
  float gyro[5];  // of the gyro biquad
};

// Per-agent window statics (the W block's rows for one agent).
struct WinStatics {
  float sp_pos[3], sp_vel[3], sp_acc[3], sp_rate[3];
  float sp_yaw_quat_deg, sp_thrust;
  bool pos_mode, z_disable, planner, eliminated;
  float t_begin, duration, mass, J[3];
  // poly7 x8,y8,z8,yaw8 (read only with the planner); at L = 4
  // coeffs[0..7] hold the channel of the lane's rank
  float coeffs[32];
};

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  // jnp.clip / torch.clamp: max then min, NaN passes through
  float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}
__device__ __forceinline__ float maxf(float a, float b) {
  // jnp.maximum / torch.maximum propagate NaN
  return (a != a || a > b) ? a : (b != b ? b : (a < b ? b : a));
}
__device__ __forceinline__ float minf(float a, float b) {
  return (a != a || a < b) ? a : (b != b ? b : (a > b ? b : a));
}
__device__ __forceinline__ float rsqrt_exact(float x) {
  return 1.0f / sqrtf(x);
}

// The cephes atan2f(y, x) (asin = false) or asinf(y) (asin = true) in one
// instruction stream, so that lanes computing different angles of a tick
// run together: both reduce to p = poly(z) * w + w, with atan's four
// coefficients or asin's five, then a base, a sign and atan2's quadrant
// shift. With `asin` known at compile time (L = 1) the selects fold and the
// unused reduction is dead, leaving each function's own operations; with
// it per lane, every operation the lane's function performs is performed
// in the same order on the same operands, so the result is the same bits.
__device__ __forceinline__ float euler_item(bool asin, float y, float x) {
  // atan2's reduction
  const float ax = fabsf(x) > F(1e-30) ? x : F(1e-30);
  const float t = y / ax;
  const float at = fabsf(t);
  const bool big_t = at > F(2.414213562373095);
  const bool mid = at > F(0.4142135623730950);
  const float num = big_t ? -1.0f : (mid ? at - 1.0f : at);
  const float den = big_t ? maxf(at, F(1e-30)) : (mid ? at + 1.0f : 1.0f);
  const float xr = num / den;
  // asin's
  const float xs = clipf(y, -1.0f, 1.0f);
  const float as = fabsf(xs);
  const bool big_s = as > 0.5f;
  const float zz = big_s ? 0.5f * (1.0f - as) : as * as;
  const float sq = sqrtf(zz);
  const float z = asin ? zz : xr * xr;
  const float w = asin ? (big_s ? sq : as) : xr;
  const float k1 = asin ? F(2.4181311049e-2) : F(8.05374449538e-2);
  const float k2 = asin ? F(4.5470025998e-2) : -F(1.38776856032e-1);
  const float k3 = asin ? F(7.4953002686e-2) : F(1.99777106478e-1);
  const float k4 = asin ? F(1.6666752422e-1) : -F(3.33329491539e-1);
  const float q1 = asin ? F(4.2163199048e-2) * z + k1 : k1;
  const float p = ((((q1 * z + k2) * z + k3) * z + k4) * z) * w + w;
  const float base_t = big_t ? F(PI_D / 2) : (mid ? F(PI_D / 4) : 0.0f);
  float v = asin ? (big_s ? F(PI_D / 2) - 2.0f * p : p) : base_t + p;
  v = (asin ? xs < 0.0f : t < 0.0f) ? -v : v;
  const float shift = y >= 0.0f ? F(PI_D) : F(-PI_D);
  return (!asin && x < 0.0f) ? v + shift : v;
}

// out[i] = item(i) for the NI items of a tick: with L = 1 the lane
// computes each item with its index known at compile time; with L >= NI,
// rank i of the lane group computes item i (a rank past the last
// recomputes item NI - 1) and sends it to every rank.
template <int L, int NI, typename Item>
__device__ __forceinline__ void split_items(int r, Item item,
                                            float (&out)[NI]) {
  if constexpr (L == 1) {
#pragma unroll
    for (int i = 0; i < NI; ++i) out[i] = item(i);
  } else {
    static_assert(NI <= L, "one item per rank");
    const float v = item(r < NI ? r : NI - 1);
#pragma unroll
    for (int i = 0; i < NI; ++i) out[i] = __shfl_sync(0xffffffffu, v, i, L);
  }
}

// (p, v, a) of one poly7 channel at normalized time s (Horner), as
// pallas_race._window_loop.poly_eval.
__device__ __forceinline__ void poly_channel(const float* c, float s,
                                             float safe_T, float& p,
                                             float& v, float& a) {
  float pv = c[7];
  float dv = 7.0f * c[7];
  float av = 42.0f * c[7];
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    pv = pv * s + c[i];
    if (i >= 1) dv = dv * s + (float)i * c[i];
    if (i >= 2) av = av * s + (float)(i * (i - 1)) * c[i];
  }
  p = pv;
  v = dv / safe_T;
  a = av / (safe_T * safe_T);
}

// The 20-tick window for one agent, state `s` updated in place.
// COEFFS selects the race_window kernel's branch (per-agent poly7
// planner, desired yaw trig per tick); without it the desired yaw is
// window-static (the fused step's FULLSTATE branch). `noise` points at
// this agent's element of tick 0, channel 0 of a (n_ticks, 7, T, 128)
// block whose channel stride is `ncols`, or is null. L lanes of one warp
// run the agent together, `r` being this lane's rank in its group; every
// lane of the warp calls it (the shuffles take the full mask), and every
// rank ends with the same state.
template <bool COEFFS, int L>
__device__ __forceinline__ void window_loop(float (&s)[S_CH],
                                            const WinStatics& w,
                                            const WindowConsts& c,
                                            const float* noise,
                                            long long ncols, int r) {
  static_assert(L == 1 || L == 4, "one lane per agent, or a group of 4");
  const float dt = c.dt, kf = c.kf, km = c.km, arm_s = c.arm_s;
  const float RAD2DEG = F(RAD2DEG_D), DEG2RAD = F(DEG2RAD_D);
  const float inv_mass = 1.0f / w.mass;
  const float inv_Jx = 1.0f / w.J[0];
  const float inv_Jy = 1.0f / w.J[1];
  const float inv_Jz = 1.0f / w.J[2];
  float xc_sx = 0.0f, xc_sy = 0.0f;
  if (!COEFFS) {
    float dy0 = w.sp_yaw_quat_deg * DEG2RAD;
    xc_sx = cosf(dy0);
    xc_sy = sinf(dy0);
  }
  // constant-folded voltage curve (Python double arithmetic)
  const double k_in = 60.0 / 65535.0;
  const float kq = F(-0.0006239 * k_in * k_in * (65535.0 / 3.0));
  const float kl = F(0.088 * k_in * (65535.0 / 3.0));
  const float m_dt = F(1.0 / 500.0);
  const float inv_m_dt = F(1.0 / (1.0 / 500.0));

#pragma unroll 1
  for (int i = 0; i < c.n_ticks; ++i) {
    float px = s[0], py = s[1], pz = s[2];
    float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
    float vx = s[7], vy = s[8], vz = s[9];
    float wx = s[10], wy = s[11], wz = s[12];
    float rpm[4] = {s[13], s[14], s[15], s[16]};

    // ---- 1. physics substep (PYB, CF2X) --------------------------------
    float f[4], tq[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      f[m] = rpm[m] * rpm[m] * kf;
      tq[m] = rpm[m] * rpm[m] * km;
    }
    float thrust = f[0] + f[1] + f[2] + f[3];
    float tx = (f[0] + f[1] - f[2] - f[3]) * arm_s;
    float ty = (-f[0] + f[1] + f[2] - f[3]) * arm_s;
    float tz = tq[0] - tq[1] + tq[2] - tq[3];
    float fx = 2.0f * (qx * qz + qy * qw) * thrust;
    float fy = 2.0f * (qy * qz - qx * qw) * thrust;
    float fz = (1.0f - 2.0f * (qx * qx + qy * qy)) * thrust;
    const float* tn = nullptr;
    if (noise != nullptr) {
      tn = noise + (long long)i * NOISE_CH * ncols;
      fx = fx + tn[0];
      fy = fy + tn[ncols];
      fz = fz + tn[2 * ncols];
    }
    vx = vx + dt * fx * inv_mass;
    vy = vy + dt * fy * inv_mass;
    vz = vz + dt * (fz * inv_mass - F(9.8));
    wx = wx + dt * tx * inv_Jx;
    wy = wy + dt * ty * inv_Jy;
    wz = wz + dt * tz * inv_Jz;
    px = px + dt * vx;
    py = py + dt * vy;
    pz = pz + dt * vz;
    float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    float r01 = 2.0f * (qx * qy - qz * qw);
    float r02 = 2.0f * (qx * qz + qy * qw);
    float r10 = 2.0f * (qx * qy + qz * qw);
    float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    float r12 = 2.0f * (qy * qz - qx * qw);
    float r20 = 2.0f * (qx * qz - qy * qw);
    float r21 = 2.0f * (qy * qz + qx * qw);
    float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    float ox = r00 * wx + r01 * wy + r02 * wz;
    float oy = r10 * wx + r11 * wy + r12 * wz;
    float oz = r20 * wx + r21 * wy + r22 * wz;
    float n2 = ox * ox + oy * oy + oz * oz;
    float t2 = n2 * c.qdt2;
    float t4 = t2 * t2;
    float t6 = t4 * t2;
    float s_n = c.hdt * (1.0f - t2 * F(1.0 / 6.0) + t4 * F(1.0 / 120.0)
                         - t6 * F(1.0 / 5040.0));
    float cth = 1.0f - t2 * 0.5f + t4 * F(1.0 / 24.0) - t6 * F(1.0 / 720.0);
    float ux = ox * s_n, uy = oy * s_n, uz = oz * s_n;
    float nqx = cth * qx + qw * ux + (uy * qz - uz * qy);
    float nqy = cth * qy + qw * uy + (uz * qx - ux * qz);
    float nqz = cth * qz + qw * uz + (ux * qy - uy * qx);
    float nqw = cth * qw - (ux * qx + uy * qy + uz * qz);
    bool keep = n2 <= F(1e-16);
    qx = keep ? qx : nqx;
    qy = keep ? qy : nqy;
    qz = keep ? qz : nqz;
    qw = keep ? qw : nqw;
    bool below = pz < c.ground_z;
    pz = below ? c.ground_z : pz;
    vx = below ? 0.0f : vx;
    vy = below ? 0.0f : vy;
    vz = below ? maxf(vz, 0.0f) : vz;
    wx = below ? 0.0f : wx;
    wy = below ? 0.0f : wy;
    wz = below ? 0.0f : wz;

    float sinr = 2.0f * (qw * qx + qy * qz);
    float cosr = 1.0f - 2.0f * (qx * qx + qy * qy);
    float sinp = clipf(2.0f * (qw * qy - qz * qx), -1.0f, 1.0f);
    float siny = 2.0f * (qw * qz + qx * qy);
    float cosy_r = 1.0f - 2.0f * (qy * qy + qz * qz);
    float ang[3];
    split_items<L, 3>(r, [&](int k) {
      return euler_item(k == 1, k == 0 ? sinr : (k == 1 ? sinp : siny),
                        k == 0 ? cosr : (k == 1 ? 1.0f : cosy_r));
    }, ang);
    const float roll = ang[0], pitch = ang[1], yaw = ang[2];
    float cp2 = maxf(1.0f - sinp * sinp, F(1e-12));
    float inv_cp = rsqrt_exact(cp2);
    float cp = cp2 * inv_cp;
    float sp_ = sinp;
    float cyw = cosy_r * inv_cp;
    float syw = siny * inv_cp;
    float cr = cosr * inv_cp;
    float sr = sinr * inv_cp;

    // ---- 2. commander per-tick setpoint ---------------------------------
    float tick = s[53];
    float t_now = tick * dt;
    float spx, spy, spz, svx, svy, svz, sax, say, saz, srx, sry, srz;
    float desired_yaw_deg;
    if constexpr (COEFFS) {
      float safe_T = w.duration > 0.0f ? w.duration : 1.0f;
      float sn = clipf((t_now - w.t_begin) / safe_T, 0.0f, 1.0f);
      float pe[4][3];
      if constexpr (L == 1) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          poly_channel(w.coeffs + 8 * ch, sn, safe_T, pe[ch][0], pe[ch][1],
                       pe[ch][2]);
      } else {
        // rank c holds channel c's coefficients (L == 4 channels)
        float own[3];
        poly_channel(w.coeffs, sn, safe_T, own[0], own[1], own[2]);
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            pe[ch][k] = __shfl_sync(0xffffffffu, own[k], ch, L);
      }
      bool pl = w.planner;
      spx = pl ? pe[0][0] : w.sp_pos[0];
      spy = pl ? pe[1][0] : w.sp_pos[1];
      spz = pl ? pe[2][0] : w.sp_pos[2];
      svx = pl ? pe[0][1] : w.sp_vel[0];
      svy = pl ? pe[1][1] : w.sp_vel[1];
      svz = pl ? pe[2][1] : w.sp_vel[2];
      sax = pl ? pe[0][2] : w.sp_acc[0];
      say = pl ? pe[1][2] : w.sp_acc[1];
      saz = pl ? pe[2][2] : w.sp_acc[2];
      srx = pl ? 0.0f : w.sp_rate[0];
      sry = pl ? 0.0f : w.sp_rate[1];
      srz = pl ? pe[3][1] * RAD2DEG : w.sp_rate[2];
      desired_yaw_deg = pl ? pe[3][0] * RAD2DEG : w.sp_yaw_quat_deg;
    } else {
      spx = w.sp_pos[0]; spy = w.sp_pos[1]; spz = w.sp_pos[2];
      svx = w.sp_vel[0]; svy = w.sp_vel[1]; svz = w.sp_vel[2];
      sax = w.sp_acc[0]; say = w.sp_acc[1]; saz = w.sp_acc[2];
      srx = w.sp_rate[0]; sry = w.sp_rate[1]; srz = w.sp_rate[2];
      desired_yaw_deg = w.sp_yaw_quat_deg;
    }

    // ---- 3. Mellinger sensors --------------------------------------------
    float rate_r = (roll - s[21]) * c.inv_dt;
    float rate_p = (pitch - s[22]) * c.inv_dt;
    float rate_y = (yaw - s[23]) * c.inv_dt;
    float accx = (vx - s[24]) * c.inv_dt_g;
    float accy = (vy - s[25]) * c.inv_dt_g;
    float accz = (vz - s[26]) * c.inv_dt_g + 1.0f;
    float a00 = cp * cyw;
    float a01 = -cp * syw;
    float a02 = sp_;
    float a10 = cr * syw + sr * sp_ * cyw;
    float a11 = cr * cyw - sr * sp_ * syw;
    float a12 = -sr * cp;
    float a20 = sr * syw - cr * sp_ * cyw;
    float a21 = sr * cyw + cr * sp_ * syw;
    float a22 = cr * cp;
    float ab[3];
    ab[0] = a00 * accx + a10 * accy + a20 * accz;
    ab[1] = a01 * accx + a11 * accy + a21 * accz;
    ab[2] = a02 * accx + a12 * accy + a22 * accz;
    float gin[3] = {rate_r * RAD2DEG, rate_p * RAD2DEG, rate_y * RAD2DEG};
    float acc_d1[3], acc_d2[3], gy_d1[3], gy_d2[3], gyro_f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float d1 = s[27 + k], d2 = s[30 + k];
      float d0 = ab[k] - d1 * c.acc[3] - d2 * c.acc[4];
      acc_d1[k] = d0;
      acc_d2[k] = d1;
      float g1 = s[33 + k], g2 = s[36 + k];
      float g0 = gin[k] - g1 * c.gyro[3] - g2 * c.gyro[4];
      gyro_f[k] = g0 * c.gyro[0] + g1 * c.gyro[1] + g2 * c.gyro[2];
      gy_d1[k] = g0;
      gy_d2[k] = g1;
    }

    // ---- 4. tick gating + tumble -----------------------------------------
    bool tumbling = accz < -0.5f;
    float tumble_counter = tumbling ? s[56] + 1.0f : 0.0f;
    bool tumbled = tumble_counter >= 30.0f;
    float cur_time = tick * c.tick_recip;
    bool att_due = cur_time - s[55] > F(0.002);
    bool pos_due = att_due && (cur_time - s[54] > F(0.01));
    bool run = att_due && !tumbled;

    // ---- 5. Mellinger control law ----------------------------------------
    float r_err[3] = {spx - px, spy - py, spz - pz};
    float v_err[3] = {svx - vx, svy - vy, svz - vz};
    float i_ep[3];
    i_ep[0] = clipf(s[39] + r_err[0] * m_dt, F(-2.0), F(2.0));
    i_ep[1] = clipf(s[40] + r_err[1] * m_dt, F(-2.0), F(2.0));
    i_ep[2] = clipf(s[41] + r_err[2] * m_dt, F(-0.4), F(0.4));
    float tf_x = F(0.032) * sax + F(0.4) * r_err[0] + F(0.2) * v_err[0]
                 + F(0.05) * i_ep[0];
    float tf_y = F(0.032) * say + F(0.4) * r_err[1] + F(0.2) * v_err[1]
                 + F(0.05) * i_ep[1];
    float tf_z = F(0.032) * (saz + F(9.81)) + F(1.25) * r_err[2]
                 + F(0.4) * v_err[2] + F(0.05) * i_ep[2];
    bool pm = w.pos_mode;
    float t0_ = pm ? tf_x : 0.0f;
    float t1_ = pm ? tf_y : 0.0f;
    float t2_ = pm ? tf_z : 1.0f;
    float t0 = pm ? t0_ : t0_ * cyw - t1_ * syw;
    float t1 = pm ? t1_ : t0_ * syw + t1_ * cyw;
    float t2v = t2_;

    float c0x = cyw * cp, c0y = syw * cp, c0z = -sp_;
    float c1x = cyw * sp_ * sr - syw * cr;
    float c1y = syw * sp_ * sr + cyw * cr;
    float c1z = cp * sr;
    float c2x = cyw * sp_ * cr + syw * sr;
    float c2y = syw * sp_ * cr - cyw * sr;
    float c2z = cp * cr;
    float current_thrust = t0 * c2x + t1 * c2y + t2v * c2z;

    float inv_t = rsqrt_exact(maxf(t0 * t0 + t1 * t1 + t2v * t2v, F(1e-24)));
    float zdx = t0 * inv_t, zdy = t1 * inv_t, zdz = t2v * inv_t;
    float xcx, xcy;
    if (COEFFS) {
      float dy_rad = desired_yaw_deg * DEG2RAD;
      xcx = cosf(dy_rad);
      xcy = sinf(dy_rad);
    } else {
      xcx = xc_sx;
      xcy = xc_sy;
    }
    float ydx = zdy * 0.0f - zdz * xcy;
    float ydy = zdz * xcx - zdx * 0.0f;
    float ydz = zdx * xcy - zdy * xcx;
    float inv_y = rsqrt_exact(maxf(ydx * ydx + ydy * ydy + ydz * ydz,
                                   F(1e-24)));
    ydx = ydx * inv_y;
    ydy = ydy * inv_y;
    ydz = ydz * inv_y;
    float xdx = ydy * zdz - ydz * zdy;
    float xdy = ydz * zdx - ydx * zdz;
    float xdz = ydx * zdy - ydy * zdx;

    float eR_x = (zdx * c1x + zdy * c1y + zdz * c1z)
                 - (ydx * c2x + ydy * c2y + ydz * c2z);
    float eR_y = -((xdx * c2x + xdy * c2y + xdz * c2z)
                   - (zdx * c0x + zdy * c0y + zdz * c0z));
    float eR_z = (ydx * c0x + ydy * c0y + ydz * c0z)
                 - (xdx * c1x + xdy * c1y + xdz * c1z);

    float om_r = gyro_f[0] * DEG2RAD;
    float om_p = -gyro_f[1] * DEG2RAD;
    float om_y = gyro_f[2] * DEG2RAD;
    float sp_om_r = srx * DEG2RAD;
    float sp_om_p = sry * DEG2RAD;
    float ew_x = sp_om_r - om_r;
    float ew_y = -sp_om_p - om_p;
    float ew_z = srz * DEG2RAD - om_y;
    float err_d_roll = ((sp_om_r - s[47]) - (om_r - s[45])) * inv_m_dt;
    float err_d_pitch = ((-sp_om_p - s[48]) - (om_p - s[46])) * inv_m_dt;

    float i_m[3];
    i_m[0] = clipf(s[42] - eR_x * m_dt, F(-1.0), F(1.0));
    i_m[1] = clipf(s[43] - eR_y * m_dt, F(-1.0), F(1.0));
    i_m[2] = clipf(s[44] - eR_z * m_dt, F(-1500.0), F(1500.0));

    float M_x = F(-70000.0) * eR_x + F(20000.0) * ew_x + F(0.0) * i_m[0]
                + F(200.0) * err_d_roll;
    float M_y = F(-70000.0) * eR_y + F(20000.0) * ew_y + F(0.0) * i_m[1]
                + F(200.0) * err_d_pitch;
    float M_z = F(-60000.0) * eR_z + F(12000.0) * ew_z + F(500.0) * i_m[2];

    float thrust_out = w.z_disable ? w.sp_thrust
                                   : F(132000.0) * current_thrust;
    bool pos_thrust = thrust_out > 0.0f;
    float roll_out = pos_thrust ? clipf(M_x, -32000.0f, 32000.0f) : 0.0f;
    float pitch_out = pos_thrust ? clipf(M_y, -32000.0f, 32000.0f) : 0.0f;
    float yaw_out = pos_thrust ? clipf(-M_z, -32000.0f, 32000.0f) : 0.0f;
    if (!pos_thrust) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        i_ep[k] = 0.0f;
        i_m[k] = 0.0f;
      }
    }

    // gate: hold outputs/integrals when the attitude loop doesn't fire
    float ctl_r = run ? roll_out : s[49];
    float ctl_p = run ? pitch_out : s[50];
    float ctl_y = run ? yaw_out : s[51];
    float ctl_t = run ? thrust_out : s[52];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      i_ep[k] = run ? i_ep[k] : s[39 + k];
      i_m[k] = run ? i_m[k] : s[42 + k];
    }
    float new_prev_om_r = run ? om_r : s[45];
    float new_prev_om_p = run ? om_p : s[46];
    float new_prev_sp_r = run ? sp_om_r : s[47];
    float new_prev_sp_p = run ? -sp_om_p : s[48];

    // ---- 6. power distribution + motor pipeline --------------------------
    float r2 = ctl_r * 0.5f;
    float p2 = ctl_p * 0.5f;
    float mth[4] = {
        ctl_t - r2 + p2 + ctl_y,
        ctl_t - r2 - p2 - ctl_y,
        ctl_t + r2 - p2 + ctl_y,
        ctl_t + r2 + p2 - ctl_y,
    };
    // motor m's PWM pipeline, then the thrust round trip of new_rpm[m]
    // (the firmware's motor 3 - m); without noise the round trip is the
    // identity and only the [3,2,1,0] motor reorder survives
    auto pwm_rpm = [&](float mt) {
      float cl = clipf(mt, 0.0f, 65535.0f);
      float pwm = minf((kq * cl + kl) * cl, 65535.0f);
      pwm = tumbled ? 0.0f : pwm;
      float cl2 = clipf(pwm, 20000.0f, 65535.0f);
      return F(0.2685) * cl2 + F(4070.3);
    };
    auto round_trip = [&](float rr, int m) {
      float thr = kf * rr * rr;
      thr = thr + tn[(3 + m) * ncols];
      float mp = (sqrtf(maxf(thr, 0.0f) * c.inv_kf) - F(4070.3))
                 * F(1.0 / 0.2685);
      mp = clipf(mp, 20000.0f, 65535.0f);
      return F(0.2685) * mp + F(4070.3);
    };
    // item m: motor 3 - m's PWM (a select chain picks its operand where m
    // is a lane's rank); the noise test is made once for all four items,
    // as one per item cost K3 and the policy instantiation ~5% (PERF.md)
    auto motor = [&](int m) {
      return pwm_rpm(m == 0 ? mth[3] : m == 1 ? mth[2] : m == 2 ? mth[1]
                                                            : mth[0]);
    };
    float new_rpm[4];
    if (noise == nullptr)
      split_items<L, 4>(r, motor, new_rpm);
    else
      split_items<L, 4>(r, [&](int m) { return round_trip(motor(m), m); },
                        new_rpm);

    float new_last_att = (att_due && !tumbled) ? cur_time : s[55];
    float new_last_pos = (pos_due && !tumbled) ? cur_time : s[54];
    float new_err = tumbled ? 1.0f : s[57];

    s[0] = px; s[1] = py; s[2] = pz;
    s[3] = qx; s[4] = qy; s[5] = qz; s[6] = qw;
    s[7] = vx; s[8] = vy; s[9] = vz;
    s[10] = wx; s[11] = wy; s[12] = wz;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s[13 + m] = w.eliminated ? 0.0f : new_rpm[m];
      s[17 + m] = w.eliminated ? 0.0f : rpm[m];
    }
    s[21] = roll; s[22] = pitch; s[23] = yaw;
    s[24] = vx; s[25] = vy; s[26] = vz;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[27 + k] = acc_d1[k];
      s[30 + k] = acc_d2[k];
      s[33 + k] = gy_d1[k];
      s[36 + k] = gy_d2[k];
      s[39 + k] = i_ep[k];
      s[42 + k] = i_m[k];
    }
    s[45] = new_prev_om_r; s[46] = new_prev_om_p;
    s[47] = new_prev_sp_r; s[48] = new_prev_sp_p;
    s[49] = ctl_r; s[50] = ctl_p; s[51] = ctl_y; s[52] = ctl_t;
    s[53] = tick + 1.0f;
    s[54] = new_last_pos;
    s[55] = new_last_att;
    s[56] = tumble_counter;
    s[57] = new_err;
  }
}

}  // namespace adrp

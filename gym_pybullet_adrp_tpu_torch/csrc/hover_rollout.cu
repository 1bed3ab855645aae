// hover_rollout: n_steps hover control steps per launch (K2), and the
// A/B variants K7 and K8 as instantiations of the same template.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_step.py::hover_rollout (:369,
// pallas_call :416, body _rollout_kernel :202), and
// results/hover_vpu/ab_v2.py::hover_rollout_v2 (:163, pallas_call :190)
// and results/hover_vpu/ab_v3.py::hover_rollout_v3 (:164, pallas_call
// :184). Wrappers and plain PyTorch version: ops/hover_step.py
// (hover_rollout, hover_rollout_plain) and ops/hover_variants.py.
//
// Template flags: SMALL selects the small-angle quaternion update (else
// the exact one), NEAR_SQRT the termination test sqrt(e2) < 1e-4 (else
// e2 < 1e-8). K2: <true, false> by default, <false, true> with
// smallangle=False. K7: <false, false>, <false, true> with exact_sqrt.
// K8: <true, false>. <true, true> is not instantiated.
//
// Per step: the action (4 draws in [-act_scale, act_scale)), rpm, 8
// substeps (hover_step.cuh), the HoverAviary reward, done (near target,
// bounds, trig-free tilt test, timeout) and the per-channel autoreset.
// The draws come from Philox4x32-10, counter (step, env, 0, 0) and key
// (seed, 0): one call gives the 4 motor draws, each 32-bit output mapped
// to [1, 2) as (bits >> 9) | 0x3F800000. Or, with `actions` non-null,
// from an (n_steps, 4, T, 128) block: the injected mode, in which the
// plain version and the JAX package's math compute the same function.
//
// Mapping: one thread per env, the 13 channels, the episode step count
// and the reward sum in registers for the whole launch; per env the
// launch reads 13 floats and writes 14 (15 with the reset count).
// Bound: operations, ~8 x 110 float ops per env-step with a sqrtf and
// a division on the exact path plus sinf/cosf, and one dependent chain
// per thread: at 4096 envs there are 128 warps in all, one per SM
// sub-partition in use whatever the block size (THREADS in
// ops/hover_step.py). Latency, not issue rate, sets the time at that
// size; more envs (65536) fill the SMs.

#include "hover_step.cuh"

namespace adrp {

// Random123's Philox4x32 round constants
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, ctr.x);
    const uint32_t lo0 = PHILOX_M0 * ctr.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, ctr.z);
    const uint32_t lo1 = PHILOX_M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return ctr;
}

__device__ __forceinline__ float bits_to_action(uint32_t bits, float mul) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u);  // [1, 2)
  return (u - 1.5f) * mul;
}

template <bool SMALL, bool NEAR_SQRT>
__global__ void hover_rollout_kernel(const float* __restrict__ st,
                                     const float* __restrict__ actions,
                                     float* __restrict__ out,
                                     float* __restrict__ acc_out,
                                     float* __restrict__ resets_out,
                                     long long B, int n_steps, uint32_t seed,
                                     HoverConsts c) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float s[HOVER_CH];
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) s[k] = st[k * B + e];
  int steps = 0;
  float acc = 0.0f, resets = 0.0f;
  for (int k = 0; k < n_steps; ++k) {
    float a[HOVER_ACT];
    if (actions != nullptr) {
      const float* ak = actions + (long long)k * HOVER_ACT * B;
#pragma unroll
      for (int i = 0; i < HOVER_ACT; ++i) a[i] = ak[i * B + e];
    } else {
      const uint4 bits = philox4x32_10(
          make_uint4((uint32_t)k, (uint32_t)e, (uint32_t)(e >> 32), 0u),
          seed, 0u);
      a[0] = bits_to_action(bits.x, c.act_mul);
      a[1] = bits_to_action(bits.y, c.act_mul);
      a[2] = bits_to_action(bits.z, c.act_mul);
      a[3] = bits_to_action(bits.w, c.act_mul);
    }
    float rpm[HOVER_ACT];
#pragma unroll
    for (int i = 0; i < HOVER_ACT; ++i)
      rpm[i] = c.hover_rpm * (1.0f + 0.05f * a[i]);
    const Motor m = motor(rpm, c);
    for (int i = 0; i < c.n_substeps; ++i) substep<SMALL>(s, m, c);

    // HoverAviary reward / termination / truncation / autoreset
    const float ex = s[0] - c.tx, ey = s[1] - c.ty, ez = s[2] - c.tz;
    const float e2 = ex * ex + ey * ey + ez * ez;
    const float reward = fmaxf(2.0f - e2 * e2, 0.0f);
    const float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
    const float sinr = 2.0f * (qw * qx + qy * qz);
    const float cosr = 1.0f - 2.0f * (qx * qx + qy * qy);
    const bool roll_out = (cosr <= 0.0f) || (fabsf(sinr) > c.tan04 * cosr);
    const float sinp = 2.0f * (qw * qy - qz * qx);
    const bool pitch_out = fabsf(sinp) > c.sin04;
    steps = steps + 1;
    const bool near = NEAR_SQRT ? (sqrtf(e2) < 1e-4f) : (e2 < 1e-8f);
    const bool done = near || (fabsf(s[0]) > 1.5f) || (fabsf(s[1]) > 1.5f) ||
                      (s[2] > 2.0f) || roll_out || pitch_out ||
                      (steps > c.max_ep_steps);
    if (done) {
#pragma unroll
      for (int i = 0; i < HOVER_CH; ++i) s[i] = 0.0f;
      s[2] = c.init_z;
      s[6] = 1.0f;
      steps = 0;
      resets = resets + 1.0f;
    }
    acc = acc + reward;
  }
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) out[k * B + e] = s[k];
  acc_out[e] = acc;
  if (resets_out != nullptr) resets_out[e] = resets;
}

template <bool SMALL, bool NEAR_SQRT>
void launch(const float* st, const float* actions, float* out, float* acc,
            float* resets, long long B, int n_steps, uint32_t seed,
            const HoverConsts& c, int threads, cudaStream_t stream) {
  const long long blocks = (B + threads - 1) / threads;
  hover_rollout_kernel<SMALL, NEAR_SQRT><<<(unsigned)blocks, threads, 0,
                                           stream>>>(
      st, actions, out, acc, resets, B, n_steps, seed, c);
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). `actions` and
// `resets` may be null. The caller makes the stream's device current.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// <smallangle, near_sqrt>, which no wrapper uses and which is not built).
extern "C" int adrp_hover_rollout(const float* st, const float* actions,
                                  float* out, float* acc, float* resets,
                                  long long B, int n_steps, unsigned seed,
                                  int smallangle, int near_sqrt,
                                  const adrp::HoverConsts* c, int threads,
                                  void* stream) {
  if (smallangle && near_sqrt) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (smallangle) {
    adrp::launch<true, false>(st, actions, out, acc, resets, B, n_steps,
                              seed, *c, threads, s);
  } else {
    if (near_sqrt)
      adrp::launch<false, true>(st, actions, out, acc, resets, B, n_steps,
                                seed, *c, threads, s);
    else
      adrp::launch<false, false>(st, actions, out, acc, resets, B, n_steps,
                                 seed, *c, threads, s);
  }
  return (int)cudaGetLastError();
}

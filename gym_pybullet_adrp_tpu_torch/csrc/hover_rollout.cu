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
// Mapping: one env per group of L consecutive lanes of a warp (L = 1 or
// 4, chosen by the wrapper from the batch: ops/hover_step.py
// lane_count). Every rank of a group holds the 13 channels, the episode
// step count and the reward sum in registers for the whole launch and
// runs the substeps and the step's tail itself (hover_step.cuh says why
// the chain is not dealt out). What does not depend on the state is:
// over each run of L steps, rank j draws the action of step k + j
// (Philox, or a load in the injected mode) and computes its rpm and motor
// terms, and the group exchanges the four terms of each step with
// __shfl_sync. Rank 0 writes the env's outputs. Per env the launch reads
// 13 floats and writes 14 (15 with the reset count).
// Bound: operations, ~8 x 120 float ops per env-step on the small-angle
// path (sqrtf, a division, sinf and cosf more on the exact one), in one
// dependent chain per env. At 4096 envs and L = 1 there are 128 warps,
// one on each of 128 of the card's 528 SM sub-partitions: latency and
// one warp's issue rate set the time. A group of L lanes puts L times as
// many warps on the card, each lane's stream shorter by (L - 1) / L of
// the per-step draw and motor terms; at 65536 envs L = 1 already fills
// the sub-partitions.

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

// v of rank `src` of this lane's group of L lanes (every lane of the warp
// calls it)
template <int L>
__device__ __forceinline__ float group_shfl(float v, int src) {
  if constexpr (L == 1) {
    return v;
  } else {
    return __shfl_sync(0xffffffffu, v, src, L);
  }
}

// The rpm and motor terms of step k of env e: the action drawn (Philox,
// counter (k, e), key (seed, 0)) or read from the injected block.
__device__ __forceinline__ Motor step_motor(const float* actions, int k,
                                            long long e, long long B,
                                            uint32_t seed,
                                            const HoverConsts& c) {
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
  return motor(rpm, c);
}

template <bool SMALL, bool NEAR_SQRT, int L>
__global__ void hover_rollout_kernel(const float* __restrict__ st,
                                     const float* __restrict__ actions,
                                     float* __restrict__ out,
                                     float* __restrict__ acc_out,
                                     float* __restrict__ resets_out,
                                     long long B, int n_steps, uint32_t seed,
                                     HoverConsts c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long e = t / L;
  const int r = (int)(t % L);
  // B * L is a multiple of 32: whole warps leave together
  if (e >= B) return;
  float s[HOVER_CH];
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) s[k] = st[k * B + e];
  int steps = 0;
  float acc = 0.0f, resets = 0.0f;
  for (int k0 = 0; k0 < n_steps; k0 += L) {
    // rank r: the motor terms of step k0 + r
    Motor mine = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k0 + r < n_steps) mine = step_motor(actions, k0 + r, e, B, seed, c);
    // the step loop is not unrolled and the substep loop by at most 2
    // (hover_step.cuh): the code stays within the instruction cache
    // (unrolled 8 x L, K2's code grew 3-14x and ran 1.6-3x slower on an
    // H100, PERF.md)
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
      if (k0 + i >= n_steps) break;  // the same for every lane
      const Motor m = {group_shfl<L>(mine.thrust, i),
                       group_shfl<L>(mine.dwx, i),
                       group_shfl<L>(mine.dwy, i),
                       group_shfl<L>(mine.dwz, i)};
#pragma unroll SUBSTEP_UNROLL<SMALL>
      for (int j = 0; j < c.n_substeps; ++j) substep<SMALL>(s, m, c);

      // HoverAviary reward / termination / truncation / autoreset
      const float ex = s[0] - c.tx, ey = s[1] - c.ty, ez = s[2] - c.tz;
      const float e2 = ex * ex + ey * ey + ez * ez;
      const float reward = fmaxf(2.0f - e2 * e2, 0.0f);
      const float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
      const float sinr = 2.0f * (qw * qx + qy * qz);
      const float cosr = 1.0f - 2.0f * (qx * qx + qy * qy);
      const bool roll_out =
          (cosr <= 0.0f) || (fabsf(sinr) > c.tan04 * cosr);
      const float sinp = 2.0f * (qw * qy - qz * qx);
      const bool pitch_out = fabsf(sinp) > c.sin04;
      steps = steps + 1;
      const bool near = NEAR_SQRT ? (sqrtf(e2) < 1e-4f) : (e2 < 1e-8f);
      const bool done = near || (fabsf(s[0]) > 1.5f) ||
                        (fabsf(s[1]) > 1.5f) || (s[2] > 2.0f) || roll_out ||
                        pitch_out || (steps > c.max_ep_steps);
      if (done) {
#pragma unroll
        for (int q = 0; q < HOVER_CH; ++q) s[q] = 0.0f;
        s[2] = c.init_z;
        s[6] = 1.0f;
        steps = 0;
        resets = resets + 1.0f;
      }
      acc = acc + reward;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int k = 0; k < HOVER_CH; ++k) out[k * B + e] = s[k];
    acc_out[e] = acc;
    if (resets_out != nullptr) resets_out[e] = resets;
  }
}

template <bool SMALL, bool NEAR_SQRT, int L>
void launch(const float* st, const float* actions, float* out, float* acc,
            float* resets, long long B, int n_steps, uint32_t seed,
            const HoverConsts& c, int threads, cudaStream_t stream) {
  const long long blocks = (B * L + threads - 1) / threads;
  hover_rollout_kernel<SMALL, NEAR_SQRT, L><<<(unsigned)blocks, threads, 0,
                                              stream>>>(
      st, actions, out, acc, resets, B, n_steps, seed, c);
}

template <bool SMALL, bool NEAR_SQRT>
int launch_lanes(const float* st, const float* actions, float* out,
                 float* acc, float* resets, long long B, int n_steps,
                 uint32_t seed, const HoverConsts& c, int lanes,
                 int threads, cudaStream_t s) {
  switch (lanes) {
    case 1:
      launch<SMALL, NEAR_SQRT, 1>(st, actions, out, acc, resets, B, n_steps,
                                  seed, c, threads, s);
      break;
    case 4:
      launch<SMALL, NEAR_SQRT, 4>(st, actions, out, acc, resets, B, n_steps,
                                  seed, c, threads, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The arguments of adrp_hover_rollout in one buffer, which the wrapper
// packs with Python's struct module (ops/hover_step.py, _ROLLOUT_ARGS):
// a ctypes call converts one pointer instead of 14 values, a few
// microseconds of host time a launch. `actions` and `resets` may be
// null.
struct RolloutArgs {
  const float* st;
  const float* actions;
  float* out;
  float* acc;
  float* resets;
  const HoverConsts* c;
  void* stream;
  long long B;
  int n_steps;
  uint32_t seed;
  int smallangle;
  int near_sqrt;
  int lanes;
  int threads;
};
static_assert(sizeof(RolloutArgs) == 88, "RolloutArgs: 7 pointers, B, 6 ints");

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for <smallangle, near_sqrt>, which no wrapper
// uses and which is not built, for a lane count other than 1 or 4, and
// for a block size that is not a multiple of 32).
extern "C" int adrp_hover_rollout(const adrp::RolloutArgs* a) {
  if ((a->smallangle && a->near_sqrt) || a->threads <= 0 ||
      a->threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (a->B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)a->stream;
  int err;
  if (a->smallangle)
    err = adrp::launch_lanes<true, false>(a->st, a->actions, a->out, a->acc,
                                          a->resets, a->B, a->n_steps,
                                          a->seed, *a->c, a->lanes,
                                          a->threads, s);
  else if (a->near_sqrt)
    err = adrp::launch_lanes<false, true>(a->st, a->actions, a->out, a->acc,
                                          a->resets, a->B, a->n_steps,
                                          a->seed, *a->c, a->lanes,
                                          a->threads, s);
  else
    err = adrp::launch_lanes<false, false>(a->st, a->actions, a->out,
                                           a->acc, a->resets, a->B,
                                           a->n_steps, a->seed, *a->c,
                                           a->lanes, a->threads, s);
  return err != 0 ? err : (int)cudaGetLastError();
}

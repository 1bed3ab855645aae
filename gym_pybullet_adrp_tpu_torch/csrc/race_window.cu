// race_window: one control step's firmware window for every agent (K3).
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race.py::race_window (:664,
// pallas_call :702, body _kernel :136 / _window_loop :178). Wrapper and
// plain PyTorch version: ops/race_window.py. It runs the general race
// env's 20 ticks for all B x N agents of a step (envs/race_fast.py).
//
// Mapping: an agent (a column of the channel-major (C, T, 128) blocks) on
// a group of L lanes of one warp, window_loop<true, L> (race_window.cuh),
// 128 threads per block, so a block holds 128 / L agents. L = 4 deals a
// tick's Euler angles, motors and planner channels out over the group;
// the wrapper picks L from the agent count (ops/race_window.py,
// lane_count): 4 while the group's threads fit one wave, 1 once agents
// fill the card. Every rank loads the agent's columns (neighbouring
// groups read neighbouring floats); rank k % L stores channel k.
//
// Bound: HBM traffic is small (S 232 B + W 228 B in, S 232 B out per
// agent, plus 560 B of injected noise per agent when the config has
// disturbances); the 20 ticks of ~1,500 dependent scalar flops in one
// group's registers are the cost, so the design is about latency: more
// warps per scheduler (L = 4) and less of the chain per lane (the dealt-
// out items). With the planner, a rank of an L = 4 group holds only its
// channel's 8 poly7 coefficients, not all 32, and evaluates that channel
// alone: with all 32 on every rank the group measured no faster than one
// lane per agent (PERF.md). Noise is injected (drawn by
// the caller with a torch.Generator); an in-kernel Philox is a later
// change.

#include "race_window.cuh"

namespace adrp {

constexpr int WINDOW_THREADS = 128;

template <int L>
__global__ void __launch_bounds__(WINDOW_THREADS)
race_window_kernel(const float* __restrict__ S, const float* __restrict__ W,
                   const float* __restrict__ noise, float* __restrict__ out,
                   long long ncols, WindowConsts c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long a = t / L;
  const int r = (int)(threadIdx.x % L);
  // ncols is a multiple of 128, so whole warps leave together
  if (a >= ncols) return;
  float s[S_CH];
#pragma unroll
  for (int k = 0; k < S_CH; ++k) s[k] = S[k * ncols + a];
  WinStatics w;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w.sp_pos[k] = W[(0 + k) * ncols + a];
    w.sp_vel[k] = W[(3 + k) * ncols + a];
    w.sp_acc[k] = W[(6 + k) * ncols + a];
    w.sp_rate[k] = W[(9 + k) * ncols + a];
    w.J[k] = W[(53 + k) * ncols + a];
  }
  w.sp_yaw_quat_deg = W[12 * ncols + a];
  w.sp_thrust = W[13 * ncols + a];
  w.pos_mode = W[14 * ncols + a] > 0.5f;
  w.z_disable = W[15 * ncols + a] > 0.5f;
  w.planner = W[16 * ncols + a] > 0.5f;
  w.t_begin = W[17 * ncols + a];
  w.duration = W[18 * ncols + a];
  w.eliminated = W[19 * ncols + a] > 0.5f;
  if constexpr (L > 1) {
    // rank r evaluates channel r (x, y, z, yaw): its 8 coefficients only
#pragma unroll
    for (int k = 0; k < 8; ++k) w.coeffs[k] = W[(20 + 8 * r + k) * ncols + a];
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) w.coeffs[k] = W[(20 + k) * ncols + a];
  }
  w.mass = W[52 * ncols + a];
  window_loop<true, L>(s, w, c, noise != nullptr ? noise + a : nullptr,
                       ncols, r);
  // out never aliases S: every rank holds the state, rank k % L stores k
#pragma unroll
  for (int k = 0; k < S_CH; ++k)
    if (k % L == r) out[k * ncols + a] = s[k];
}

// The C entry point's arguments in one buffer, packed by
// ops/race_window.py (_ARGS): one ctypes conversion a launch.
struct WindowArgs {
  const float* S;
  const float* W;
  const float* noise;  // null without disturbances
  float* out;
  const WindowConsts* c;
  void* stream;
  long long ncols;
  int lanes;
};
static_assert(sizeof(WindowArgs) == 64, "WindowArgs: 6 pointers, ncols, "
                                        "lanes");

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_race_window(const adrp::WindowArgs* a) {
  using namespace adrp;
  if (a->ncols <= 0) return 0;
  if (a->ncols % LANE != 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)(a->ncols * a->lanes / WINDOW_THREADS);
  const cudaStream_t st = (cudaStream_t)a->stream;
  if (a->lanes == 1)
    race_window_kernel<1><<<blocks, WINDOW_THREADS, 0, st>>>(
        a->S, a->W, a->noise, a->out, a->ncols, *a->c);
  else if (a->lanes == 4)
    race_window_kernel<4><<<blocks, WINDOW_THREADS, 0, st>>>(
        a->S, a->W, a->noise, a->out, a->ncols, *a->c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* adrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

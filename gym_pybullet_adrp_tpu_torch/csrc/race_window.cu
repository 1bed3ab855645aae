// race_window: one control step's firmware window for every agent (K3).
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race.py::race_window (:664,
// pallas_call :702, body _kernel :136 / _window_loop :178). Wrapper and
// plain PyTorch version: ops/race_window.py.
//
// Mapping: one thread per agent (a column of the channel-major
// (C, T, 128) blocks; window_loop's lane group of L = 1), 128 threads
// per block. Agents are independent in
// the window, so unlike the fused step (race_step.cu) no thread owns more
// than one column. Thread `a` reads channel k at S[k * ncols + a]:
// neighbouring threads read neighbouring floats, so every load and store
// of the S/W/noise blocks is coalesced.
//
// Bound: HBM traffic is small (S 232 B + W 228 B in, S 232 B out per
// agent, plus 560 B of injected noise per agent when the config has
// disturbances); the 20 ticks of ~1,500 dependent scalar flops in one
// thread's registers are the cost. The design keeps the whole state in
// registers for the window and reads the poly7 coefficients once.
// Noise is injected (drawn by the caller with a torch.Generator) rather
// than generated in the kernel; an in-kernel Philox is a later change.

#include "race_window.cuh"

namespace adrp {

__global__ void __launch_bounds__(128)
race_window_kernel(const float* __restrict__ S, const float* __restrict__ W,
                   const float* __restrict__ noise, float* __restrict__ out,
                   long long ncols, WindowConsts c) {
  long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
#pragma unroll
  for (int k = 0; k < 32; ++k) w.coeffs[k] = W[(20 + k) * ncols + a];
  w.mass = W[52 * ncols + a];
  window_loop<true, 1>(s, w, c, noise != nullptr ? noise + a : nullptr,
                       ncols, 0);
#pragma unroll
  for (int k = 0; k < S_CH; ++k) out[k * ncols + a] = s[k];
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). `noise` may be null.
// The caller makes the stream's device current. Returns the cudaError_t
// of the launch.
extern "C" int adrp_race_window(const float* S, const float* W,
                                const float* noise, float* out,
                                long long ncols,
                                const adrp::WindowConsts* c, void* stream) {
  if (ncols <= 0) return 0;
  const int threads = 128;
  const long long blocks = (ncols + threads - 1) / threads;
  adrp::race_window_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(S, W, noise, out,
                                                     ncols, *c);
  return (int)cudaGetLastError();
}

extern "C" const char* adrp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

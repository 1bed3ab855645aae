// hover_step: one hover control step for every env (K1).
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_step.py::ctrl_step_packed
// (:151, pallas_call :173, body _kernel :33). Wrapper and plain PyTorch
// version: ops/hover_step.py (ctrl_step_packed, ctrl_step_packed_plain).
//
// Mapping: one thread per env, a column of the channel-major (13, T, 128)
// state: thread e reads channel k at st[k * B + e], so neighbouring
// threads read neighbouring floats and every load and store is coalesced.
// The 13 channels stay in registers over the n_substeps substeps.
//
// Bound: per env the kernel reads 17 floats and writes 13 (120 B); the
// work is 8 substeps of ~110 dependent float ops with a sqrtf, sinf,
// cosf and a division each, so the launch is bound by operations and by
// latency (one dependent chain per thread), not by bytes. At 4096 envs
// there are 128 warps in all; the block size (THREADS in
// ops/hover_step.py) is the one chip_smoke.py measured fastest for K2.

#include "hover_step.cuh"

namespace adrp {

__global__ void hover_step_kernel(const float* __restrict__ st,
                                  const float* __restrict__ rpm,
                                  float* __restrict__ out, long long B,
                                  HoverConsts c) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float s[HOVER_CH];
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) s[k] = st[k * B + e];
  float r[HOVER_ACT];
#pragma unroll
  for (int k = 0; k < HOVER_ACT; ++k) r[k] = rpm[k * B + e];
  const Motor m = motor(r, c);
  for (int i = 0; i < c.n_substeps; ++i) substep<false>(s, m, c);
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) out[k * B + e] = s[k];
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_hover_step(const float* st, const float* rpm, float* out,
                               long long B, const adrp::HoverConsts* c,
                               int threads, void* stream) {
  if (B <= 0) return 0;
  const long long blocks = (B + threads - 1) / threads;
  adrp::hover_step_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(st, rpm, out, B, *c);
  return (int)cudaGetLastError();
}

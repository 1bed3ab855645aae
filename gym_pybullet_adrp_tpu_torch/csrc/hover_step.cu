// hover_step: one hover control step for every env (K1).
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_step.py::ctrl_step_packed
// (:151, pallas_call :173, body _kernel :33). Wrapper and plain PyTorch
// version: ops/hover_step.py (ctrl_step_packed, ctrl_step_packed_plain).
//
// Mapping: one thread per env, a column of the channel-major (13, T, 128)
// state: thread e reads channel k at st[k * B + e], so neighbouring
// threads read neighbouring floats and every load and store is coalesced.
// The 13 channels stay in registers over the n_substeps substeps, in a
// loop kept rolled (hover_step.cuh). A group of 4 lanes per env, what
// the rollout kernel runs at 4096 envs, measured no faster here on an
// H100: one step leaves nothing state-free to share but one motor
// (PERF.md, section 6).
//
// Bound: per env the kernel reads 17 floats and writes 13 (120 B); the
// work is 8 substeps of ~120 dependent float ops with a sqrtf, sinf,
// cosf and a division each, so the launch is bound by operations and by
// latency (one dependent chain per thread), not by bytes; at 4096 envs
// most of its ~4 us is the launch itself.

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
#pragma unroll SUBSTEP_UNROLL<false>
  for (int i = 0; i < c.n_substeps; ++i) substep<false>(s, m, c);
#pragma unroll
  for (int k = 0; k < HOVER_CH; ++k) out[k * B + e] = s[k];
}

// The arguments of adrp_hover_step in one buffer, packed by the wrapper
// (ops/hover_step.py, _STEP_ARGS), as for the rollout kernel.
struct StepArgs {
  const float* st;
  const float* rpm;
  float* out;
  const HoverConsts* c;
  void* stream;
  long long B;
  int threads;
};
static_assert(sizeof(StepArgs) == 56, "StepArgs: 5 pointers, B, 1 int");

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_hover_step(const adrp::StepArgs* a) {
  if (a->B <= 0) return 0;
  if (a->threads <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (a->B + a->threads - 1) / a->threads;
  adrp::hover_step_kernel<<<(unsigned)blocks, a->threads, 0,
                            (cudaStream_t)a->stream>>>(a->st, a->rpm, a->out,
                                                       a->B, *a->c);
  return (int)cudaGetLastError();
}

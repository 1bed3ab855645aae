// race_step: one fused race RL step (K4): (policy forward,) window +
// control-rate tail + autoreset in one launch.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::race_step_fused
// (:897, pallas_call :991, body _fused_kernel :593 / _step_core :151),
// with its in-kernel policy option (_policy_forward :92). Wrapper and
// plain PyTorch version: ops/race_step.py. The step body is the device
// function race_step_env (race_step.cuh), shared with the K-step rollout
// kernel (race_rollout.cu); the policy forward is policy.cuh.
//
// Mapping: one thread per env (race_step.cuh says why), 128 threads per
// block.
//
// Bound: per step the kernel moves ~1 KB per agent (S in/out, R in/out,
// OBS out, the reset rows; S is 1.9 MB at 4096 envs x 2 drones), which
// the card streams in microseconds. The cost is the serial scalar work
// of the window (20 ticks x ~1,500 flops per drone) and, with the policy
// option, the MLP (~30k flops per agent at 64-64) in one thread, and
// occupancy: 4096 envs are only 4096 threads, 32 blocks of 128 on 132
// SMs. One thread per agent for the window with a per-env pass for the
// tail, or several envs' drones per warp, is the first thing to change
// for speed; this version is the simple one that matches its plain twin.

#include "race_step.cuh"

namespace adrp {

__global__ void __launch_bounds__(128)
race_step_kernel(const StepPtrs p, const StepConsts c) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)c.Tb * LANE) return;
  race_step_env(p, c, e);
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_race_step(const adrp::StepPtrs* p,
                              const adrp::StepConsts* c, void* stream) {
  const long long envs = (long long)c->Tb * adrp::LANE;
  if (envs <= 0) return 0;
  const int threads = 128;
  const long long blocks = (envs + threads - 1) / threads;
  adrp::race_step_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(*p, *c);
  return (int)cudaGetLastError();
}

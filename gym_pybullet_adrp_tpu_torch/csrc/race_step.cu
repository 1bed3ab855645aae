// race_step: one fused race RL step (K4): (policy forward,) window +
// control-rate tail + autoreset in one launch.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::race_step_fused
// (:897, pallas_call :991, body _fused_kernel :593 / _step_core :151),
// with its in-kernel policy option (_policy_forward :92). Wrapper and
// plain PyTorch version: ops/race_step.py. The step body is the device
// function race_step_env (race_step.cuh), shared with the K-step rollout
// kernel (race_rollout.cu); the policy phase is policy.cuh.
//
// Mapping, two instantiations. Without the policy: one thread per env,
// 128 threads per block (race_step.cuh says why one thread owns an env).
// With it: one block per 32-env tile, 512 threads. (a) all 16 warps
// run the tile's MLP (policy_tile), which leaves the clipped actions in
// shared memory; (b) warp 0, lane = env, runs the env step from them.
// No thread returns before a barrier: a lane past the last env is masked.
//
// Bound: per step the kernel moves ~1 KB per agent (S in/out, R in/out,
// OBS out, the reset rows; S is 1.9 MB at 4096 envs x 2 drones), which
// the card streams in microseconds. The cost is the serial scalar work of
// the window (20 ticks x ~1,500 flops per drone, one latency-bound chain
// per thread). With the policy option the MLP (~30k flops per agent at
// 64-64) is spread over the 512 threads of each tile, on 128 SMs at 4096
// envs, and costs less than the window's chain, the larger term here
// too; it stays latency-bound far above its operation bound with 32
// agents per SM (policy.cuh).

#include "race_step.cuh"

namespace adrp {

template <bool POLICY>
__global__ void __launch_bounds__(POLICY ? POLICY_THREADS : STEP_THREADS)
race_step_kernel(const StepPtrs p, const StepConsts c) {
  const long long E = (long long)c.Tb * LANE;
  if constexpr (!POLICY) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    race_step_env(p, c, e, nullptr);
  } else {
    extern __shared__ float smem[];
    const PolicySmem s = policy_smem(smem, p.PP, c.pl, c.N);
    stage_pack(p.PP, c.pl, s);
    const long long e0 = (long long)blockIdx.x * TILE;
    const int lane = threadIdx.x % 32;
    policy_tile(p.OBS_IN, p.PP, c.pl, p.ACTN, p.ACT, p.LOGP, p.VAL, c.N, E,
                e0, s);
    if (threadIdx.x < 32 && e0 + lane < E)
      race_step_env(p, c, e0 + lane, s.act + lane);
  }
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_race_step(const adrp::StepPtrs* p,
                              const adrp::StepConsts* c, void* stream) {
  if (c->Tb <= 0) return 0;
  const bool policy = p->PP != nullptr;
  const adrp::StepLaunch g = adrp::step_launch(*c, policy);
  if (policy) {
    const int err = adrp::allow_smem(adrp::race_step_kernel<true>, g.smem);
    if (err != 0) return err;
    adrp::race_step_kernel<true><<<g.blocks, g.threads, g.smem,
                                   (cudaStream_t)stream>>>(*p, *c);
  } else {
    adrp::race_step_kernel<false><<<g.blocks, g.threads, 0,
                                    (cudaStream_t)stream>>>(*p, *c);
  }
  return (int)cudaGetLastError();
}

// out = [blocks, threads, dynamic shared bytes, registers, local bytes]
// of a launch with (policy != 0) or without the policy.
extern "C" int adrp_race_step_geometry(const adrp::StepConsts* c, int policy,
                                       long long* out) {
  const adrp::StepLaunch g = adrp::step_launch(*c, policy != 0);
  return policy ? adrp::launch_report(adrp::race_step_kernel<true>, g, out)
                : adrp::launch_report(adrp::race_step_kernel<false>, g, out);
}

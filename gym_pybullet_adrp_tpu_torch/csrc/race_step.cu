// race_step: one fused race RL step (K4): (policy forward,) window +
// control-rate tail + autoreset in one launch.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::race_step_fused
// (:897, pallas_call :991, body _fused_kernel :593 / _step_core :151),
// with its in-kernel policy option (_policy_forward :92). Wrapper and
// plain PyTorch version: ops/race_step.py. The step body is the device
// function race_step_tile (race_step.cuh), shared with the K-step rollout
// kernel (race_rollout.cu); the policy phase is policy.cuh.
//
// Mapping: one block per 32-env tile (race_step.cuh, race_step_tile),
// in two instantiations. Without the policy: N * 4 warps (at most 8,
// the launch bound that leaves a thread ~250 registers), one per window
// unit; a lane group of 4 lanes runs one agent's window, the drones'
// windows side by side; then warp d runs drone d's tail, one lane per
// env, and the env-level end. With it: 512 threads, (a) all 16 warps run
// the tile's MLP (policy_tile), which leaves the clipped actions in
// shared memory; (b) the same env step from them, one lane per agent in
// the window (LANES<true>: a lane group spills at 512 threads). The env
// count is a multiple of 128, so every tile is full.
//
// Bound: per step the kernel moves ~1 KB per agent (S in/out, R in/out,
// OBS out, the reset rows; S is 1.9 MB at 4096 envs x 2 drones), which
// the card streams in microseconds, and does ~3e4 flops per agent
// (20 ticks x ~1,500), 0.0037 ms of the card's float32 rate at 4096 x 2.
// The cost is the latency of the window's serial chain: each agent's
// ticks are one dependent chain of scalar work, and at 4096 envs the
// 128 x N x L window warps give the 528 warp schedulers about one chain
// each. Spreading the drones over warps runs their windows side by
// side; the lane group shortens each chain's instruction stream. With the
// policy option the MLP (~30k flops per agent at 64-64) is spread over
// the 512 threads of each tile and stays latency-bound far above its
// operation bound with 32 agents per SM (policy.cuh).

#include "race_step.cuh"

namespace adrp {

template <bool POLICY>
__global__ void __launch_bounds__(POLICY ? POLICY_THREADS : 32 * STEP_WARPS)
race_step_kernel(const StepPtrs p, const StepConsts c) {
  const long long e0 = (long long)blockIdx.x * TILE;
  if constexpr (!POLICY) {
    race_step_tile<LANES<POLICY>>(p, c, e0, nullptr);
  } else {
    extern __shared__ float smem[];
    const PolicySmem s = policy_smem(smem, p.PP, c.pl, c.N);
    stage_pack(p.PP, c.pl, s);
    policy_tile(p.OBS_IN, p.PP, c.pl, p.ACTN, p.ACT, p.LOGP, p.VAL, c.N,
                (long long)c.Tb * LANE, e0, s);
    race_step_tile<LANES<POLICY>>(p, c, e0, s.act);
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

// out = [blocks, threads, dynamic shared bytes, registers, local bytes,
// static shared bytes] of a launch with (policy != 0) or
// without the policy.
extern "C" int adrp_race_step_geometry(const adrp::StepConsts* c, int policy,
                                       long long* out) {
  const adrp::StepLaunch g = adrp::step_launch(*c, policy != 0);
  return policy ? adrp::launch_report(adrp::race_step_kernel<true>, g, out)
                : adrp::launch_report(adrp::race_step_kernel<false>, g, out);
}

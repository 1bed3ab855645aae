// race_rollout: K race RL steps per launch (K5), with the env state kept
// by the thread that owns it from one step to the next.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::race_rollout
// (:750, pallas_call :885, body _rollout_kernel :655). Wrapper and plain
// PyTorch version: ops/race_rollout.py. Both modes of the TPU kernel:
// an action sequence A_seq (K, 4, T, 128), or the policy inside the step
// (policy.cuh) with the obs carried from each step to the next.
//
// Mapping: as K4 (race_step.cu), one block per 32-env tile, looping over
// the K steps, in two instantiations. Action mode: N * 4 warps (at most
// 8), a lane group of 4 per agent's window. Policy mode: 512 threads, one
// lane per agent's window; each step is (a) the tile's MLP on
// all sixteen warps (policy_tile), then (b) the env step. Each step is
// the device function race_step_tile (race_step.cuh), the body K4 runs,
// after the same policy phase, so K launches of K4 and one of K5 give the
// same bits. The blocks are updated in place in S_out/R_out/GG_out/
// OO_out/EP_out, and a step's columns are read at step k+1 by other
// threads than wrote them (a drone's window unit, its tail thread): the
// barrier that begins each step orders them; in policy mode a barrier
// also precedes the MLP, which reads the obs written at step k-1.
//
// Per-step operands are offset by k; a reset-draw sequence of length 1
// (deterministic configs: every step's reset rows are equal) has stride
// 0, as the TPU kernel pins a length-1 block (seq_spec :817-826).
//
// Bound: the TPU kernel keeps the state in VMEM across the grid to save
// its per-step HBM round trip; here the state columns stay in L1/L2
// between steps (1.9 MB of S at 4096 envs x 2 drones against a 50 MB L2)
// and the launch overhead of K-1 launches is saved. What remains is K4's
// cost K times: the latency of the window's serial chain, one chain per
// agent on a lane group (race_step.cuh says how the tile spreads them).
// The MLP of policy mode, spread over the tile's 512 threads, costs less
// than the window it feeds.

#include "race_step.cuh"

namespace adrp {

// Mirrors ops/race_rollout.py::RolloutArgs.
struct RolloutArgs {
  const float *S, *R, *GG, *OO, *EP;  // the initial state
  const float *A_seq;                  // action mode: (K, 4, T, 128)
  const float *OBS0, *PP, *ACTN_seq;   // policy mode
  const float *RST_seq, *RSTG_seq, *RSTO_seq, *noise_seq;
  long long rst_stride, rstg_stride, rsto_stride;  // floats per step
  float *S_out, *R_out, *GG_out, *OO_out, *EP_out;
  float *REW, *DONE, *OBS, *INFO, *ACT, *LOGP, *VAL;  // (K, ...) streams
  int K;
};

template <bool POLICY>
__global__ void __launch_bounds__(POLICY ? POLICY_THREADS : 32 * STEP_WARPS)
race_rollout_kernel(const RolloutArgs r, const StepConsts c) {
  const long long E = (long long)c.Tb * LANE;
  const long long nc = E * c.N;
  const long long C = obs_channels(c);
  const long long e0 = (long long)blockIdx.x * TILE;
  PolicySmem s{};
  if constexpr (POLICY) {
    extern __shared__ float smem[];
    s = policy_smem(smem, r.PP, c.pl, c.N);
    stage_pack(r.PP, c.pl, s);  // once for the K steps
  }
  for (int k = 0; k < r.K; ++k) {
    StepPtrs p;
    const bool first = k == 0;
    p.S = first ? r.S : r.S_out;
    p.R = first ? r.R : r.R_out;
    p.GG = first ? r.GG : r.GG_out;
    p.OO = first ? r.OO : r.OO_out;
    p.EP = first ? r.EP : r.EP_out;
    p.A = POLICY ? nullptr : r.A_seq + k * ACT_DIM * nc;
    p.RST = r.RST_seq + k * r.rst_stride;
    p.RSTG = r.RSTG_seq + k * r.rstg_stride;
    p.RSTO = r.RSTO_seq + k * r.rsto_stride;
    p.noise = r.noise_seq != nullptr
                  ? r.noise_seq + k * (long long)c.w.n_ticks * NOISE_CH * nc
                  : nullptr;
    p.S_out = r.S_out;
    p.R_out = r.R_out;
    p.GG_out = r.GG_out;
    p.OO_out = r.OO_out;
    p.EP_out = r.EP_out;
    p.OBS = r.OBS != nullptr ? r.OBS + k * C * nc : nullptr;
    p.REW = r.REW + k * nc;
    p.DONE = r.DONE + k * E;
    p.INFO = r.INFO != nullptr ? r.INFO + k * INFO_CH * nc : nullptr;
    if constexpr (POLICY) {
      p.OBS_IN = first ? r.OBS0 : r.OBS + (k - 1) * C * nc;
      p.PP = r.PP;
      p.ACTN = r.ACTN_seq + k * ACT_DIM * nc;
      p.ACT = r.ACT + k * ACT_DIM * nc;
      p.LOGP = r.LOGP + k * nc;
      p.VAL = r.VAL + k * nc;
      // step k-1's obs, written by its tail threads, is read by every warp
      if (!first) __syncthreads();
      policy_tile(p.OBS_IN, p.PP, c.pl, p.ACTN, p.ACT, p.LOGP, p.VAL, c.N,
                  E, e0, s);
      race_step_tile<LANES<POLICY>>(p, c, e0, s.act);
    } else {
      p.OBS_IN = nullptr;
      p.PP = nullptr;
      p.ACTN = nullptr;
      p.ACT = nullptr;
      p.LOGP = nullptr;
      p.VAL = nullptr;
      race_step_tile<LANES<POLICY>>(p, c, e0, nullptr);
    }
  }
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_race_rollout(const adrp::RolloutArgs* r,
                                 const adrp::StepConsts* c, void* stream) {
  if (c->Tb <= 0 || r->K <= 0) return 0;
  const bool policy = r->PP != nullptr;
  const adrp::StepLaunch g = adrp::step_launch(*c, policy);
  if (policy) {
    const int err =
        adrp::allow_smem(adrp::race_rollout_kernel<true>, g.smem);
    if (err != 0) return err;
    adrp::race_rollout_kernel<true><<<g.blocks, g.threads, g.smem,
                                      (cudaStream_t)stream>>>(*r, *c);
  } else {
    adrp::race_rollout_kernel<false><<<g.blocks, g.threads, 0,
                                       (cudaStream_t)stream>>>(*r, *c);
  }
  return (int)cudaGetLastError();
}

// out = [blocks, threads, dynamic shared bytes, registers, local bytes,
// static shared bytes] of a launch with (policy != 0) or
// without the policy.
extern "C" int adrp_race_rollout_geometry(const adrp::StepConsts* c,
                                          int policy, long long* out) {
  const adrp::StepLaunch g = adrp::step_launch(*c, policy != 0);
  return policy ? adrp::launch_report(adrp::race_rollout_kernel<true>, g, out)
                : adrp::launch_report(adrp::race_rollout_kernel<false>, g,
                                      out);
}

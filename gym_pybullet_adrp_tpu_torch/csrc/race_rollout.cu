// race_rollout: K race RL steps per launch (K5), with the env state kept
// by the thread that owns it from one step to the next.
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::race_rollout
// (:750, pallas_call :885, body _rollout_kernel :655). Wrapper and plain
// PyTorch version: ops/race_rollout.py. Both modes of the TPU kernel:
// an action sequence A_seq (K, 4, T, 128), or the policy inside the step
// (policy.cuh) with the obs carried from each step to the next.
//
// Mapping: one thread per env, as K4 (race_step.cu), looping over the K
// steps. Each step is the device function race_step_env (race_step.cuh),
// the body K4 runs, so K launches of K4 and one of K5 give the same bits.
// Step k+1 reads the state columns that the same thread wrote at step k
// (the blocks are updated in place in S_out/R_out/GG_out/OO_out/EP_out),
// and in policy mode the obs that thread wrote into OBS[k-1]: no thread
// reads another's writes, so the loop needs no synchronisation. The
// COMPETE opponent channels are the same thread's other drones.
//
// Per-step operands are offset by k; a reset-draw sequence of length 1
// (deterministic configs: every step's reset rows are equal) has stride
// 0, as the TPU kernel pins a length-1 block (seq_spec :817-826).
//
// Bound: the TPU kernel keeps the state in VMEM across the grid to save
// its per-step HBM round trip; here the state columns stay in L1/L2
// between steps (1.9 MB of S at 4096 envs x 2 drones against a 50 MB L2)
// and the launch overhead of K-1 launches is saved. What remains is K4's
// cost K times: the serial per-thread work of the window and, in policy
// mode, the MLP, at one thread per env (4096 threads on 132 SMs).

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

__global__ void __launch_bounds__(128)
race_rollout_kernel(const RolloutArgs r, const StepConsts c) {
  const long long E = (long long)c.Tb * LANE;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long nc = E * c.N;
  const long long C = obs_channels(c);
  const bool policy = r.PP != nullptr;
  for (int k = 0; k < r.K; ++k) {
    StepPtrs p;
    const bool first = k == 0;
    p.S = first ? r.S : r.S_out;
    p.R = first ? r.R : r.R_out;
    p.GG = first ? r.GG : r.GG_out;
    p.OO = first ? r.OO : r.OO_out;
    p.EP = first ? r.EP : r.EP_out;
    p.A = policy ? nullptr : r.A_seq + k * ACT_DIM * nc;
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
    if (policy) {
      p.OBS_IN = first ? r.OBS0 : r.OBS + (k - 1) * C * nc;
      p.PP = r.PP;
      p.ACTN = r.ACTN_seq + k * ACT_DIM * nc;
      p.ACT = r.ACT + k * ACT_DIM * nc;
      p.LOGP = r.LOGP + k * nc;
      p.VAL = r.VAL + k * nc;
    } else {
      p.OBS_IN = nullptr;
      p.PP = nullptr;
      p.ACTN = nullptr;
      p.ACT = nullptr;
      p.LOGP = nullptr;
      p.VAL = nullptr;
    }
    race_step_env(p, c, e);
  }
}

}  // namespace adrp

// C interface (bound with ctypes in ops/_build.py). The caller makes the
// stream's device current. Returns the cudaError_t of the launch.
extern "C" int adrp_race_rollout(const adrp::RolloutArgs* r,
                                 const adrp::StepConsts* c, void* stream) {
  const long long envs = (long long)c->Tb * adrp::LANE;
  if (envs <= 0 || r->K <= 0) return 0;
  const int threads = 128;
  const long long blocks = (envs + threads - 1) / threads;
  adrp::race_rollout_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(*r, *c);
  return (int)cudaGetLastError();
}

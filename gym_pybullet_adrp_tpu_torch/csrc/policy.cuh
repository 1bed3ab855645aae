// The ActorCritic forward and Gaussian sample for ONE agent, as a device
// function run inside the race step kernels: K4's policy option
// (race_step.cu) and K5's policy mode (race_rollout.cu).
//
// Replaces gym_pybullet_adrp_tpu/ops/pallas_race_step.py::_policy_forward
// (:92, pack layout pp_layout :67): separate tanh towers for the policy
// mean and the value (two hidden layers of any widths up to MAX_HIDDEN),
// action = mean + exp(log_std) * n for injected standard-normal draws n,
// logp = sum_k -0.5 * (n_k^2 + 2 log_std_k + log 2pi), and the value.
// Plain version: ops/race_step.py::policy_forward_plain, which accumulates
// in the same order (out[j] = (0 + w[j,0] x_0 + w[j,1] x_1 + ...) + b[j],
// every product and sum rounded separately under -fmad=false).
//
// The pack is the port's own (ops/race_step.py::policy_layout): each
// weight compact, (out, in) row-major float32, then the biases and
// log_std, at the offsets of PolicyLayout. The JAX pack's (rows, 128)
// lane-broadcast blocks are a TPU tiling artifact and are not copied.
//
// What it costs: one thread runs its agent's whole MLP. At 64-64 with the
// 49-channel getting_started obs that is ~14.8k multiply-adds (~30k
// flops), about what the 20-tick firmware window costs, and at 256-128
// ~92k. Every thread of a warp reads the same weight at the same time, so
// each weight load is one broadcast through L1; the hidden activations
// live in two per-thread arrays of MAX_HIDDEN floats, i.e. in local
// memory (2 KB of stack per thread, L1-cached). Four outputs accumulate
// at once to hide the add latency of the dependent sums. Staging the
// weights in shared memory, or a tensor-core product over a tile of
// agents, is later work.
#pragma once

#include "race_window.cuh"

namespace adrp {

constexpr int MAX_HIDDEN = 256;
constexpr int ACT_DIM = 4;

// Mirrors ops/race_step.py::PolicyLayout: the widths and the float
// offset of every tensor in the pack.
struct PolicyLayout {
  int C, H1, H2;
  int w1, w2, w3, v1, v2, v3;  // (out, in) row-major weights
  int b1, b2, b3, vb1, vb2, vb3, log_std;
};

// y[j] = act(b[j] + sum_i w[j * inn + i] * x[i * xs]), the sum over i in
// ascending order from 0, four outputs at a time.
__device__ __forceinline__ void dense(const float* w, const float* b,
                                      int out, int inn, const float* x,
                                      long long xs, float* y, bool act) {
  for (int j0 = 0; j0 < out; j0 += 4) {
    const int nj = out - j0 < 4 ? out - j0 : 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < inn; ++i) {
      const float xi = x[i * xs];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < nj) acc[u] = acc[u] + w[(j0 + u) * inn + i] * xi;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < nj) {
        const float v = acc[u] + b[j0 + u];
        y[j0 + u] = act ? tanhf(v) : v;
      }
    }
  }
}

// One agent's forward and sample. `obs` points at the agent's column of a
// (C, T, 128) block (channel i at obs[i * nc]); `n` are its 4 draws.
// Writes the UNCLIPPED action, its log-probability and the value.
__device__ __forceinline__ void policy_forward(const float* pp,
                                               const PolicyLayout& L,
                                               const float* obs,
                                               long long nc,
                                               const float n[ACT_DIM],
                                               float act[ACT_DIM],
                                               float& logp, float& val) {
  float h1[MAX_HIDDEN], h2[MAX_HIDDEN], mean[ACT_DIM];
  dense(pp + L.w1, pp + L.b1, L.H1, L.C, obs, nc, h1, true);
  dense(pp + L.w2, pp + L.b2, L.H2, L.H1, h1, 1, h2, true);
  dense(pp + L.w3, pp + L.b3, ACT_DIM, L.H2, h2, 1, mean, false);
  dense(pp + L.v1, pp + L.vb1, L.H1, L.C, obs, nc, h1, true);
  dense(pp + L.v2, pp + L.vb2, L.H2, L.H1, h1, 1, h2, true);
  dense(pp + L.v3, pp + L.vb3, 1, L.H2, h2, 1, &val, false);
  const float LOG_2PI = F(1.8378770664093453);
  for (int k = 0; k < ACT_DIM; ++k) {
    const float ls = pp[L.log_std + k];
    act[k] = mean[k] + expf(ls) * n[k];
    const float contrib = -0.5f * (n[k] * n[k] + 2.0f * ls + LOG_2PI);
    logp = k == 0 ? contrib : logp + contrib;
  }
}

}  // namespace adrp

// The ActorCritic forward and Gaussian sample for a tile of 32 envs, as a
// block-wide device function run inside the race step kernels: K4's
// policy option (race_step.cu) and K5's policy mode (race_rollout.cu).
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
// Design: a block owns a tile of 32 consecutive envs (TILE), and with
// them 32 agent columns per drone. All POLICY_THREADS threads of the
// block run the MLP of one drone's 32 agents at a time: lane l is agent
// l, and each warp takes chunks of OUT_PER_THREAD output neurons of a
// layer, both towers' layers dealt out together, so one thread
// accumulates 4 independent sums (instruction-level parallelism for the
// dependent adds). The layer inputs x[i][agent] and the hidden
// activations sit in shared memory (lanes read consecutive words: no bank
// conflicts). The weights are staged in shared memory once per launch
// where they fit (K5 stages them once for its K steps), each row padded
// to 16 bytes, so a thread reads four inputs of a weight row per
// broadcast load; where they do not fit they are read through L1. Each
// output is still one thread's sum over i in ascending order from 0.0f,
// so the result equals the plain version to the bit. Tensor-core products
// (TF32/bf16) would not, and a closed-loop trajectory amplifies an ulp.
//
// What bounds it: 14.8k multiply-adds per agent at 49-64-64, 1.2e8
// unfused flops per 4096-agent step, under 2 us at the card's float32
// rate. With only 32 agents per SM at 4096 envs, a warp instruction
// serves 32 agents, and the dispatch of the loads, the address arithmetic
// and the latency of the dependent sums on 16 warps per SM set the time:
// about 0.022 ms a step on an H100 (PERF.md). The env step that follows
// (race_step.cuh) spreads the tile's windows over N * LANES warps of the
// block; their serial chain is the larger part of a step.
#pragma once

#include <stdint.h>

#include "race_window.cuh"

namespace adrp {

constexpr int MAX_HIDDEN = 256;  // ops/race_step.py::policy_layout checks it
constexpr int ACT_DIM = 4;
constexpr int TILE = 32;             // envs per block in policy mode
constexpr int POLICY_THREADS = 512;  // sixteen warps on the MLP
constexpr int OUT_PER_THREAD = 4;

// Mirrors ops/race_step.py::PolicyLayout: the widths and the float
// offset of every tensor in the pack.
struct PolicyLayout {
  int C, H1, H2;
  int w1, w2, w3, v1, v2, v3;  // (out, in) row-major weights
  int b1, b2, b3, vb1, vb2, vb3, log_std;
};

// The env step's static shared memory beside the policy's dynamic rows
// (race_step.cuh, its tail exchange) stays within this reserve, and the
// dynamic rows within the rest of the H100's 232,448 bytes per block.
constexpr int STEP_STATIC_SMEM = 4096;
constexpr int MAX_SMEM = 232448 - STEP_STATIC_SMEM;

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// The block's shared memory in policy mode, as offsets in floats of
// TILE-wide rows: the obs (C), both towers' first (2 H1) and second
// (2 H2) hidden layers, the mean and the value (5), all for one drone's
// agents; then the clipped actions (3 per drone) of every agent.
__host__ __device__ __forceinline__ int policy_smem_rows(const PolicyLayout& L,
                                                         int N) {
  return L.C + 2 * L.H1 + 2 * L.H2 + ACT_DIM + 1 + 3 * N;
}

// The six weight matrices staged in front of the rows, where they fit:
// (out, ld) each, a row padded to ld = pad4(inn) floats so that every row
// is 16-byte aligned and a layer reads four inputs per load; order w1,
// v1, w2, v2, w3, v3. 0 where they do not fit (read through L1 instead).
__host__ __device__ __forceinline__ int staged_floats(const PolicyLayout& L,
                                                      int N) {
  const int w = 2 * (L.H1 * pad4(L.C) + L.H2 * pad4(L.H1)) +
                (ACT_DIM + 1) * pad4(L.H2);
  const long long all = (long long)w + (long long)policy_smem_rows(L, N) * TILE;
  return all * (long long)sizeof(float) <= MAX_SMEM ? w : 0;
}

__host__ __device__ __forceinline__ size_t policy_smem_bytes(
    const PolicyLayout& L, int N) {
  return (size_t)(staged_floats(L, N) + policy_smem_rows(L, N) * TILE) *
         sizeof(float);
}

// A weight matrix as the layers read it: row j at w + j * ld.
struct Weights {
  const float* w;
  int ld;
};

struct PolicySmem {
  Weights w1, v1, w2, v2, w3, v3;
  float *x, *h1, *h2, *out, *act;
};

__device__ __forceinline__ PolicySmem policy_smem(float* base,
                                                  const float* pp,
                                                  const PolicyLayout& L,
                                                  int N) {
  PolicySmem s;
  const int staged = staged_floats(L, N);
  if (staged) {
    const int ldc = pad4(L.C), ld1 = pad4(L.H1), ld2 = pad4(L.H2);
    float* w = base;
    s.w1 = {w, ldc};
    s.v1 = {w += L.H1 * ldc, ldc};
    s.w2 = {w += L.H1 * ldc, ld1};
    s.v2 = {w += L.H2 * ld1, ld1};
    s.w3 = {w += L.H2 * ld1, ld2};
    s.v3 = {w + ACT_DIM * ld2, ld2};
  } else {
    s.w1 = {pp + L.w1, L.C};
    s.v1 = {pp + L.v1, L.C};
    s.w2 = {pp + L.w2, L.H1};
    s.v2 = {pp + L.v2, L.H1};
    s.w3 = {pp + L.w3, L.H2};
    s.v3 = {pp + L.v3, L.H2};
  }
  s.x = base + staged;
  s.h1 = s.x + L.C * TILE;
  s.h2 = s.h1 + 2 * L.H1 * TILE;
  s.out = s.h2 + 2 * L.H2 * TILE;
  s.act = s.out + (ACT_DIM + 1) * TILE;
  return s;
}

// Copies the (out, inn) matrix at src to its padded rows: a warp per row,
// a lane per input (coalesced reads, no bank conflict on the writes).
__device__ __forceinline__ void stage_rows(const Weights& dst,
                                           const float* src, int out,
                                           int inn) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  float* d = const_cast<float*>(dst.w);
  for (int j = threadIdx.x / 32; j < out; j += nwarps)
#pragma unroll 2
    for (int i = lane; i < inn; i += 32)
      d[j * dst.ld + i] = __ldg(src + j * inn + i);
}

// Stages the weights where they fit (staged_floats). Every thread calls
// it; the barrier after policy_tile's first obs load publishes them.
__device__ __forceinline__ void stage_pack(const float* pp,
                                           const PolicyLayout& L,
                                           const PolicySmem& s) {
  if (s.w1.w == pp + L.w1) return;
  stage_rows(s.w1, pp + L.w1, L.H1, L.C);
  stage_rows(s.v1, pp + L.v1, L.H1, L.C);
  stage_rows(s.w2, pp + L.w2, L.H2, L.H1);
  stage_rows(s.v2, pp + L.v2, L.H2, L.H1);
  stage_rows(s.w3, pp + L.w3, ACT_DIM, L.H2);
  stage_rows(s.v3, pp + L.v3, 1, L.H2);
}

// One layer y[j][l] = act(b[j] + sum_i W[j][i] * x[i][l]) of a tower; x
// and y are TILE-wide rows in shared memory.
struct Dense {
  Weights W;
  const float* b;
  int out, inn;
  const float* x;
  float* y;
  bool act;
};

// Outputs j0 .. j0 + OUT_PER_THREAD - 1 (those below out) for this lane,
// each one sum over i in ascending order.
__device__ __forceinline__ void dense_chunk(const Dense& L, int j0, int lane) {
  constexpr int U = OUT_PER_THREAD;
  const int nj = L.out - j0 < U ? L.out - j0 : U;
  const int ld = L.W.ld;
  const float* w = L.W.w + (long long)j0 * ld;
  const float* x = L.x + lane;
  float acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = 0.0f;
  int i = 0;
  if ((ld & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
#pragma unroll 2
    for (; i + 4 <= L.inn; i += 4) {
      const float x0 = x[(i + 0) * TILE], x1 = x[(i + 1) * TILE];
      const float x2 = x[(i + 2) * TILE], x3 = x[(i + 3) * TILE];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nj) {
          const float4 q = *reinterpret_cast<const float4*>(w + u * ld + i);
          acc[u] = acc[u] + q.x * x0;
          acc[u] = acc[u] + q.y * x1;
          acc[u] = acc[u] + q.z * x2;
          acc[u] = acc[u] + q.w * x3;
        }
      }
    }
  }
#pragma unroll 4
  for (; i < L.inn; ++i) {
    const float xi = x[i * TILE];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < nj) acc[u] = acc[u] + w[u * ld + i] * xi;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < nj) {
      const float v = acc[u] + __ldg(L.b + j0 + u);
      L.y[(j0 + u) * TILE + lane] = L.act ? tanhf(v) : v;
    }
  }
}

// The policy tower's layer and the value tower's, their output chunks
// dealt round-robin to the block's warps (a chunk never spans towers; an
// output count that is not a multiple of the chunk is masked).
__device__ __forceinline__ void dense_pair(const Dense& A, const Dense& B) {
  constexpr int U = OUT_PER_THREAD;
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int na = (A.out + U - 1) / U, nb = (B.out + U - 1) / U;
  for (int ch = threadIdx.x / 32; ch < na + nb; ch += nwarps) {
    const bool a = ch < na;
    dense_chunk(a ? A : B, (a ? ch : ch - na) * U, lane);
  }
}

// The forward and sample of the tile's agents: drone d's agent of env
// e0 + l is column a = d * E + e0 + l of the (C, T, 128) obs rows OBS_IN
// and of the outputs ACT (4, T, 128), LOGP and VAL (T, 128), which get
// the UNCLIPPED action, its log-probability and the value. The clipped
// action rows 0-2 go to s.act[(3 d + k) * TILE + l] for the env step
// (race_step_tile), after its first barrier: lane l of warp 0 writes
// them. Every thread of the block calls this (it holds barriers); the
// caller puts a barrier between the writes of OBS_IN and this call.
__device__ __forceinline__ void policy_tile(const float* OBS_IN,
                                            const float* pp,
                                            const PolicyLayout& L,
                                            const float* ACTN, float* ACT,
                                            float* LOGP, float* VAL, int N,
                                            long long E, long long e0,
                                            const PolicySmem& s) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const long long nc = E * N;
  const bool live = e0 + lane < E;
  const int H1 = L.H1, H2 = L.H2;
  for (int d = 0; d < N; ++d) {
    const long long a = d * E + e0 + lane;
#pragma unroll 4
    for (int i = warp; i < L.C; i += nwarps)
      s.x[i * TILE + lane] = live ? OBS_IN[i * nc + a] : 0.0f;
    __syncthreads();
    dense_pair({s.w1, pp + L.b1, H1, L.C, s.x, s.h1, true},
               {s.v1, pp + L.vb1, H1, L.C, s.x, s.h1 + H1 * TILE, true});
    __syncthreads();
    dense_pair({s.w2, pp + L.b2, H2, H1, s.h1, s.h2, true},
               {s.v2, pp + L.vb2, H2, H1, s.h1 + H1 * TILE, s.h2 + H2 * TILE,
                true});
    __syncthreads();
    dense_pair({s.w3, pp + L.b3, ACT_DIM, H2, s.h2, s.out, false},
               {s.v3, pp + L.vb3, 1, H2, s.h2 + H2 * TILE,
                s.out + ACT_DIM * TILE, false});
    __syncthreads();
    // the next drone's obs load and layers write x, h1, h2; s.out is
    // written again only after three more barriers
    if (warp == 0 && live) {
      const float LOG_2PI = F(1.8378770664093453);
      float logp = 0.0f;
#pragma unroll
      for (int k = 0; k < ACT_DIM; ++k) {
        const float n = ACTN[k * nc + a];
        const float ls = __ldg(pp + L.log_std + k);
        const float raw = s.out[k * TILE + lane] + expf(ls) * n;
        ACT[k * nc + a] = raw;
        // the clipped action drives the step; its yaw (x pi) is not read
        if (k < 3) s.act[(3 * d + k) * TILE + lane] = clipf(raw, -1.0f, 1.0f);
        const float contrib = -0.5f * (n * n + 2.0f * ls + LOG_2PI);
        logp = k == 0 ? contrib : logp + contrib;
      }
      LOGP[a] = logp;
      VAL[a] = s.out[ACT_DIM * TILE + lane];
    }
  }
}

// Shared memory above the default 48 KB a block, static and dynamic
// together, needs the kernel's attribute raised first (up to 232,448
// bytes on the H100: 151 KB at the pack's limits, 8 COMPETE drones and
// 256-256). Cheap, host-side, and only taken by widths above ~150-150.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes + STEP_STATIC_SMEM <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace adrp

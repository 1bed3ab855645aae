// One race RL step for one env, as a device function shared by the fused
// step kernel (race_step.cu, K4) and the K-step rollout kernel
// (race_rollout.cu, K5): the window statics from the FULLSTATE action (or
// from the clipped action of the policy phase, policy.cuh), the firmware
// window (race_window.cuh), the control-rate tail, and the autoreset.
//
// Replaces the body of gym_pybullet_adrp_tpu/ops/pallas_race_step.py
// (_step_core :151), which the JAX package also shares between its two
// kernels: one body, one maintenance point. The statement order follows
// ops/race_step.py::step_core_plain.
//
// Mapping: a block owns a tile of TILE = 32 consecutive envs and all
// their drones, in three phases split by barriers (race_step_tile):
//  1. The windows. Drone d's 32 agents of the tile form L units of 32 / L
//     agents; a unit is one warp whose lane groups of L lanes each run one
//     agent (window_loop<false, L>, race_window.cuh), and the N * L units
//     are dealt round-robin to the block's warps. The drones' windows,
//     independent until the tail, run side by side. L = LANES<POLICY>:
//     4 without the policy, 1 with it (below).
//  2. The per-drone tail: warp d < N, lane l owns drone d of env e0 + l:
//     gate progress, collisions (the other drones' post-window state read
//     back from S_out), visibility, observation, shaping and the race
//     rows. The env-level inputs (eliminated, finished, gate, drone 0's
//     progress) go to shared memory.
//  3. The env-level end: each tail thread forms the termination and the
//     env reward from every drone's inputs, writes its drone's reward and
//     resets its drone; warp 0 writes the env rows (DONE, EP, GG, OO).
// Drone d of env e is column d * E + e of every (C, T, 128) block, so a
// warp on one drone reads 32 (32 / L in phase 1) consecutive floats
// per channel. With the policy, the kernels first run policy_tile over
// the block, which leaves the clipped actions in shared memory.
//
// In-place use: every block may be its own output (S == S_out, R ==
// R_out, GG == GG_out, OO == OO_out, EP == EP_out), as K5 carries its
// state. In each phase a column is written only by its owner, after every
// read of it in that phase: a window reads and writes only its agent's
// columns (its group's lanes synchronise before they store); the barrier
// after the windows orders their S_out writes before the tail's
// cross-drone reads; the barrier after the tail orders those reads and
// every read of GG, OO and EP before the autoreset and warp 0's writes;
// and each step begins with a barrier, which orders the previous step's
// writes (K5) and the policy's action rows before the windows.
//
// What bounds it: the window's serial chain, 20 ticks of ~1,500 flops per
// agent. At 4096 envs the N * 128 * L window warps meet 528 warp
// schedulers (132 SMs x 4), so each runs about one chain; the drones'
// windows no longer follow one another, and the lane group shortens each
// agent's instruction stream by the items it deals out (race_window.cuh):
// without the policy a 2-drone step takes about what a 1-drone step
// took, and a 1-drone step 15% less (PERF.md).
#pragma once

#include "policy.cuh"
#include "race_window.cuh"

namespace adrp {

constexpr int MAX_N = 8;
constexpr int MAX_G = 8;
constexpr int MAX_O = 8;
constexpr int R_CH = 14;
constexpr int RST_CH = 10;
constexpr int INFO_CH = 5;

// The policy's rows fit in shared memory at the limits: the widest obs (8
// COMPETE drones, 8 gates, 8 obstacles) and hidden layers.
static_assert((12 + 5 * MAX_G + 4 * MAX_O + 1 + 6 * (MAX_N - 1) +
               4 * MAX_HIDDEN + ACT_DIM + 1 + 3 * MAX_N) *
                      TILE * sizeof(float) <=
                  MAX_SMEM,
              "the policy's activations must fit in shared memory");

// The blocks of one step (mirrors ops/race_step.py::StepPtrs). OBS may be
// null (no observation output). With PP set the policy runs first
// (policy_tile): OBS_IN (C, T, 128) and ACTN (4, T, 128) are its inputs,
// A is not read, and ACT (4, T, 128), LOGP and VAL (T, 128) receive its
// outputs.
struct StepPtrs {
  const float *S, *A, *R, *GG, *OO, *EP, *RST, *RSTG, *RSTO, *noise;
  float *S_out, *R_out, *GG_out, *OO_out, *EP_out, *OBS, *REW, *DONE, *INFO;
  const float *OBS_IN, *PP, *ACTN;
  float *ACT, *LOGP, *VAL;
};

// Mirrors ops/race_step.py::StepConsts (values from tail_consts).
struct StepConsts {
  WindowConsts w;
  PolicyLayout pl;
  int N, Tb, G, O;
  int compete, per_drone_reward, end_after_gate, done_on_collision,
      done_on_completion, telemetry;
  float episode_len_sec, inv_freq, inv_G, inv_ray, elim_penalty;
  float bounds_hi[3];
  float dr2, edge_dr, beam_dr, beam_hh, edge_hh, sup_dr, obst_dr, half_h,
      ground_eps, dd_r2, dd_hz;
  float h_lo[MAX_G], h_hi[MAX_G], gz[MAX_G], sup_lo[MAX_G], sup_hi[MAX_G];
  float g_nom[4 * MAX_G];
  float o_lo[MAX_O], o_hi[MAX_O];
  float o_nom[3 * MAX_O];
};

// The launch geometry of K4 and K5: one block per TILE-env tile. Without
// the policy, one warp per window unit, N * LANES<false>, at most
// STEP_WARPS (a warp then takes several units); the 256-thread launch
// bound leaves the lane-group window the ~250 registers it uses without
// spilling. With it, the policy's POLICY_THREADS and its shared memory;
// 512 threads cap a thread at 128 registers, where a lane-group window
// spills (2 or 4 lanes: 272-612 bytes) and is slower than one lane per
// agent, so that instantiation keeps L = 1 (PERF.md).
template <bool POLICY>
constexpr int LANES = POLICY ? 1 : 4;
constexpr int STEP_WARPS = 8;
static_assert(MAX_N <= STEP_WARPS && 32 * STEP_WARPS <= POLICY_THREADS,
              "a tail warp per drone");
static_assert(TILE == 32 && TILE % LANES<false> == 0, "a unit is one warp");

// The tail's exchange (phase 2 to 3): eliminated, finished and gate of
// every drone, and drone 0's progress, per env of the tile.
constexpr int TAIL_SMEM = (3 * MAX_N + 1) * TILE * (int)sizeof(float);
static_assert(TAIL_SMEM <= STEP_STATIC_SMEM, "static shared memory");

struct StepLaunch {
  unsigned blocks;
  int threads;
  size_t smem;
};

inline StepLaunch step_launch(const StepConsts& c, bool policy) {
  const unsigned blocks = (unsigned)((long long)c.Tb * LANE / TILE);
  if (!policy) {
    const int units = c.N * LANES<false>;
    return {blocks, 32 * (units < STEP_WARPS ? units : STEP_WARPS), 0};
  }
  return {blocks, POLICY_THREADS, policy_smem_bytes(c.pl, c.N)};
}

// The geometry, registers and local (stack) bytes per thread of one
// instantiation of a kernel, for the C interfaces' *_geometry queries:
// out = [blocks, threads, dynamic shared bytes, registers, local bytes,
// static shared bytes].
template <typename Kernel>
inline int launch_report(Kernel kernel, const StepLaunch& g, long long* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = (long long)g.smem;
  out[3] = attr.numRegs;
  out[4] = (long long)attr.localSizeBytes;
  out[5] = (long long)attr.sharedSizeBytes;
  return (int)err;
}

__host__ __device__ __forceinline__ int obs_channels(const StepConsts& c) {
  return 12 + 5 * c.G + 4 * c.O + 1 + (c.compete ? 6 * (c.N - 1) : 0);
}

__device__ __forceinline__ int other_drone(int d, int j) {
  // the j-th drone of the env other than d, in ascending order
  return j < d ? j : j + 1;
}

// Phase 1 for one agent: drone d of env e, run by a lane group of L lanes
// (rank r). `pact`: null to read the action from A, or, in policy mode,
// this env's clipped actions from the policy phase, row 3 d + k at
// pact[(3 d + k) * TILE] (policy.cuh).
template <int L>
__device__ __forceinline__ void agent_window(const StepPtrs& p,
                                             const StepConsts& c, int d,
                                             long long e, const float* pact,
                                             int r) {
  const long long E = (long long)c.Tb * LANE;  // envs
  const long long nc = E * c.N;  // agent columns of a (C, T, 128) block
  const long long a = d * E + e;
  const float RAD_TO_DEG = F(RAD2DEG_D);
  float act[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    act[k] = pact != nullptr ? pact[(3 * d + k) * TILE] : p.A[k * nc + a];
  float s[S_CH];
#pragma unroll
  for (int k = 0; k < S_CH; ++k) s[k] = p.S[k * nc + a];
  const bool alive = p.R[1 * nc + a] < 0.5f;
  WinStatics w;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w.sp_pos[k] = s[k] + act[k];
    w.sp_vel[k] = 0.0f;
    w.sp_acc[k] = 0.0f;
    w.sp_rate[k] = 0.0f;
    w.J[k] = p.R[(11 + k) * nc + a];
  }
  w.sp_yaw_quat_deg = s[23] * RAD_TO_DEG;
  w.sp_thrust = 0.0f;
  w.pos_mode = alive;
  w.z_disable = !alive;
  w.planner = false;
  w.eliminated = !alive;
  w.t_begin = 0.0f;
  w.duration = 0.0f;
  w.mass = p.R[10 * nc + a];
  window_loop<false, L>(s, w, c.w,
                        p.noise != nullptr ? p.noise + a : nullptr, nc, r);
  // every rank holds the state; rank k % L stores channel k, once every
  // lane of the group has read its columns
  if constexpr (L > 1) __syncwarp();
#pragma unroll
  for (int k = 0; k < S_CH; ++k)
    if (k % L == r) p.S_out[k * nc + a] = s[k];
}

// Phase 2 for drone d of env e (lane l of the tile): returns the env's
// step count after this step; the drone's eliminated, finished and gate
// go to rows 3 d .. 3 d + 2 of `sh`, drone 0's progress to row 3 MAX_N.
__device__ __forceinline__ float drone_tail(const StepPtrs& p,
                                            const StepConsts& c, int d,
                                            long long e, int l, float* sh) {
  const long long E = (long long)c.Tb * LANE;
  const int N = c.N, G = c.G, O = c.O;
  const long long nc = E * N;
  float* OBS = p.OBS;
  float gx[MAX_G], gy[MAX_G], gyaw[MAX_G], gcs[MAX_G], gsn[MAX_G];
  for (int g = 0; g < G; ++g) {
    gx[g] = p.GG[(3 * g + 0) * E + e];
    gy[g] = p.GG[(3 * g + 1) * E + e];
    gyaw[g] = p.GG[(3 * g + 2) * E + e];
    gcs[g] = cosf(gyaw[g]);
    gsn[g] = sinf(gyaw[g]);
  }
  float obx[MAX_O], oby[MAX_O];
  for (int o = 0; o < O; ++o) {
    obx[o] = p.OO[(2 * o + 0) * E + e];
    oby[o] = p.OO[(2 * o + 1) * E + e];
  }
  const float ep_steps = p.EP[e] + 1.0f;
  const long long a = d * E + e;
  auto put = [&](int ch, float v) {
    if (OBS != nullptr) OBS[ch * nc + a] = v;
  };
  const float* S = p.S_out;
  const float px = S[0 * nc + a], py = S[1 * nc + a], pz = S[2 * nc + a];
  const float qx = S[3 * nc + a], qy = S[4 * nc + a];
  const float qz = S[5 * nc + a], qw = S[6 * nc + a];
  const float vx = S[7 * nc + a], vy = S[8 * nc + a], vz = S[9 * nc + a];
  const float wx = S[10 * nc + a], wy = S[11 * nc + a];
  const float wz = S[12 * nc + a];
  const float roll = S[21 * nc + a], pitch = S[22 * nc + a];
  const float yaw = S[23 * nc + a];
  float r00 = 1 - 2 * (qy * qy + qz * qz);
  float r01 = 2 * (qx * qy - qz * qw);
  float r02 = 2 * (qx * qz + qy * qw);
  float r10 = 2 * (qx * qy + qz * qw);
  float r11 = 1 - 2 * (qx * qx + qz * qz);
  float r12 = 2 * (qy * qz - qx * qw);
  float r20 = 2 * (qx * qz - qy * qw);
  float r21 = 2 * (qy * qz + qx * qw);
  float r22 = 1 - 2 * (qx * qx + qy * qy);
  const float ox_w = r00 * wx + r01 * wy + r02 * wz;
  const float oy_w = r10 * wx + r11 * wy + r12 * wz;
  const float oz_w = r20 * wx + r21 * wy + r22 * wz;

  const float cg0 = p.R[0 * nc + a];
  const float elim0 = p.R[1 * nc + a];
  const float fin0 = p.R[2 * nc + a];
  const float finished = maxf(fin0, cg0 >= (float)G ? 1.0f : 0.0f);
  float passed_any = 0.0f;
  for (int g = 0; g < G; ++g) {
    float relx = px - gx[g], rely = py - gy[g];
    float along = relx * gcs[g] + rely * gsn[g];
    float perp = fabsf(-relx * gsn[g] + rely * gcs[g]);
    float dz_lo = c.h_lo[g] - pz;
    float dz_hi = pz - c.h_hi[g];
    float dz_out = maxf(maxf(dz_lo, dz_hi), 0.0f);
    float i_near = clipf(rintf(along * c.inv_ray), -3.0f, 3.0f);
    float d_lat = fabsf(along - i_near * F(0.05));
    float dist2 = perp * perp + d_lat * d_lat + dz_out * dz_out;
    float hit = dist2 < c.dr2 ? 1.0f : 0.0f;
    passed_any = passed_any + hit * (cg0 == (float)g ? 1.0f : 0.0f);
  }
  const float in_prog = cg0 < (float)G ? 1.0f : 0.0f;
  const float current_gate = cg0 + minf(passed_any, 1.0f) * in_prog;

  bool crash = false;
  for (int g = 0; g < G; ++g) {
    float relx = px - gx[g], rely = py - gy[g];
    float along = relx * gcs[g] + rely * gsn[g];
    float perp = fabsf(-relx * gsn[g] + rely * gcs[g]);
    float dzc = pz - c.gz[g];
    bool within = fabsf(along) < c.edge_dr;
    bool horiz = within && (perp < c.beam_dr)
                 && ((fabsf(dzc - F(0.225)) < c.beam_hh)
                     || (fabsf(dzc + F(0.225)) < c.beam_hh));
    bool vert = (perp < c.beam_dr)
                && ((fabsf(along - F(0.225)) < c.beam_dr)
                    || (fabsf(along + F(0.225)) < c.beam_dr))
                && (fabsf(dzc) < c.edge_hh);
    float dxy = sqrtf(relx * relx + rely * rely);
    bool sup = (dxy < c.sup_dr) && (pz - c.half_h < c.sup_hi[g])
               && (pz + c.half_h > c.sup_lo[g]);
    crash = crash || horiz || vert || sup;
  }
  for (int o = 0; o < O; ++o) {
    float dx = px - obx[o], dy = py - oby[o];
    float dxy = sqrtf(dx * dx + dy * dy);
    crash = crash || ((dxy < c.obst_dr) && (pz - c.half_h < c.o_hi[o])
                      && (pz + c.half_h > c.o_lo[o]));
  }
  crash = crash || (pz <= c.ground_eps);
  if (c.compete) {
    for (int q = 0; q < N; ++q) {
      if (q == d) continue;
      const long long b = q * E + e;
      float ddx = px - S[0 * nc + b];
      float ddy = py - S[1 * nc + b];
      float dxy2 = ddx * ddx + ddy * ddy;
      crash = crash || ((dxy2 < c.dd_r2)
                        && (fabsf(pz - S[2 * nc + b]) < c.dd_hz));
    }
  }
  if (!c.done_on_collision) crash = false;
  bool oob = (fabsf(px) > c.bounds_hi[0]) || (fabsf(py) > c.bounds_hi[1])
             || (fabsf(pz) > c.bounds_hi[2]);
  bool unstable = (fabsf(ox_w) > 20.0f) || (fabsf(oy_w) > 20.0f)
                  || (fabsf(oz_w) > 20.0f);
  const float eliminated =
      maxf(elim0, (crash || oob || unstable) ? 1.0f : 0.0f);

  // visibility (exact min over the 5 frame capsules) + observation
  const float e_half = F(0.25), hb = F(0.025);
  put(0, px);
  put(1, py);
  put(2, pz);
  put(3, roll);
  put(4, pitch);
  put(5, yaw);
  put(6, vx);
  put(7, vy);
  put(8, vz);
  put(9, ox_w);
  put(10, oy_w);
  put(11, oz_w);
  const float gid = clipf(current_gate, 0.0f, (float)G - 1.0f);
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  for (int g = 0; g < G; ++g) {
    float relx = px - gx[g], rely = py - gy[g];
    float along = relx * gcs[g] + rely * gsn[g];
    float perp = -relx * gsn[g] + rely * gcs[g];
    float dzc = pz - c.gz[g];
    float a_cl = clipf(along, -e_half, e_half);
    float da = along - a_cl;
    float dt_ = dzc - F(0.225);
    float db_ = dzc + F(0.225);
    float d_top = sqrtf(da * da + perp * perp + dt_ * dt_) - hb;
    float d_bot = sqrtf(da * da + perp * perp + db_ * db_) - hb;
    float z_cl = clipf(dzc, -e_half, e_half);
    float al = along + F(0.225);
    float ar = along - F(0.225);
    float dz_ = dzc - z_cl;
    float d_l = sqrtf(al * al + perp * perp + dz_ * dz_) - hb;
    float d_r = sqrtf(ar * ar + perp * perp + dz_ * dz_) - hb;
    float s_cl = clipf(dzc - F(-0.6), F(-0.4), F(0.4));
    float ds_ = dzc - F(-0.6) - s_cl;
    float d_s = sqrtf(relx * relx + rely * rely + ds_ * ds_) - F(0.05);
    float dmin = minf(minf(minf(d_top, d_bot), minf(d_l, d_r)), d_s);
    float in_range = dmin < F(0.45) ? 1.0f : 0.0f;
    bool in_r = in_range > 0.5f;
    float pose[4] = {in_r ? gx[g] : c.g_nom[4 * g + 0],
                     in_r ? gy[g] : c.g_nom[4 * g + 1],
                     c.g_nom[4 * g + 2],
                     in_r ? gyaw[g] : c.g_nom[4 * g + 3]};
#pragma unroll
    for (int k = 0; k < 4; ++k) put(12 + 4 * g + k, pose[k]);
    put(12 + 4 * G + g, in_range);
    float m = gid == (float)g ? 1.0f : 0.0f;
    tx = tx + m * pose[0];
    ty = ty + m * pose[1];
    tz = tz + m * pose[2];
  }
  for (int o = 0; o < O; ++o) {
    float dx = px - obx[o], dy = py - oby[o];
    float dxy = sqrtf(dx * dx + dy * dy);
    float dz_out = maxf(maxf(c.o_lo[o] - pz, pz - c.o_hi[o]), 0.0f);
    float dmin = sqrtf(dxy * dxy + dz_out * dz_out) - F(0.05);
    float in_range = dmin < F(0.45) ? 1.0f : 0.0f;
    bool in_r = in_range > 0.5f;
    put(12 + 5 * G + 3 * o + 0, in_r ? obx[o] : c.o_nom[3 * o + 0]);
    put(12 + 5 * G + 3 * o + 1, in_r ? oby[o] : c.o_nom[3 * o + 1]);
    put(12 + 5 * G + 3 * o + 2, c.o_nom[3 * o + 2]);
    put(12 + 5 * G + 3 * O + o, in_range);
  }
  put(12 + 5 * G + 4 * O, current_gate);
  if (c.compete) {
    const int base = 12 + 5 * G + 4 * O + 1;
    const int pose_ch[6] = {0, 1, 2, 21, 22, 23};
    for (int j = 0; j < N - 1; ++j) {
      const long long b = other_drone(d, j) * E + e;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        put(base + 6 * j + k, S[pose_ch[k] * nc + b]);
    }
  }

  // ---- 4. shaping ---------------------------------------------------------
  const float shape_gate_id = p.R[3 * nc + a];
  const float sg_mod =
      shape_gate_id - (float)G * floorf(shape_gate_id * c.inv_G);
  const bool passed = current_gate > sg_mod;
  const float new_tx = passed ? tx : p.R[4 * nc + a];
  const float new_ty = passed ? ty : p.R[5 * nc + a];
  const float new_tz = passed ? tz : p.R[6 * nc + a];
  const float new_gate_id = passed ? current_gate : shape_gate_id;
  const float r_passed = passed ? 5.0f : 0.0f;
  float ex = new_tx - p.R[7 * nc + a], ey = new_ty - p.R[8 * nc + a];
  float d_prev_xy = sqrtf(ex * ex + ey * ey);
  float cx = new_tx - px, cy = new_ty - py;
  float d_cur_xy = sqrtf(cx * cx + cy * cy);
  float d_prev_z = fabsf(new_tz - p.R[9 * nc + a]);
  float d_cur_z = fabsf(new_tz - pz);
  const float progress =
      (d_prev_xy - d_cur_xy) + (d_prev_z - d_cur_z) + r_passed;
  if (c.per_drone_reward) {
    float elim_edge = eliminated - elim0;
    float finish_edge = finished - fin0;
    p.REW[a] = progress - c.elim_penalty * elim_edge + 10.0f * finish_edge;
  }

  // race rows before the autoreset
  float* Ro = p.R_out;
#pragma unroll
  for (int k = 10; k < R_CH; ++k) Ro[k * nc + a] = p.R[k * nc + a];
  Ro[0 * nc + a] = current_gate;
  Ro[1 * nc + a] = eliminated;
  Ro[2 * nc + a] = finished;
  Ro[3 * nc + a] = new_gate_id;
  Ro[4 * nc + a] = new_tx;
  Ro[5 * nc + a] = new_ty;
  Ro[6 * nc + a] = new_tz;
  Ro[7 * nc + a] = px;
  Ro[8 * nc + a] = py;
  Ro[9 * nc + a] = pz;
  if (c.telemetry) {
    p.INFO[0 * nc + a] = current_gate;
    p.INFO[1 * nc + a] = eliminated;
    p.INFO[2 * nc + a] = finished;
  }
  sh[(3 * d + 0) * TILE + l] = eliminated;
  sh[(3 * d + 1) * TILE + l] = finished;
  sh[(3 * d + 2) * TILE + l] = current_gate;
  if (d == 0) sh[3 * MAX_N * TILE + l] = progress;
  return ep_steps;
}

// Phase 3 for drone d of env e (lane l of the tile): the env-level
// termination and reward from every drone's row of `sh`, this drone's
// reward, telemetry and autoreset; drone 0's thread writes the env rows.
__device__ __forceinline__ void env_end(const StepPtrs& p,
                                        const StepConsts& c, int d,
                                        long long e, int l, float ep_steps,
                                        const float* sh) {
  const long long E = (long long)c.Tb * LANE;
  const int N = c.N, G = c.G, O = c.O;
  const long long nc = E * N;
  const long long a = d * E + e;
  float* OBS = p.OBS;
  const int C = obs_channels(c);
  float elim_d[MAX_N], fin_d[MAX_N], cg_d[MAX_N];
  for (int q = 0; q < N; ++q) {
    elim_d[q] = sh[(3 * q + 0) * TILE + l];
    fin_d[q] = sh[(3 * q + 1) * TILE + l];
    cg_d[q] = sh[(3 * q + 2) * TILE + l];
  }
  const float progress0 = sh[3 * MAX_N * TILE + l];
  float all_done = 0.0f, all_fin = 0.0f;
  for (int q = 0; q < N; ++q) {
    float dm = c.done_on_completion ? maxf(elim_d[q], fin_d[q]) : elim_d[q];
    all_done = q == 0 ? dm : minf(all_done, dm);
    all_fin = q == 0 ? fin_d[q] : minf(all_fin, fin_d[q]);
  }
  bool terminated = all_done > 0.5f;
  if (c.end_after_gate)
    terminated = terminated || (cg_d[0] >= (float)c.end_after_gate);
  const bool truncated =
      (ep_steps * (float)c.w.n_ticks) * c.inv_freq > c.episode_len_sec;
  const bool task_completed = all_fin > 0.5f;
  if (!c.per_drone_reward) {
    float r_coll = (terminated && !task_completed) ? -1.0f : 0.0f;
    float r_lap = (terminated && task_completed) ? 10.0f : 0.0f;
    float reward_env = progress0 + r_coll + r_lap;
    p.REW[a] = reward_env;
  }
  if (c.telemetry) {
    p.INFO[3 * nc + a] = ep_steps;
    p.INFO[4 * nc + a] = terminated ? 1.0f : 0.0f;
  }

  // ---- 5. autoreset -----------------------------------------------------------
  const bool done = terminated || truncated;
  const float d_env = done ? 1.0f : 0.0f;
  if (d == 0) {
    p.DONE[e] = d_env;
    p.EP_out[e] = ep_steps * (1.0f - d_env);
    for (int k = 0; k < 3 * G; ++k)
      p.GG_out[k * E + e] = done ? p.RSTG[k * E + e] : p.GG[k * E + e];
    for (int k = 0; k < 2 * O; ++k)
      p.OO_out[k * E + e] = done ? p.RSTO[k * E + e] : p.OO[k * E + e];
  }
  if (!done) return;

  const float keep = 1.0f - d_env;
  float rst[RST_CH];
#pragma unroll
  for (int k = 0; k < RST_CH; ++k) rst[k] = p.RST[k * nc + a];
  float cr = cosf(rst[3] / 2.0f), sr = sinf(rst[3] / 2.0f);
  float cp = cosf(rst[4] / 2.0f), sp = sinf(rst[4] / 2.0f);
  float cy = cosf(rst[5] / 2.0f), sy = sinf(rst[5] / 2.0f);
  float* So = p.S_out;
#pragma unroll
  for (int k = 0; k < S_CH; ++k) So[k * nc + a] = 0.0f;
  So[0 * nc + a] = rst[0];
  So[1 * nc + a] = rst[1];
  So[2 * nc + a] = rst[2];
  So[3 * nc + a] = sr * cp * cy - cr * sp * sy;
  So[4 * nc + a] = cr * sp * cy + sr * cp * sy;
  So[5 * nc + a] = cr * cp * sy - sr * sp * cy;
  So[6 * nc + a] = cr * cp * cy + sr * sp * sy;
  So[21 * nc + a] = rst[3];
  So[22 * nc + a] = rst[4];
  So[23 * nc + a] = rst[5];

  float* Ro = p.R_out;
#pragma unroll
  for (int k = 0; k < 4; ++k) Ro[k * nc + a] = Ro[k * nc + a] * keep;
  Ro[4 * nc + a] = p.RSTG[0 * E + e];
  Ro[5 * nc + a] = p.RSTG[1 * E + e];
  Ro[6 * nc + a] = c.g_nom[2];
  Ro[7 * nc + a] = rst[0];
  Ro[8 * nc + a] = rst[1];
  Ro[9 * nc + a] = rst[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) Ro[(10 + k) * nc + a] = rst[6 + k];

  // post-done obs = the fresh episode's first obs
  if (OBS == nullptr) return;
  for (int ch = 0; ch < C; ++ch) OBS[ch * nc + a] = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) OBS[k * nc + a] = rst[k];
  for (int k = 0; k < 4 * G; ++k) OBS[(12 + k) * nc + a] = c.g_nom[k];
  for (int k = 0; k < 3 * O; ++k)
    OBS[(12 + 5 * G + k) * nc + a] = c.o_nom[k];
  if (c.compete) {
    const int base = 12 + 5 * G + 4 * O + 1;
    for (int j = 0; j < N - 1; ++j) {
      const long long b = other_drone(d, j) * E + e;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        OBS[(base + 6 * j + k) * nc + a] = p.RST[k * nc + b];
    }
  }
}

// One race RL step for the block's tile of TILE envs from env e0; every
// thread of the block calls it (it holds barriers). `pact`: null, or the
// policy's clipped action rows in shared memory (policy.cuh), tile-wide.
template <int L>
__device__ __forceinline__ void race_step_tile(const StepPtrs& p,
                                               const StepConsts& c,
                                               long long e0,
                                               const float* pact) {
  __shared__ float sh[TAIL_SMEM / sizeof(float)];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  __syncthreads();
  // ---- 1+2. window statics from the action, the window ------------------
  for (int u = warp; u < c.N * L; u += nwarps) {
    const int d = u / L;
    const int el = (u % L) * (TILE / L) + lane / L;  // env of the tile
    agent_window<L>(p, c, d, e0 + el, pact != nullptr ? pact + el : nullptr,
                    lane % L);
  }
  __syncthreads();
  // ---- 3+4. control-rate tail, shaping, per drone -------------------------
  float ep_steps = 0.0f;
  if (warp < c.N) ep_steps = drone_tail(p, c, warp, e0 + lane, lane, sh);
  __syncthreads();
  // ---- env-level termination, 5. autoreset -------------------------------
  if (warp < c.N) env_end(p, c, warp, e0 + lane, lane, ep_steps, sh);
}

}  // namespace adrp

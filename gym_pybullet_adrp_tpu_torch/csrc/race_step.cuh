// One race RL step for one env, as a device function shared by the fused
// step kernel (race_step.cu, K4) and the K-step rollout kernel
// (race_rollout.cu, K5): the window statics from the FULLSTATE action (or
// from the policy forward, policy.cuh), the firmware window
// (race_window.cuh), the control-rate tail, and the autoreset.
//
// Replaces the body of gym_pybullet_adrp_tpu/ops/pallas_race_step.py
// (_step_core :151), which the JAX package also shares between its two
// kernels: one body, one maintenance point. The statement order follows
// ops/race_step.py::step_core_plain.
//
// Mapping: the calling thread owns env e. It runs the window for each of
// the env's N drones in turn, then the tail, so the cross-drone terms
// (drone-drone collisions, opponent observation channels, the env-level
// done) need no communication between threads: a drone's post-window
// state is written to S_out and read back by the same thread. Drone d of
// env e is column d * Tb * 128 + e of every (C, T, 128) block, so
// neighbouring threads touch neighbouring floats.
//
// In-place use: every block may be its own output (S == S_out, R ==
// R_out, GG == GG_out, OO == OO_out, EP == EP_out), as K5 carries its
// state. Each column is read completely before this thread writes it.
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

// The blocks of one step (mirrors ops/race_step.py::StepPtrs). OBS may be
// null (no observation output). With PP set the policy runs first: OBS_IN
// (C, T, 128) and ACTN (4, T, 128) are its inputs, A is not read, and
// ACT (4, T, 128), LOGP and VAL (T, 128) receive its outputs.
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

__host__ __device__ __forceinline__ int obs_channels(const StepConsts& c) {
  return 12 + 5 * c.G + 4 * c.O + 1 + (c.compete ? 6 * (c.N - 1) : 0);
}

__device__ __forceinline__ int other_drone(int d, int j) {
  // the j-th drone of the env other than d, in ascending order
  return j < d ? j : j + 1;
}

__device__ __forceinline__ void race_step_env(const StepPtrs& p,
                                              const StepConsts& c,
                                              const long long e) {
  const long long E = (long long)c.Tb * LANE;  // envs
  const int N = c.N, G = c.G, O = c.O;
  const long long nc = E * N;  // agent columns of a (C, T, 128) block
  const float RAD_TO_DEG = F(RAD2DEG_D);
  float* OBS = p.OBS;

  // ---- 0+1+2. (policy,) window statics from the action, the window -------
  for (int d = 0; d < N; ++d) {
    const long long a = d * E + e;
    float act[3];
    if (p.PP != nullptr) {
      float n[ACT_DIM], raw[ACT_DIM], logp, val;
#pragma unroll
      for (int k = 0; k < ACT_DIM; ++k) n[k] = p.ACTN[k * nc + a];
      policy_forward(p.PP, c.pl, p.OBS_IN + a, nc, n, raw, logp, val);
#pragma unroll
      for (int k = 0; k < ACT_DIM; ++k) p.ACT[k * nc + a] = raw[k];
      p.LOGP[a] = logp;
      p.VAL[a] = val;
      // the clipped action drives the step; its yaw (x pi) is not read
#pragma unroll
      for (int k = 0; k < 3; ++k) act[k] = clipf(raw[k], -1.0f, 1.0f);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) act[k] = p.A[k * nc + a];
    }
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
    window_loop<false>(s, w, c.w, p.noise != nullptr ? p.noise + a : nullptr,
                       nc);
#pragma unroll
    for (int k = 0; k < S_CH; ++k) p.S_out[k * nc + a] = s[k];
  }

  // ---- 3. control-rate tail ----------------------------------------------
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
  const int C = obs_channels(c);
  float elim_d[MAX_N], fin_d[MAX_N], cg_d[MAX_N];
  float progress0 = 0.0f;

  for (int d = 0; d < N; ++d) {
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
    if (d == 0) progress0 = progress;

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
    elim_d[d] = eliminated;
    fin_d[d] = finished;
    cg_d[d] = current_gate;
  }

  // ---- env-level termination ------------------------------------------------
  float all_done = 0.0f, all_fin = 0.0f;
  for (int d = 0; d < N; ++d) {
    float dm = c.done_on_completion ? maxf(elim_d[d], fin_d[d]) : elim_d[d];
    all_done = d == 0 ? dm : minf(all_done, dm);
    all_fin = d == 0 ? fin_d[d] : minf(all_fin, fin_d[d]);
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
    for (int d = 0; d < N; ++d) p.REW[d * E + e] = reward_env;
  }
  if (c.telemetry) {
    for (int d = 0; d < N; ++d) {
      p.INFO[3 * nc + d * E + e] = ep_steps;
      p.INFO[4 * nc + d * E + e] = terminated ? 1.0f : 0.0f;
    }
  }

  // ---- 5. autoreset -----------------------------------------------------------
  const bool done = terminated || truncated;
  const float d_env = done ? 1.0f : 0.0f;
  p.DONE[e] = d_env;
  p.EP_out[e] = ep_steps * (1.0f - d_env);
  for (int k = 0; k < 3 * G; ++k)
    p.GG_out[k * E + e] = done ? p.RSTG[k * E + e] : p.GG[k * E + e];
  for (int k = 0; k < 2 * O; ++k)
    p.OO_out[k * E + e] = done ? p.RSTO[k * E + e] : p.OO[k * E + e];
  if (!done) return;

  const float keep = 1.0f - d_env;
  for (int d = 0; d < N; ++d) {
    const long long a = d * E + e;
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
    if (OBS == nullptr) continue;
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
}

}  // namespace adrp

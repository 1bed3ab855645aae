"""Row-major race RL env: the packed state blocks carried across steps.

Counterpart of gym_pybullet_adrp_tpu/envs/race_rl_rowfast.py
(``RowRaceState`` :58, ``pack_policy_params`` :128, ``make_row_env``
:194 with its ``reset``, unfused ``step`` :648, ``step_fused`` :928,
``initial_obs`` :877, ``_step_draws`` :1002, ``step_policy`` :1038,
``_stacked_draws`` :1083, ``rollout_steps`` :1119, ``rollout_policy``
:1148 and ``initial_obs_rows`` :1174, and ``make_policy_rollout``
:1210). CF2X drones, PYB physics, FULLSTATE pose-relative actions,
COMPARE or COMPETE, any drone count, with or without reset randomization
and per-tick disturbances.

The state is the fused kernel's blocks (ops/race_step.py), channel-major
``(C, T, 128)`` with the drone-major layout: with B envs (a multiple of
128) and N drones, drone d of all envs occupies rows [d*Tb, (d+1)*Tb),
Tb = B/128.

Random numbers: the per-step draws (the (20, 7, T, 128) wind/thrust noise
block and the autoreset pose/inertia/geometry rows) come from the env's
``torch.Generator`` on the env's device and are passed to the kernels.
They are not the JAX package's ``jax.random`` streams; a test that needs
the same numbers on both sides passes ``draws`` explicitly. The K-step
methods take K steps' draws stacked along a leading axis, drawn in the
order K single steps would draw them, so one K5 launch and K steps give
the same bits.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.drone import CF2X_LEGACY
from ..models.policy import ActorCritic
from ..ops import race_rollout as race_rollout_ops
from ..ops import race_step as race_step_ops
from ..ops import race_window as race_window_ops
from ..utils import profiling
from ..utils.constants import GATE_Z_LOW, GATE_Z_TALL, RAD_TO_DEG
from ..utils.enums import DroneModel, Physics, RaceMode
from .race import RaceSpec, RaceTrack, model_scalars

LANE = race_window_ops.LANE
S_CH = race_window_ops.S_CHANNELS
W_CH = race_window_ops.W_CHANNELS


class RowRaceState(NamedTuple):
    """All-rows env state, held as the fused kernel's blocks."""

    S: torch.Tensor    # (58, N*Tb, 128) kernel state block
    R: torch.Tensor    # (14, N*Tb, 128) race rows
    GG: torch.Tensor   # (3*G, Tb, 128) actual gate x, y, yaw rows
    OO: torch.Tensor   # (2*O, Tb, 128) actual obstacle x, y rows
    EP: torch.Tensor   # (Tb, 128) ctrl steps this episode

    @property
    def current_gate(self):
        return self.R[0]

    @property
    def eliminated(self):
        return self.R[1]

    @property
    def finished(self):
        return self.R[2]

    @property
    def shape_gate_id(self):
        return self.R[3]

    @property
    def target_xyz(self):
        return self.R[4:7]

    @property
    def prev_pos(self):
        return self.R[7:10]

    @property
    def mass(self):
        return self.R[10]

    @property
    def inertia(self):
        return self.R[11:14]

    @property
    def ep_steps(self):
        return self.EP

    @property
    def gates_xyyaw(self):
        g3 = self.GG.shape[0]
        return self.GG.reshape(g3 // 3, 3, *self.GG.shape[1:])

    @property
    def obst_xy(self):
        o2 = self.OO.shape[0]
        return self.OO.reshape(o2 // 2, 2, *self.OO.shape[1:])


class StepDraws(NamedTuple):
    """The random inputs of one step (or of a reset)."""

    noise_rows: Optional[torch.Tensor]  # (n_ticks, 7, T, 128) or None
    RST: torch.Tensor                   # (10, T, 128)
    RSTG: torch.Tensor                  # (3G, Tb, 128)
    RSTO: torch.Tensor                  # (2O, Tb, 128)


def supports(spec: RaceSpec) -> bool:
    return spec.physics == Physics.PYB and spec.drone_model == DroneModel.CF2X


class RowRaceEnv:
    """The row env. Build it with ``make_row_env``.

    ``step(state, action, draws=None)`` takes ``action`` (B, 4) for one
    drone or (B, N, 4), in [-1, 1], and returns ``(state, obs, reward,
    done)`` plus, with ``telemetry``, an ``info`` dict of pre-autoreset
    rows (``current_gate``, ``eliminated``, ``finished``, ``ep_steps``,
    ``terminated``). ``obs`` is (B, C) or (B, N, C); ``reward`` is (B,)
    (drone-0 shaping, the reference RewardWrapper) or, with
    ``per_drone_reward``, (B, N); ``done`` (B,) is env-level.

    ``end_after_gate`` > 0 ends an episode once drone 0 has passed that
    many gates; ``elim_penalty`` scales the per-drone penalty of the step
    a drone is eliminated; ``policy_hidden`` are the tower widths of the
    policy packs ``step_policy``/``rollout_policy`` take. The env runs on
    ``device``, the card unless the caller asks for the CPU.
    """

    def __init__(self, spec: RaceSpec, track: RaceTrack, n_envs: int,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 per_drone_reward: bool = False, fused: bool = True,
                 telemetry: bool = False, end_after_gate: int = 0,
                 elim_penalty: float = 1.0, policy_hidden=(64, 64)):
        if not supports(spec):
            raise ValueError("row env: PYB physics and CF2X drones only")
        if n_envs % LANE:
            raise ValueError(f"n_envs must be a multiple of {LANE}")
        self.spec, self.track = spec, track
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        self.n_envs = n_envs
        self.N = N = spec.num_drones
        self.Tb = Tb = n_envs // LANE
        self.T = N * Tb
        self.G, self.O = spec.num_gates, spec.num_obstacles
        self.compete = spec.racemode == RaceMode.COMPETE and N > 1
        self.per_drone_reward = per_drone_reward
        self.fused = fused
        self.telemetry = telemetry
        self.elim_penalty = float(elim_penalty)
        self.policy_hidden = tuple(int(h) for h in policy_hidden)
        self.gates = np.asarray(track.gates_nominal, dtype=np.float32)
        self.obstacles = np.asarray(track.obstacles_nominal,
                                    dtype=np.float32)
        bounds_hi = np.asarray(track.bounds)[1]
        heights = np.where(self.gates[:, 6] == 0, GATE_Z_TALL, GATE_Z_LOW)
        self.kf, self.km, self.arm, self.ground_z = model_scalars(spec)
        self.n_ticks = spec.steps_per_ctrl
        self.dt = 1.0 / spec.pyb_freq
        self.drone_r, self.half_h = 0.06, 0.0125
        self.spec_tail = (
            N, Tb, self.G, self.O, self.gates, self.obstacles,
            tuple(float(v) for v in bounds_hi),
            tuple(float(h) for h in heights),
            self.compete, per_drone_reward, int(end_after_gate),
            spec.done_on_collision, spec.done_on_completion,
            float(spec.episode_len_sec), float(spec.pyb_freq),
            self.drone_r, self.half_h,
        )
        self._tc = race_step_ops.tail_consts(self.spec_tail, self.ground_z)
        self.obs_size = race_step_ops.obs_channels(N, self.G, self.O,
                                                   self.compete)
        self.action_scale = torch.tensor([1.0, 1.0, 1.0, math.pi],
                                         dtype=torch.float32,
                                         device=self.device)
        init_pos = np.asarray(track.init_pos, dtype=np.float32)[:N]
        init_rpy = np.asarray(track.init_rpy, dtype=np.float32)[:N]
        self._init_pos = [self._const_rows(init_pos[:, k]) for k in range(3)]
        self._init_rpy = [self._const_rows(init_rpy[:, k]) for k in range(3)]
        # fully deterministic configs draw the same reset rows every step
        self._static_draws = self._static_stack = None
        if not (spec.random_drone_state or spec.random_gates_obstacles
                or spec.random_drone_inertia or spec.disturbances):
            self._static_draws = self._sample_draws()

    # ---- layout helpers ------------------------------------------------------

    def _const_rows(self, per_drone_vals):
        """(N,) values -> (T, 1) drone-major row constant."""
        v = np.repeat(np.asarray(per_drone_vals, dtype=np.float32), self.Tb)
        return torch.from_numpy(v).to(self.device)[:, None]

    def _env_rows(self, x):
        """Per-env (Tb, 128) rows -> per-drone (T, 128)."""
        return x if self.N == 1 else torch.cat([x] * self.N, dim=0)

    def _d(self, x, d):
        return x[d * self.Tb:(d + 1) * self.Tb]

    def _per_drone_out(self, rows):
        """(T, 128) drone-major rows -> (B,) or (B, N)."""
        if self.N == 1:
            return rows.reshape(self.n_envs)
        return rows.reshape(self.N, self.n_envs).T

    def action_rows(self, action):
        """(B, 4) or (B, N, 4) actions in [-1, 1] -> (4, T, 128) rows of
        pose-relative setpoint offsets (x, y, z metres, yaw radians)."""
        a = torch.clamp(action.to(self.device, torch.float32), -1.0, 1.0)
        a = a * self.action_scale
        if a.dim() == 2:
            a = a[:, None, :]
        return a.permute(2, 1, 0).reshape(4, self.T, LANE).contiguous()

    # ---- random draws --------------------------------------------------------

    def _host_copy(self, values):
        """``values`` as float32 on the env's device. On the card the
        copy from pageable host memory waits for the stream to drain; each
        is a ``draws.host_copies`` span and counts one ``host_copies`` in
        the enclosing span (one counts dict a draws span, not a copy)."""
        profiling.count("host_copies")
        with profiling.span("draws.host_copies"):
            return torch.tensor(values, dtype=torch.float32,
                                device=self.device)

    def _uniform(self, shape, lo, hi):
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return lo + u * (hi - lo)

    def _sample_draws(self) -> StepDraws:
        spec, N, T, Tb, G, O = (self.spec, self.N, self.T, self.Tb, self.G,
                                self.O)
        dev, f32 = self.device, torch.float32
        noise_rows = None
        if spec.disturbances:
            lo = self._host_copy(spec.dyn_dist_low)
            hi = self._host_copy(spec.dyn_dist_high)
            nt = self.n_ticks
            wind = self._uniform((nt, 3, T, LANE), lo[:, None, None],
                                 hi[:, None, None])
            act_n = torch.randn((nt, 4, T, LANE), generator=self.generator,
                                device=dev) * spec.action_noise_std
            noise_rows = torch.cat([wind, act_n], dim=1).contiguous()
        if spec.random_drone_state:
            rp = self._host_copy(spec.rs_pos)
            rr = self._host_copy(spec.rs_rot)
            dpos = self._uniform((3, T, LANE), rp[:, 0, None, None],
                                 rp[:, 1, None, None])
            drpy = self._uniform((3, T, LANE), rr[:, 0, None, None],
                                 rr[:, 1, None, None])
        else:
            dpos = torch.zeros((3, T, LANE), dtype=f32, device=dev)
            drpy = torch.zeros((3, T, LANE), dtype=f32, device=dev)
        pose = ([self._init_pos[k] + dpos[k] for k in range(3)]
                + [self._init_rpy[k] + drpy[k] for k in range(3)])
        mass0 = CF2X_LEGACY["mass"]
        J0 = self._host_copy(CF2X_LEGACY["J"])
        if spec.random_drone_inertia:
            m_off = self._uniform((T, LANE), spec.ri_mass[0],
                                  spec.ri_mass[1])
            lo_j = self._host_copy([spec.ri_ixx[0], spec.ri_iyy[0],
                                    spec.ri_izz[0]])
            hi_j = self._host_copy([spec.ri_ixx[1], spec.ri_iyy[1],
                                    spec.ri_izz[1]])
            j_off = self._uniform((3, T, LANE), lo_j[:, None, None],
                                  hi_j[:, None, None])
            mass = torch.clamp(mass0 + m_off, 0.0, 100.0)
            J = torch.clamp(J0[:, None, None] + j_off, 0.0, 100.0)
        else:
            mass = torch.full((T, LANE), mass0, dtype=f32, device=dev)
            J = J0[:, None, None].expand(3, T, LANE)
        gate_nom = self._host_copy(
            self.gates[:, [0, 1, 5]])[:, :, None, None]  # (G, 3, 1, 1)
        obst_nom = self._host_copy(
            self.obstacles[:, :2])[:, :, None, None]     # (O, 2, 1, 1)
        if spec.random_gates_obstacles:
            g_off = self._uniform((G, 3, Tb, LANE), *spec.rg_gates)
            o_off = self._uniform((O, 2, Tb, LANE), *spec.rg_obstacles)
            gates_rows = gate_nom + g_off
            obst_rows = obst_nom + o_off
        else:
            gates_rows = gate_nom.expand(G, 3, Tb, LANE)
            obst_rows = obst_nom.expand(O, 2, Tb, LANE)
        RST = torch.stack(pose + [mass, J[0], J[1], J[2]], dim=0)
        return StepDraws(
            noise_rows=noise_rows,
            RST=RST.contiguous(),
            RSTG=gates_rows.reshape(3 * G, Tb, LANE).contiguous(),
            RSTO=obst_rows.reshape(2 * O, Tb, LANE).contiguous(),
        )

    def step_draws(self) -> StepDraws:
        """The random inputs of one step, from the env's generator."""
        with profiling.span("rollout.draws"):
            if self._static_draws is not None:
                return self._static_draws
            return self._sample_draws()

    # ---- reset ---------------------------------------------------------------

    def reset(self, draws: Optional[StepDraws] = None) -> RowRaceState:
        """Fresh episodes for every env, from ``draws`` (sampled from the
        generator when None; only the reset rows are read)."""
        if draws is None:
            draws = self.step_draws()
        RST, T, Tb = draws.RST, self.T, self.Tb
        px, py, pz, roll, pitch, yaw = (RST[k] for k in range(6))
        cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
        cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
        cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
        z = torch.zeros_like(px)
        S = torch.stack(
            [px, py, pz,
             sr * cp * cy - cr * sp * sy,
             cr * sp * cy + sr * cp * sy,
             cr * cp * sy - sr * sp * cy,
             cr * cp * cy + sr * sp * sy]
            + [z] * 14 + [roll, pitch, yaw] + [z] * 34,
            dim=0,
        )
        R = torch.stack(
            [z, z, z, z,
             self._env_rows(draws.RSTG[0]),
             self._env_rows(draws.RSTG[1]),
             torch.full_like(px, float(self.gates[0, 2])),
             px, py, pz,
             RST[6], RST[7], RST[8], RST[9]],
            dim=0,
        )
        return RowRaceState(
            S=S.contiguous(), R=R.contiguous(),
            GG=draws.RSTG.clone(), OO=draws.RSTO.clone(),
            EP=torch.zeros((Tb, LANE), dtype=torch.float32,
                           device=self.device),
        )

    def initial_obs_rows(self, state: RowRaceState):
        """(C, T, 128) first-episode obs: kinematics of the reset pose and
        the nominal gate/obstacle channels, as the autoreset writes it."""
        px, py, pz = state.prev_pos
        roll, pitch, yaw = state.S[21], state.S[22], state.S[23]
        z = torch.zeros_like(px)
        rows = [px, py, pz, roll, pitch, yaw] + [z] * 6
        for g in range(self.G):
            for v in self.gates[g, [0, 1, 2, 5]]:
                rows.append(torch.full_like(px, float(v)))
        rows += [z] * self.G
        for o in range(self.O):
            for v in self.obstacles[o, :3]:
                rows.append(torch.full_like(px, float(v)))
        rows += [z] * self.O
        rows += [z]
        if self.compete:
            N = self.N
            for j in range(N - 1):
                for ch in (px, py, pz, roll, pitch, yaw):
                    blocks = []
                    for d in range(N):
                        e = [x for x in range(N) if x != d][j]
                        blocks.append(self._d(ch, e))
                    rows.append(torch.cat(blocks, dim=0))
        return torch.stack(rows, dim=0)

    def initial_obs(self, state: RowRaceState):
        """First-episode obs in the step's (B, C) / (B, N, C) layout."""
        return self._obs_out(self.initial_obs_rows(state))

    def _obs_out(self, obs_rows):
        C = obs_rows.shape[0]
        if self.N == 1:
            return obs_rows.reshape(C, self.n_envs).T
        return obs_rows.reshape(C, self.N, self.n_envs).permute(2, 1, 0)

    # ---- step ----------------------------------------------------------------

    def step(self, state: RowRaceState, action, draws=None):
        if self.fused:
            return self.step_fused(state, action, draws)
        return self.step_unfused(state, action, draws)

    def step_fused(self, state: RowRaceState, action, draws=None):
        """Window + tail + autoreset as one launch of the race_step kernel
        (its plain version on CPU tensors)."""
        if draws is None:
            draws = self.step_draws()
        out = race_step_ops.race_step_fused(
            self.kf, self.km, self.arm, self.ground_z,
            state.S, self.action_rows(action), state.R, state.GG, state.OO,
            state.EP, draws.RST, draws.RSTG, draws.RSTO,
            n_ticks=self.n_ticks, dt=self.dt, spec_tail=self.spec_tail,
            noise_rows=draws.noise_rows, telemetry=self.telemetry,
            elim_penalty=self.elim_penalty,
        )
        return self._step_out(out)

    def build_W(self, state: RowRaceState, action_rows):
        """FULLSTATE pose-relative setpoint rows for race_window
        (eliminated drones -> STOP)."""
        S, elim = state.S, state.eliminated
        z = torch.zeros_like(elim)
        alive = 1.0 - elim
        rows = (
            [S[0] + action_rows[0], S[1] + action_rows[1],
             S[2] + action_rows[2]]
            + [z] * 9
            + [S[23] * RAD_TO_DEG]
            + [z]
            + [alive, elim, z, z, z, elim]
            + [z] * 32
            + [state.mass, state.inertia[0], state.inertia[1],
               state.inertia[2]]
            + [z]
        )
        return torch.stack(rows, dim=0)

    def step_unfused(self, state: RowRaceState, action, draws=None):
        """The race_window kernel, then the tail as plain tensor ops (the
        JAX package's window-kernel + XLA-tail twin of the fused step)."""
        if draws is None:
            draws = self.step_draws()
        W = self.build_W(state, self.action_rows(action))
        S = race_window_ops.race_window(
            self.kf, self.km, self.arm, self.ground_z, state.S, W,
            n_ticks=self.n_ticks, dt=self.dt, noise_rows=draws.noise_rows,
        )
        out = race_step_ops.tail_plain(
            self._tc, self.n_ticks, S, state.R, state.GG, state.OO,
            state.EP, draws.RST, draws.RSTG, draws.RSTO,
            telemetry=self.telemetry, elim_penalty=self.elim_penalty,
        )
        res = tuple(out[k] for k in race_step_ops._OUT_ORDER)
        return self._step_out(res + ((out["INFO"],)
                                     if self.telemetry else ()))

    def _step_out(self, out):
        S2, R2, GG2, OO2, EP2, OBS, REW, DONE = out[:8]
        new_state = RowRaceState(S=S2, R=R2, GG=GG2, OO=OO2, EP=EP2)
        B, N, Tb = self.n_envs, self.N, self.Tb
        obs = self._obs_out(OBS)
        if self.per_drone_reward:
            reward = REW.reshape(N, B).T
        else:
            reward = REW[:Tb].reshape(B)
        done = DONE.reshape(B) > 0.5
        if not self.telemetry:
            return new_state, obs, reward, done
        INFO = out[8]
        info = {
            "current_gate": self._per_drone_out(INFO[0]),
            "eliminated": self._per_drone_out(INFO[1]),
            "finished": self._per_drone_out(INFO[2]),
            "ep_steps": INFO[3][:Tb].reshape(B),
            "terminated": INFO[4][:Tb].reshape(B) > 0.5,
        }
        return new_state, obs, reward, done, info

    # ---- the policy inside the step, and K steps per launch -----------------

    def stacked_draws(self, K) -> StepDraws:
        """The random inputs of K steps, stacked along a leading K axis and
        drawn in the order K ``step_draws`` calls would draw them. Fully
        deterministic configs give one shared (1, ...) block."""
        with profiling.span("rollout.draws"):
            if self._static_draws is not None:
                if self._static_stack is None:
                    d = self._static_draws
                    self._static_stack = StepDraws(
                        None, d.RST[None], d.RSTG[None], d.RSTO[None])
                return self._static_stack
            steps = [self._sample_draws() for _ in range(K)]
            noise = (None if steps[0].noise_rows is None
                     else torch.stack([d.noise_rows for d in steps]))
            return StepDraws(noise, *[
                torch.stack([getattr(d, f) for d in steps])
                for f in ("RST", "RSTG", "RSTO")])

    def _kernel_kw(self):
        return dict(n_ticks=self.n_ticks, dt=self.dt,
                    spec_tail=self.spec_tail, elim_penalty=self.elim_penalty)

    def step_policy(self, state: RowRaceState, obs_rows, pack, actn,
                    draws=None):
        """One step with the policy inside the race_step kernel: the
        ActorCritic forward and Gaussian sample from the previous obs
        ``obs_rows`` (C, T, 128), the pack ``pack`` (``pack_policy_params``)
        and the draws ``actn`` (4, T, 128), then the env step. Returns
        ``(state, obs_rows', tr)``, ``tr`` the trajectory rows: unclipped
        ``action`` (4, T, 128), ``logp``/``value``/``reward`` (T, 128) and
        ``done`` (Tb, 128)."""
        if draws is None:
            draws = self.step_draws()
        out = race_step_ops.race_step_fused(
            self.kf, self.km, self.arm, self.ground_z, state.S, None,
            state.R, state.GG, state.OO, state.EP, draws.RST, draws.RSTG,
            draws.RSTO, noise_rows=draws.noise_rows, telemetry=False,
            policy_pack=pack, obs_rows=obs_rows, actn=actn,
            policy_hidden=self.policy_hidden, **self._kernel_kw())
        S2, R2, GG2, OO2, EP2, OBS, REW, DONE, ACT, LOGP, VAL = out
        tr = {"action": ACT, "logp": LOGP, "value": VAL, "reward": REW,
              "done": DONE}
        return RowRaceState(S2, R2, GG2, OO2, EP2), OBS, tr

    def rollout_steps(self, state: RowRaceState, action, draws=None):
        """K steps in one race_rollout launch, equal to K ``step_fused``
        calls. ``action`` (K, B, 4) or (K, B, N, 4) in [-1, 1]; ``draws``
        from ``stacked_draws(K)``. Returns (state', REW (K, T, 128),
        DONE (K, Tb, 128))."""
        K = action.shape[0]
        a = torch.clamp(action.to(self.device, torch.float32), -1.0, 1.0)
        a = a * self.action_scale
        if a.dim() == 3:
            a = a[:, :, None, :]
        rows = a.permute(0, 3, 2, 1).reshape(K, 4, self.T, LANE).contiguous()
        if draws is None:
            draws = self.stacked_draws(K)
        out = race_rollout_ops.race_rollout(
            self.kf, self.km, self.arm, self.ground_z, state.S, rows,
            state.R, state.GG, state.OO, state.EP, draws.RST, draws.RSTG,
            draws.RSTO, noise_rows_seq=draws.noise_rows, telemetry=False,
            emit_obs=False, **self._kernel_kw())
        return RowRaceState(*out[:5]), out[5], out[6]

    def rollout_policy(self, state: RowRaceState, obs_rows, pack, actn_seq,
                       draws=None):
        """K policy steps in one race_rollout launch, equal to K
        ``step_policy`` calls. Returns ``(state', obs_rows', tr)`` with
        ``tr`` stacked (K, ...): the post-step ``obs`` and ``action``,
        ``logp``, ``value``, ``reward``, ``done``."""
        K = actn_seq.shape[0]
        if draws is None:
            draws = self.stacked_draws(K)
        out = race_rollout_ops.race_rollout(
            self.kf, self.km, self.arm, self.ground_z, state.S, None,
            state.R, state.GG, state.OO, state.EP, draws.RST, draws.RSTG,
            draws.RSTO, noise_rows_seq=draws.noise_rows, telemetry=False,
            emit_obs=True, policy_pack=pack, obs_rows=obs_rows,
            actn_seq=actn_seq, policy_hidden=self.policy_hidden,
            **self._kernel_kw())
        S2, R2, GG2, OO2, EP2, REW, DONE, OBS, ACT, LOGP, VAL = out
        tr = {"obs": OBS, "action": ACT, "logp": LOGP, "value": VAL,
              "reward": REW, "done": DONE}
        return RowRaceState(S2, R2, GG2, OO2, EP2), OBS[-1], tr


def pack_policy_params(net: ActorCritic):
    """The in-kernel policy pack (ops/race_step.policy_layout) of ``net``,
    without gradients; rebuilt once per PPO iteration from the live
    weights."""
    if len(net.hidden) != 2:
        raise ValueError("the policy pack takes two hidden layers per tower")
    layers = [net.pi[0], net.pi[1], net.pi_out,
              net.vf[0], net.vf[1], net.vf_out]
    with torch.no_grad():
        return race_step_ops.pack_policy(
            net.obs_dim, net.hidden,
            [lay.weight for lay in layers] + [lay.bias for lay in layers]
            + [net.log_std])


def make_row_env(spec: RaceSpec, track: RaceTrack, n_envs: int,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 telemetry: bool = False, per_drone_reward: bool = False,
                 fused: bool = True, end_after_gate: int = 0,
                 elim_penalty: float = 1.0,
                 policy_hidden=(64, 64)) -> RowRaceEnv:
    """Build the row env on ``device`` (the card unless the caller asks
    for the CPU); draws come from ``generator`` (a generator on that
    device, seeded 0 when None)."""
    return RowRaceEnv(spec, track, n_envs, device=device,
                      generator=generator, per_drone_reward=per_drone_reward,
                      fused=fused, telemetry=telemetry,
                      end_after_gate=end_after_gate,
                      elim_penalty=elim_penalty, policy_hidden=policy_hidden)


def _ep_account(ep_ret, ep_len, rew, done, N):
    """Episode return/length bookkeeping for one step's (rew (T, 128),
    done (Tb, 128)) rows; returns the carried rows and the finished
    episodes' return (NaN elsewhere) and length (-1 elsewhere)."""
    done_rows = done.repeat(N, 1) > 0.5
    ep_ret2 = ep_ret + rew
    ep_len2 = ep_len + 1.0
    fin_ret = torch.where(done_rows, ep_ret2, float("nan"))
    fin_len = torch.where(done_rows, ep_len2, -1.0)
    return (torch.where(done_rows, 0.0, ep_ret2),
            torch.where(done_rows, 0.0, ep_len2), fin_ret, fin_len)


def make_policy_rollout(env: RowRaceEnv, n_steps: int, kernel_chunk: int = 16):
    """The policy-in-kernel PPO rollout pieces for a fused row env.

    ``kernel_chunk`` > 0 runs the rollout through race_rollout (K policy
    and env steps per launch) whenever it divides ``n_steps``; 0 keeps
    one race_step launch per step. Both draw the same numbers in the same
    order, so they give the same trajectories bit for bit.

    Returns ``(batched_reset, rollout_override, adapter_step)``:
    ``batched_reset() -> ((row_state, obs_rows), flat_obs)`` (the env
    state carries the row-form obs), ``rollout_override(ts) -> (ts, traj,
    metrics)`` for ``rl.ppo.make_ppo_core``, and an ``EnvAdapter.step``
    for the tuple state.
    """
    from ..rl.ppo import Transition

    if not env.fused:
        raise ValueError("the policy rollout needs a fused row env")
    B, N, Tb, T = env.n_envs, env.N, env.Tb, env.T
    C = env.obs_size

    def rows_to_flat(x):
        # (k, T, 128) drone-major rows -> (k, B*N) env-major
        k = x.shape[0]
        return x.reshape(k, N, B).permute(0, 2, 1).reshape(k, B * N)

    def chrows_to_flat(x, ch):
        # (k, ch, T, 128) -> (k, B*N, ch)
        k = x.shape[0]
        return x.reshape(k, ch, N, B).permute(0, 3, 2, 1).reshape(
            k, B * N, ch)

    def flat_to_rows(x):
        # (B*N,) env-major -> (T, 128) drone-major rows
        return x.reshape(B, N).T.reshape(T, LANE)

    def batched_reset():
        st = env.reset()
        obs_rows = env.initial_obs_rows(st)
        return (st, obs_rows), chrows_to_flat(obs_rows[None], C)[0]

    use_chunks = bool(kernel_chunk) and n_steps % kernel_chunk == 0

    def rollout_override(ts):
        with profiling.span("rollout"):
            return _rollout(ts)

    def _rollout(ts):
        actn = torch.randn((n_steps, 4, T, LANE), generator=ts.rng,
                           device=env.device)
        pack = pack_policy_params(ts.params)
        st, obs_rows = ts.env_state
        ep_ret = flat_to_rows(ts.ep_return)
        ep_len = flat_to_rows(ts.ep_len.to(torch.float32))
        ys = {k: [] for k in ("obs", "action", "logp", "value", "reward",
                              "done", "fin_ret", "fin_len")}

        def account(tr_rew, tr_done):
            nonlocal ep_ret, ep_len
            ep_ret, ep_len, fin_ret, fin_len = _ep_account(
                ep_ret, ep_len, tr_rew, tr_done, N)
            ys["fin_ret"].append(fin_ret)
            ys["fin_len"].append(fin_len)

        if use_chunks:
            K = kernel_chunk
            for c in range(n_steps // K):
                st, obs_last, tr = env.rollout_policy(
                    st, obs_rows, pack, actn[c * K:(c + 1) * K])
                with profiling.span("rollout.account"):
                    # Transition.obs is the pre-step obs each action saw
                    ys["obs"].append(torch.cat([obs_rows[None],
                                                tr["obs"][:-1]]))
                    for k in ("action", "logp", "value", "reward", "done"):
                        ys[k].append(tr[k])
                    for i in range(K):
                        account(tr["reward"][i], tr["done"][i])
                obs_rows = obs_last
        else:
            for i in range(n_steps):
                st, obs2, tr = env.step_policy(st, obs_rows, pack, actn[i])
                with profiling.span("rollout.account"):
                    ys["obs"].append(obs_rows)
                    for k in ("action", "logp", "value", "reward", "done"):
                        ys[k].append(tr[k])
                    account(tr["reward"], tr["done"])
                obs_rows = obs2
        with profiling.span("rollout.flatten"):
            join = torch.cat if use_chunks else torch.stack
            seq = {k: join(v) for k, v in ys.items()
                   if k not in ("fin_ret", "fin_len")}
            done_flat = seq["done"].reshape(n_steps, B) > 0.5
            if N > 1:
                done_flat = done_flat.repeat_interleave(N, dim=1)
            # the flat (time, batch, ...) layout, materialised once
            traj = Transition(
                obs=chrows_to_flat(seq["obs"], C).contiguous(),
                action=chrows_to_flat(seq["action"], 4).contiguous(),
                logp=rows_to_flat(seq["logp"]).contiguous(),
                value=rows_to_flat(seq["value"]).contiguous(),
                reward=rows_to_flat(seq["reward"]).contiguous(),
                done=done_flat,
            )
            metrics = {
                "finished_return": rows_to_flat(torch.stack(ys["fin_ret"])),
                "finished_len": rows_to_flat(
                    torch.stack(ys["fin_len"])).to(torch.int32),
            }
            ts = ts._replace(
                env_state=(st, obs_rows),
                last_obs=chrows_to_flat(obs_rows[None], C)[0],
                ep_return=rows_to_flat(ep_ret[None])[0],
                ep_len=rows_to_flat(ep_len[None])[0].to(torch.int32),
            )
        return ts, traj, metrics

    def adapter_step(env_state, action):
        st, _ = env_state
        act = action.reshape(B, N, 4) if N > 1 else action
        st2, obs, rew, done = env.step(st, act)[:4]
        obs_rows = obs.reshape(B, N, C).permute(2, 1, 0).reshape(C, T, LANE)
        return ((st2, obs_rows), obs.reshape(B * N, C), rew.reshape(-1),
                done.repeat_interleave(N) if N > 1 else done)

    return batched_reset, rollout_override, adapter_step

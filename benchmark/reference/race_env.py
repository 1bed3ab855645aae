"""The plain reference of the race row env's rollouts, independent of the
program.

Frozen from ``gym_pybullet_adrp_tpu_torch`` at commit f8ae565:

* the deployment's spec and track (``envs/race.py``:
  ``RaceSpec.from_config`` :97, ``track_from_config`` :162,
  ``model_scalars`` :193), read from the benchmark's configuration file;
* the row env's layout, draws, reset and first obs
  (``envs/race_rl_rowfast.py``: ``RowRaceEnv.__init__`` :135,
  ``_sample_draws`` :230, ``reset`` :302, ``initial_obs_rows`` :338,
  ``rollout_steps`` :502);
* the PPO rollout's episode accounting and flattening
  (``_ep_account`` :575 and ``make_policy_rollout`` :588).

One env step is ``plain_step.step_core_plain``: K steps in one K5 launch
equal K such steps, and K steps' stacked draws are drawn in the order K
single steps draw them, so the reference steps one at a time whatever the
program's chunk. On the card each step runs as one CUDA graph of the
plain ops (captured once, replayed every step): the same kernels as the
eager ops, without the host's cost of launching some ten thousand of them
a step.

Every tensor the reference returns is keyed by the name the harness
compares: ``state.*`` (the carried blocks and rows), ``traj.*`` (the
flat ``Transition``) and ``metrics.*``.
"""

import math

import numpy as np
import torch

from . import plain_step as ps

LANE = ps.LANE
# RaceSpec's defaults for the ranges a scenario may leave out
_DEFAULTS = dict(
    rs_pos=((-0.1, 0.1), (-0.1, 0.1), (0.0, 0.02)),
    rs_rot=((-0.1, 0.1), (-0.1, 0.1), (-0.1, 0.1)),
    ri_mass=(-0.01, 0.01), ri_ixx=(-1e-6, 1e-6), ri_iyy=(-1e-6, 1e-6),
    ri_izz=(-1e-6, 1e-6), rg_gates=(-0.15, 0.15),
    rg_obstacles=(-0.15, 0.15), action_noise_std=0.001,
    dyn_dist_low=(-0.1, -0.1, -0.1), dyn_dist_high=(0.1, 0.1, 0.1),
)
STATE_KEYS = ("S", "R", "GG", "OO", "EP")


def scenario_spec(config):
    """The race spec of a configuration file's ``scenario`` (a scenario
    YAML as JSON) at ``num_drones`` and ``racemode``: the race always
    runs at 500 Hz physics and firmware, 25 Hz control."""
    sc = config["scenario"]
    spec = dict(_DEFAULTS)
    spec.update(
        N=int(config["num_drones"]), G=len(sc["gates"]),
        O=len(sc["obstacles"]),
        compete=config["racemode"] == "COMPETE" and config["num_drones"] > 1,
        pyb_freq=ps.FIRMWARE_FREQ, ctrl_freq=ps.CTRL_FREQ,
        episode_len_sec=float(sc["episode_len_sec"]),
        done_on_completion=bool(sc.get("done_on_completion", True)),
        done_on_collision=bool(sc.get("done_on_collision", True)),
        random_drone_state=bool(sc.get("random_drone_state", False)),
        random_drone_inertia=bool(sc.get("random_drone_inertia", False)),
        random_gates_obstacles=bool(sc.get("random_gates_obstacles",
                                           False)),
        disturbances=bool(sc.get("disturbances", False)),
    )
    if spec["random_drone_state"]:
        info = sc["random_drone_state_info"]
        spec["rs_pos"] = tuple(tuple(info["pos"][k]) for k in "xyz")
        spec["rs_rot"] = tuple(tuple(info["rot"][k]) for k in "rpy")
    if spec["random_drone_inertia"]:
        info = sc["random_drone_inertia_info"]
        spec["ri_mass"] = tuple(info["M"]["range"])
        spec["ri_ixx"] = tuple(info["Ixx"]["range"])
        spec["ri_iyy"] = tuple(info["Iyy"]["range"])
        spec["ri_izz"] = tuple(info["Izz"]["range"])
    if spec["random_gates_obstacles"]:
        info = sc["random_gates_obstacles_info"]
        spec["rg_gates"] = tuple(info["gates"]["range"])
        spec["rg_obstacles"] = tuple(info["obstacles"]["range"])
    if spec["disturbances"]:
        info = sc["disturbances_info"]
        spec["action_noise_std"] = float(info["action"]["std"])
        spec["dyn_dist_low"] = tuple(info["dynamics"]["low"])
        spec["dyn_dist_high"] = tuple(info["dynamics"]["high"])
    spec["n_ticks"] = spec["pyb_freq"] // spec["ctrl_freq"]
    return spec


def scenario_track(config):
    """Gates (G, 7), obstacles (O, 6), bounds (2, 3) and the drones'
    start pos and rpy (N, 3), float32; drones beyond the scenario's
    entries spawn in a grid offset from the last entry."""
    sc, N = config["scenario"], int(config["num_drones"])
    drones = list(sc["init_states"])

    def rows(field, scale=1.0):
        vals = [np.asarray(sc["init_states"][d][field], dtype=float)
                for d in drones]
        while len(vals) < N:
            k = len(vals) - len(drones) + 1
            extra = vals[len(drones) - 1].copy()
            if field == "pos":
                extra = extra + np.array([0.2 * k, -0.2 * k, 0.0])
            vals.append(extra)
        return np.array(vals[:N], dtype=float) * scale

    f32 = np.float32
    return dict(
        gates=np.array(sc["gates"], dtype=float).astype(f32),
        obstacles=np.array(sc["obstacles"], dtype=float).astype(f32),
        bounds=np.array(sc["bounds"], dtype=float).astype(f32),
        init_pos=rows("pos").astype(f32),
        init_rpy=rows("rpy", math.pi / 180.0).astype(f32),
    )


class StepGraph:
    """``fn(**inputs) -> dict`` captured once as a CUDA graph over static
    input buffers; each call copies the inputs in, replays, and returns
    clones of the outputs."""

    def __init__(self, fn, inputs):
        self.static_in = {k: v.clone() for k, v in inputs.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(**self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = fn(**self.static_in)

    def __call__(self, inputs):
        for k, v in inputs.items():
            self.static_in[k].copy_(v)
        self.graph.replay()
        return {k: v.clone() for k, v in self.static_out.items()}


class RaceReference:
    """The reference of one configuration at ``n_envs`` envs on
    ``device``. ``weights`` (a dict of ``ActorCritic`` parameter names)
    is the policy of the policy rollouts; ``policy_dtype`` below float32
    is the control. On a CUDA device each step runs as a CUDA graph."""

    def __init__(self, config, n_envs, device, end_after_gate=0,
                 elim_penalty=1.0, weights=None,
                 policy_dtype=torch.float32):
        if n_envs % LANE:
            raise ValueError(f"n_envs must be a multiple of {LANE}")
        self.device = torch.device(device)
        self.spec = spec = scenario_spec(config)
        track = scenario_track(config)
        self.n_envs = n_envs
        self.N = N = spec["N"]
        self.Tb = Tb = n_envs // LANE
        self.T = N * Tb
        self.G, self.O = spec["G"], spec["O"]
        self.compete = spec["compete"]
        self.elim_penalty = float(elim_penalty)
        self.gates, self.obstacles = track["gates"], track["obstacles"]
        heights = np.where(self.gates[:, 6] == 0, ps.GATE_Z_TALL,
                           ps.GATE_Z_LOW)
        self.kf, self.km, self.arm = (ps.CF2X["kf"], ps.CF2X["km"],
                                      ps.CF2X["arm"])
        self.ground_z = (ps.CF2X["collision_h"] / 2.0
                         - ps.CF2X["collision_z_offset"])
        self.n_ticks = spec["n_ticks"]
        self.dt = 1.0 / spec["pyb_freq"]
        spec_tail = (
            N, Tb, self.G, self.O, self.gates, self.obstacles,
            tuple(float(v) for v in track["bounds"][1]),
            tuple(float(h) for h in heights),
            self.compete, N > 1, int(end_after_gate),
            spec["done_on_collision"], spec["done_on_completion"],
            float(spec["episode_len_sec"]), float(spec["pyb_freq"]),
            0.06, 0.0125,
        )
        self.wc = ps.window_consts(self.kf, self.km, self.arm, self.ground_z,
                                   self.dt, self.n_ticks)
        self.tc = ps.tail_consts(spec_tail, self.ground_z)
        self.C = ps.obs_channels(N, self.G, self.O, self.compete)
        self.action_scale = torch.tensor([1.0, 1.0, 1.0, math.pi],
                                         dtype=torch.float32,
                                         device=self.device)
        self._init_pos = [self._const_rows(track["init_pos"][:, k])
                          for k in range(3)]
        self._init_rpy = [self._const_rows(track["init_rpy"][:, k])
                          for k in range(3)]
        self.weights = weights
        self.policy_dtype = policy_dtype
        self.static = not (spec["random_drone_state"]
                           or spec["random_gates_obstacles"]
                           or spec["random_drone_inertia"]
                           or spec["disturbances"])
        self._static_draws = self._sample_draws(None) if self.static \
            else None
        self._graphs = {}

    # ---- layout --------------------------------------------------------------

    def _const_rows(self, per_drone_vals):
        v = np.repeat(np.asarray(per_drone_vals, dtype=np.float32), self.Tb)
        return torch.from_numpy(v).to(self.device)[:, None]

    def _env_rows(self, x):
        return x if self.N == 1 else torch.cat([x] * self.N, dim=0)

    def _d(self, x, d):
        return x[d * self.Tb:(d + 1) * self.Tb]

    def rows_to_flat(self, x):
        """(k, T, 128) drone-major rows -> (k, B*N) env-major."""
        k = x.shape[0]
        return x.reshape(k, self.N, self.n_envs).permute(0, 2, 1).reshape(
            k, self.n_envs * self.N)

    def chrows_to_flat(self, x, ch):
        """(k, ch, T, 128) -> (k, B*N, ch)."""
        k = x.shape[0]
        return x.reshape(k, ch, self.N, self.n_envs).permute(
            0, 3, 2, 1).reshape(k, self.n_envs * self.N, ch)

    def flat_to_rows(self, x):
        """(B*N,) env-major -> (T, 128) drone-major rows."""
        return x.reshape(self.n_envs, self.N).T.reshape(self.T, LANE)

    def generator(self, seed=None, state=None):
        """A generator on the device, seeded or set to ``state``."""
        g = torch.Generator(device=self.device)
        if state is not None:
            g.set_state(state)
        else:
            g.manual_seed(int(seed))
        return g

    # ---- draws, reset, first obs ---------------------------------------------

    def _uniform(self, gen, shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=self.device)
        return lo + u * (hi - lo)

    def _sample_draws(self, gen):
        spec, N, T, Tb, G, O = (self.spec, self.N, self.T, self.Tb, self.G,
                                self.O)
        dev, f32 = self.device, torch.float32
        noise_rows = None
        if spec["disturbances"]:
            lo = torch.tensor(spec["dyn_dist_low"], dtype=f32, device=dev)
            hi = torch.tensor(spec["dyn_dist_high"], dtype=f32, device=dev)
            nt = self.n_ticks
            wind = self._uniform(gen, (nt, 3, T, LANE), lo[:, None, None],
                                 hi[:, None, None])
            act_n = torch.randn((nt, 4, T, LANE), generator=gen,
                                device=dev) * spec["action_noise_std"]
            noise_rows = torch.cat([wind, act_n], dim=1).contiguous()
        if spec["random_drone_state"]:
            rp = torch.tensor(spec["rs_pos"], dtype=f32, device=dev)
            rr = torch.tensor(spec["rs_rot"], dtype=f32, device=dev)
            dpos = self._uniform(gen, (3, T, LANE), rp[:, 0, None, None],
                                 rp[:, 1, None, None])
            drpy = self._uniform(gen, (3, T, LANE), rr[:, 0, None, None],
                                 rr[:, 1, None, None])
        else:
            dpos = torch.zeros((3, T, LANE), dtype=f32, device=dev)
            drpy = torch.zeros((3, T, LANE), dtype=f32, device=dev)
        pose = ([self._init_pos[k] + dpos[k] for k in range(3)]
                + [self._init_rpy[k] + drpy[k] for k in range(3)])
        mass0 = ps.CF2X_LEGACY["mass"]
        J0 = torch.tensor(ps.CF2X_LEGACY["J"], dtype=f32, device=dev)
        if spec["random_drone_inertia"]:
            m_off = self._uniform(gen, (T, LANE), spec["ri_mass"][0],
                                  spec["ri_mass"][1])
            lo_j = torch.tensor([spec["ri_ixx"][0], spec["ri_iyy"][0],
                                 spec["ri_izz"][0]], dtype=f32, device=dev)
            hi_j = torch.tensor([spec["ri_ixx"][1], spec["ri_iyy"][1],
                                 spec["ri_izz"][1]], dtype=f32, device=dev)
            j_off = self._uniform(gen, (3, T, LANE), lo_j[:, None, None],
                                  hi_j[:, None, None])
            mass = torch.clamp(mass0 + m_off, 0.0, 100.0)
            J = torch.clamp(J0[:, None, None] + j_off, 0.0, 100.0)
        else:
            mass = torch.full((T, LANE), mass0, dtype=f32, device=dev)
            J = J0[:, None, None].expand(3, T, LANE)
        gate_nom = torch.from_numpy(
            np.ascontiguousarray(self.gates[:, [0, 1, 5]])
        ).to(dev)[:, :, None, None]
        obst_nom = torch.from_numpy(
            np.ascontiguousarray(self.obstacles[:, :2])
        ).to(dev)[:, :, None, None]
        if spec["random_gates_obstacles"]:
            g_off = self._uniform(gen, (G, 3, Tb, LANE), *spec["rg_gates"])
            o_off = self._uniform(gen, (O, 2, Tb, LANE),
                                  *spec["rg_obstacles"])
            gates_rows = gate_nom + g_off
            obst_rows = obst_nom + o_off
        else:
            gates_rows = gate_nom.expand(G, 3, Tb, LANE)
            obst_rows = obst_nom.expand(O, 2, Tb, LANE)
        RST = torch.stack(pose + [mass, J[0], J[1], J[2]], dim=0)
        return dict(
            noise=noise_rows,
            RST=RST.contiguous(),
            RSTG=gates_rows.reshape(3 * G, Tb, LANE).contiguous(),
            RSTO=obst_rows.reshape(2 * O, Tb, LANE).contiguous(),
        )

    def step_draws(self, gen):
        """One step's draws (the same rows every step for a deterministic
        configuration, which draws nothing)."""
        if self._static_draws is not None:
            return self._static_draws
        return self._sample_draws(gen)

    def reset(self, draws):
        RST, Tb = draws["RST"], self.Tb
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
             self._env_rows(draws["RSTG"][0]),
             self._env_rows(draws["RSTG"][1]),
             torch.full_like(px, float(self.gates[0, 2])),
             px, py, pz,
             RST[6], RST[7], RST[8], RST[9]],
            dim=0,
        )
        return dict(S=S.contiguous(), R=R.contiguous(),
                    GG=draws["RSTG"].clone(), OO=draws["RSTO"].clone(),
                    EP=torch.zeros((Tb, LANE), dtype=torch.float32,
                                   device=self.device))

    def initial_obs_rows(self, state):
        px, py, pz = state["R"][7], state["R"][8], state["R"][9]
        roll, pitch, yaw = state["S"][21], state["S"][22], state["S"][23]
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

    def start(self, env_gen):
        """The policy rollout's first inputs: the reset from ``env_gen``
        (its first draw), the first obs, zero episode returns and lengths,
        and the flat first obs (``state.last_obs``)."""
        st = self.reset(self.step_draws(env_gen))
        obs_rows = self.initial_obs_rows(st)
        out = {f"state.{k}": v for k, v in st.items()}
        BN = self.n_envs * self.N
        out.update({
            "state.obs_rows": obs_rows,
            "state.last_obs": self.chrows_to_flat(obs_rows[None], self.C)[0],
            "state.ep_return": torch.zeros(BN, device=self.device),
            "state.ep_len": torch.zeros(BN, dtype=torch.int32,
                                        device=self.device),
        })
        return out

    def start_actions(self, env_gen):
        """The action rollout's first inputs: the reset from ``env_gen``."""
        st = self.reset(self.step_draws(env_gen))
        return {f"state.{k}": v for k, v in st.items()}

    # ---- one step ------------------------------------------------------------

    def _step_fn(self, policy):
        wc, tc = self.wc, self.tc

        def fn(S, R, GG, OO, EP, RST, RSTG, RSTO, noise=None, A=None,
               obs=None, actn=None):
            pol = ((obs, self.weights, actn, self.policy_dtype) if policy
                   else None)
            out = ps.step_core_plain(wc, tc, S, A, R, GG, OO, EP, RST, RSTG,
                                     RSTO, noise_rows=noise,
                                     elim_penalty=self.elim_penalty,
                                     policy=pol)
            return out
        return fn

    def step(self, inputs, policy):
        """One env step from the dict ``inputs`` (state blocks, draws and
        the action rows ``A`` or the policy's ``obs`` and ``actn``)."""
        fn = self._step_fn(policy)
        if self.device.type != "cuda":
            return fn(**inputs)
        key = (policy, tuple(sorted(inputs)))
        if key not in self._graphs:
            self._graphs[key] = StepGraph(fn, inputs)
        return self._graphs[key](inputs)

    def _step_inputs(self, st, draws):
        inp = {k: st[k] for k in STATE_KEYS}
        inp.update(RST=draws["RST"], RSTG=draws["RSTG"], RSTO=draws["RSTO"])
        if draws["noise"] is not None:
            inp["noise"] = draws["noise"]
        return inp

    # ---- the rollouts --------------------------------------------------------

    @torch.no_grad()
    def policy_rollout(self, inputs, env_gen, pol_gen, n_steps):
        """``make_policy_rollout``'s ``rollout_override`` from ``inputs``
        (``start``'s keys): the policy's draws from ``pol_gen``, every
        step's env draws from ``env_gen``. Returns the flat trajectory,
        the finished episodes and the carried state."""
        N, B, C = self.N, self.n_envs, self.C
        actn = torch.randn((n_steps, 4, self.T, LANE), generator=pol_gen,
                           device=self.device)
        st = {k: inputs[f"state.{k}"] for k in STATE_KEYS}
        obs_rows = inputs["state.obs_rows"]
        ep_ret = self.flat_to_rows(inputs["state.ep_return"])
        ep_len = self.flat_to_rows(inputs["state.ep_len"].to(torch.float32))
        ys = {k: [] for k in ("obs", "action", "logp", "value", "reward",
                              "done", "fin_ret", "fin_len")}
        for i in range(n_steps):
            inp = self._step_inputs(st, self.step_draws(env_gen))
            inp.update(obs=obs_rows, actn=actn[i])
            out = self.step(inp, policy=True)
            ys["obs"].append(obs_rows)
            for k, o in (("action", "ACT"), ("logp", "LOGP"),
                         ("value", "VAL"), ("reward", "REW"),
                         ("done", "DONE")):
                ys[k].append(out[o])
            ep_ret, ep_len, fin_ret, fin_len = ep_account(
                ep_ret, ep_len, out["REW"], out["DONE"], N)
            ys["fin_ret"].append(fin_ret)
            ys["fin_len"].append(fin_len)
            st = {k: out[k] for k in STATE_KEYS}
            obs_rows = out["OBS"]
        seq = {k: torch.stack(v) for k, v in ys.items()}
        done_flat = seq["done"].reshape(n_steps, B) > 0.5
        if N > 1:
            done_flat = done_flat.repeat_interleave(N, dim=1)
        res = {
            "traj.obs": self.chrows_to_flat(seq["obs"], C),
            "traj.action": self.chrows_to_flat(seq["action"], 4),
            "traj.logp": self.rows_to_flat(seq["logp"]),
            "traj.value": self.rows_to_flat(seq["value"]),
            "traj.reward": self.rows_to_flat(seq["reward"]),
            "traj.done": done_flat,
            "metrics.finished_return": self.rows_to_flat(seq["fin_ret"]),
            "metrics.finished_len": self.rows_to_flat(
                seq["fin_len"]).to(torch.int32),
            "state.obs_rows": obs_rows,
            "state.last_obs": self.chrows_to_flat(obs_rows[None], C)[0],
            "state.ep_return": self.rows_to_flat(ep_ret[None])[0],
            "state.ep_len": self.rows_to_flat(ep_len[None])[0].to(
                torch.int32),
        }
        res.update({f"state.{k}": v for k, v in st.items()})
        return res

    def action_rows(self, action):
        """(B, 4) or (B, N, 4) actions in [-1, 1] -> (4, T, 128) rows."""
        a = torch.clamp(action.to(self.device, torch.float32), -1.0, 1.0)
        a = a * self.action_scale
        if a.dim() == 2:
            a = a[:, None, :]
        return a.permute(2, 1, 0).reshape(4, self.T, LANE).contiguous()

    @torch.no_grad()
    def action_rollout(self, inputs, env_gen, actions):
        """``len(actions)`` steps of ``RowRaceEnv.rollout_steps`` from
        ``inputs`` (``state.*``) with the actions (n_steps, B[, N], 4).
        Returns the carried state and every step's reward and done rows."""
        st = {k: inputs[f"state.{k}"] for k in STATE_KEYS}
        rew, done = [], []
        for i in range(actions.shape[0]):
            inp = self._step_inputs(st, self.step_draws(env_gen))
            inp["A"] = self.action_rows(actions[i])
            out = self.step(inp, policy=False)
            rew.append(out["REW"])
            done.append(out["DONE"])
            st = {k: out[k] for k in STATE_KEYS}
        res = {f"state.{k}": v for k, v in st.items()}
        res.update({"rows.reward": torch.stack(rew),
                    "rows.done": torch.stack(done)})
        return res


def ep_account(ep_ret, ep_len, rew, done, N):
    """Episode return and length bookkeeping for one step's rows: the
    carried rows, and the finished episodes' return (NaN elsewhere) and
    length (-1 elsewhere)."""
    done_rows = done.repeat(N, 1) > 0.5
    ep_ret2 = ep_ret + rew
    ep_len2 = ep_len + 1.0
    fin_ret = torch.where(done_rows, ep_ret2, float("nan"))
    fin_len = torch.where(done_rows, ep_len2, -1.0)
    return (torch.where(done_rows, 0.0, ep_ret2),
            torch.where(done_rows, 0.0, ep_len2), fin_ret, fin_len)

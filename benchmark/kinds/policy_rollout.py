"""Entry kind ``policy_rollout``: the race PPO trainer's rollout phase.

The window calls ``rollout_override`` of
``envs/race_rl_rowfast.make_policy_rollout`` (the function
``rl/ppo.make_ppo_core``'s ``train_step`` calls at the start of every
iteration of ``train_race.py --fuse_policy``): ``n_steps`` env steps of
every env with the policy's forward and Gaussian sample inside K5
(``race_rollout``), ``kernel_chunk`` steps a launch, the episode
accounting and the flat ``Transition``. The env and the trainer's state
are built as ``train_race._row_adapter`` and ``make_ppo_core`` build
them; the benchmark hands in its own generators and weights.

``Control`` puts the benchmark's reference in the program's place with
the policy's towers in a lower precision: the check must fail it.
"""

import torch

from benchmark.reference.race_env import STATE_KEYS, RaceReference

KERNEL = "race_rollout_kernel"
START_KEYS = tuple(f"state.{k}" for k in STATE_KEYS) + (
    "state.obs_rows", "state.last_obs", "state.ep_return", "state.ep_len")


def launches_per_call(traffic):
    return traffic["n_steps"] // traffic["kernel_chunk"]


def port_spec_track(config):
    """The port's ``RaceSpec`` and ``RaceTrack`` of a configuration."""
    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.utils.config import AttrDict
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    sc = AttrDict.convert(config["scenario"])
    N = int(config["num_drones"])
    spec = race_mod.RaceSpec.from_config(sc, N, RaceMode[config["racemode"]],
                                         Physics.PYB)
    return spec, race_mod.track_from_config(sc, N)


def port_env(run):
    """The port's row env of the run, as the trainer builds it."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import make_row_env

    spec, track = port_spec_track(run.config)
    tr = run.traffic
    return make_row_env(
        spec, track, tr["n_envs"], device=run.device,
        generator=run.env_gen, end_after_gate=tr["end_after_gate"],
        per_drone_reward=spec.num_drones > 1,
        elim_penalty=tr["elim_penalty"],
        policy_hidden=tuple(run.config["policy"]["hidden"]))


def _check_traffic(traffic):
    if not traffic.get("stochastic", True):
        raise ValueError("policy_rollout: the trainer's rollout samples its "
                         "actions (stochastic: true)")
    if traffic["n_steps"] % traffic["kernel_chunk"]:
        raise ValueError("policy_rollout: kernel_chunk must divide n_steps")


class Program:
    """The port's rollout; ``override`` is the call the window times."""

    def __init__(self, run):
        from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
            make_policy_rollout,
        )
        from gym_pybullet_adrp_tpu_torch.rl.ppo import (
            EnvAdapter, PPOConfig, make_ppo_core,
        )

        tr = run.traffic
        _check_traffic(tr)
        self.env = env = port_env(run)
        hidden = tuple(run.config["policy"]["hidden"])
        B, N, n_steps = tr["n_envs"], env.N, tr["n_steps"]
        b_reset, self.override, fused_step = make_policy_rollout(
            env, n_steps, kernel_chunk=tr["kernel_chunk"])
        adapter = EnvAdapter(batched_reset=b_reset, step=fused_step,
                             obs_dim=env.obs_size, act_dim=4,
                             generator=run.env_gen)
        # the trainer's PPO config (train_race.train): 8 minibatches
        blk = 512
        while (B * N * n_steps // 8) % blk:
            blk //= 2
        cfg = PPOConfig(n_envs=B * N, n_steps=n_steps, shuffle_block=blk)
        init_fn, _, _ = make_ppo_core(cfg, adapter, hidden=hidden,
                                      rollout_override=self.override,
                                      device=run.device)
        ts = init_fn(run.seeds["policy"])
        ts.params.load_state_dict(run.weights)
        self.ts = ts._replace(rng=run.pol_gen)

    def inputs(self):
        ts = self.ts
        st, obs_rows = ts.env_state
        out = {f"state.{k}": getattr(st, k) for k in STATE_KEYS}
        out.update({"state.obs_rows": obs_rows, "state.last_obs": ts.last_obs,
                    "state.ep_return": ts.ep_return,
                    "state.ep_len": ts.ep_len})
        return out

    def call(self):
        self.ts, traj, metrics = self.override(self.ts)
        return traj, metrics

    def outputs(self, out):
        traj, metrics = out
        res = {f"traj.{k}": v for k, v in traj._asdict().items()}
        res.update({f"metrics.{k}": v for k, v in metrics.items()})
        res.update(self.inputs())
        return res


class Control:
    """The reference in the program's place, its policy in ``dtype``."""

    def __init__(self, run, dtype):
        tr = run.traffic
        _check_traffic(tr)
        self.run = run
        self.ref = reference(run, dtype)
        self.state = self.ref.start(run.env_gen)

    def inputs(self):
        return self.state

    def call(self):
        out = self.ref.policy_rollout(self.state, self.run.env_gen,
                                      self.run.pol_gen,
                                      self.run.traffic["n_steps"])
        self.state = {k: out[k] for k in START_KEYS}
        return out

    def outputs(self, out):
        return out


def reference(run, dtype=torch.float32):
    tr = run.traffic
    return RaceReference(run.config, tr["n_envs"], run.device,
                         end_after_gate=tr["end_after_gate"],
                         elim_penalty=tr["elim_penalty"],
                         weights=run.weights, policy_dtype=dtype)


def check(run, start, warmup, sample, compare):
    """The numbers that decide ``correct``: mismatching elements of the
    program's first state against the reference's reset from the seed, of
    the first (warm-up) rollout against the reference's from that reset,
    and of the sampled window rollout against the reference's from the
    program's state and the generators' states at its start."""
    ref = reference(run)
    n = run.traffic["n_steps"]
    env_gen = ref.generator(run.seeds["env"])
    pol_gen = ref.generator(run.seeds["policy"])
    ref_start = ref.start(env_gen)
    out = [("reset_mismatch", compare(start, ref_start))]
    out.append(("warmup_mismatch", compare(
        warmup, ref.policy_rollout(ref_start, env_gen, pol_gen, n))))
    snap, got = sample
    out.append(("window_mismatch", compare(got, ref.policy_rollout(
        snap["inputs"], ref.generator(state=snap["env_gen"]),
        ref.generator(state=snap["pol_gen"]), n))))
    return out

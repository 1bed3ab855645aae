"""Entry kind ``action_rollout``: K5 (``race_rollout``) in action mode.

Each call runs ``n_steps`` env steps of every env through
``RowRaceEnv.rollout_steps``, ``kernel_chunk`` steps a launch, with
actions the benchmark drew from the seed at set-up (uniform in
+-``action_amplitude``, the same bank every call) and the env's per-step
draws. It bypasses the policy, the episode accounting and the flat
trajectory: what is left is the env step, its draws and the launch.

``Control`` puts the benchmark's reference in the program's place with
the action bank rounded to a lower precision (the operand a later change
might store narrower): the check must fail it.
"""

import torch

from benchmark.kinds.policy_rollout import (
    KERNEL, launches_per_call, port_env,
)
from benchmark.reference.race_env import STATE_KEYS, RaceReference

__all__ = ("KERNEL", "launches_per_call", "Program", "Control", "check")
START_KEYS = tuple(f"state.{k}" for k in STATE_KEYS)


def make_actions(run):
    """The action bank (n_steps, B[, N], 4), from the seed, on the card."""
    tr, N = run.traffic, int(run.config["num_drones"])
    shape = (tr["n_steps"], tr["n_envs"]) + ((N,) if N > 1 else ()) + (4,)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seeds["actions"])
    u = torch.rand(shape, generator=gen, device=run.device)
    a = float(tr["action_amplitude"])
    return u * (2.0 * a) - a


def _check_traffic(traffic):
    if traffic["n_steps"] % traffic["kernel_chunk"]:
        raise ValueError("action_rollout: kernel_chunk must divide n_steps")


class Program:
    """The port's row env stepped K steps a launch."""

    def __init__(self, run):
        _check_traffic(run.traffic)
        self.env = port_env(run)
        self.K = run.traffic["kernel_chunk"]
        self.actions = run.actions
        self.state = self.env.reset()

    def inputs(self):
        return {f"state.{k}": getattr(self.state, k) for k in STATE_KEYS}

    def call(self):
        rew, done = [], []
        for c in range(self.actions.shape[0] // self.K):
            self.state, r, d = self.env.rollout_steps(
                self.state, self.actions[c * self.K:(c + 1) * self.K])
            rew.append(r)
            done.append(d)
        return torch.cat(rew), torch.cat(done)

    def outputs(self, out):
        res = {"rows.reward": out[0], "rows.done": out[1]}
        res.update(self.inputs())
        return res


class Control:
    """The reference in the program's place, its actions in ``dtype``."""

    def __init__(self, run, dtype):
        _check_traffic(run.traffic)
        self.run = run
        self.ref = reference(run)
        self.actions = run.actions.to(dtype).to(torch.float32)
        self.state = self.ref.start_actions(run.env_gen)

    def inputs(self):
        return self.state

    def call(self):
        out = self.ref.action_rollout(self.state, self.run.env_gen,
                                      self.actions)
        self.state = {k: out[k] for k in START_KEYS}
        return out

    def outputs(self, out):
        return out


def reference(run):
    tr = run.traffic
    return RaceReference(run.config, tr["n_envs"], run.device,
                         end_after_gate=tr["end_after_gate"],
                         elim_penalty=tr["elim_penalty"])


def check(run, start, warmup, sample, compare):
    """Mismatching elements of the reset, the first call from it and the
    sampled window call, as for ``policy_rollout``."""
    ref = reference(run)
    env_gen = ref.generator(run.seeds["env"])
    ref_start = ref.start_actions(env_gen)
    out = [("reset_mismatch", compare(start, ref_start))]
    out.append(("warmup_mismatch", compare(
        warmup, ref.action_rollout(ref_start, env_gen, run.actions))))
    snap, got = sample
    out.append(("window_mismatch", compare(got, ref.action_rollout(
        snap["inputs"], ref.generator(state=snap["env_gen"]),
        run.actions))))
    return out

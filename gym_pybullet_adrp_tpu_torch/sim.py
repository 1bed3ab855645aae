"""Race evaluation CLI: user controllers flying MultiRaceAviary.

Counterpart of scripts/sim.py (``simulate`` :24, reference
scripts/sim.py:18-117): load a scenario config, build the race env on
``device`` (the card unless the caller asks for the CPU), load one
controller per drone, run episodes and print each one's time, reward,
gates, finished and eliminated drones. A controller is the name of one of
the port's agents (gym_pybullet_adrp_tpu_torch/agents: ``hardcoded``,
``hardcoded_twogates``, ``hover``, ``rl_agent``, ``rl_fulltrack``,
``rl_twogates``) or the path of a controller module. The controllers get
the env's device in their initial info (``info["device"]``), beside the
reference's ``info["delay"]``.

Usage:
  python -m gym_pybullet_adrp_tpu_torch.sim --config getting_started \\
      --controller hardcoded --n_runs 1 --n_drones 2 [--device cpu]
"""

import argparse
import time
from pathlib import Path

import numpy as np

from .envs.race import MultiRaceAviary
from .utils.config import load_config
from .utils.enums import RaceMode
from .utils.utils import load_controller, sync


def simulate(config="getting_started", controller=("hardcoded",),
             n_runs: int = 10, n_drones: int = 2, gui: bool = False,
             racemode: str = "compare", device="cuda"):
    """Evaluate drone controllers over ``n_runs`` episodes (reference
    simulate:18-112). Returns the list of episode times (s)."""
    cfg = load_config(config)
    env = MultiRaceAviary(
        cfg, num_drones=n_drones,
        racemode=(RaceMode.COMPETE if racemode == "compete"
                  else RaceMode.COMPARE), device=device)
    if isinstance(controller, (str, Path)):
        controller = (controller,)
    controllers = list(controller)
    if len(controllers) != n_drones:
        controllers = (controllers * n_drones)[:n_drones]
    classes = [load_controller(c) for c in controllers]

    episode_times, episode_rewards = [0.0] * n_runs, [0.0] * n_runs
    for run in range(n_runs):
        episode_start = time.time()
        sim_time, episode_step = 0.0, 0
        terminated = truncated = False
        obs, info = env.reset()
        agents = []
        for drone_id, cls in enumerate(classes):
            info.update(delay=drone_id, device=str(env.device))
            agents.append(cls(drone_id, obs[drone_id], dict(info)))
        while not (terminated or truncated):
            sim_time = episode_step / env.CTRL_FREQ
            actions = [a.predict(obs[i], ep_time=sim_time)
                       for i, a in enumerate(agents)]
            if all(isinstance(a, np.ndarray) for a in actions):
                actions = np.array(actions)
            obs, reward, terminated, truncated, _ = env.step(actions)
            episode_rewards[run] += reward
            if gui:
                sync(sim_time, episode_start, 1 / env.CTRL_FREQ)
            episode_step += 1
        episode_times[run] = sim_time
        print(f"[run {run}] time {sim_time:.2f}s  reward "
              f"{episode_rewards[run]:.2f}  gates {env.current_gate}  "
              f"finished {env.drones_finished}  eliminated "
              f"{env.drones_eliminated}", flush=True)
    env.close()
    return episode_times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="getting_started",
                    help="a bundled config name or a YAML path")
    ap.add_argument("--controller", nargs="+", default=["hardcoded"],
                    help="port agent names or controller module paths, "
                         "one per drone (repeated to fill)")
    ap.add_argument("--n_runs", type=int, default=10)
    ap.add_argument("--n_drones", type=int, default=2)
    ap.add_argument("--gui", action="store_true",
                    help="pace the loop to real time")
    ap.add_argument("--racemode", choices=["compare", "compete"],
                    default="compare")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    times = simulate(config=args.config, controller=args.controller,
                     n_runs=args.n_runs, n_drones=args.n_drones,
                     gui=args.gui, racemode=args.racemode,
                     device=args.device)
    print("episode times:", times)


if __name__ == "__main__":
    main()

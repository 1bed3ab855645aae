"""PPO hover training (reference examples/learn.py).

Counterpart of examples/learn.py on the port (``device``: the card unless
the caller asks for the CPU). Trains an actor-critic policy on the hover
env (MultiHover with ``multiagent``) with the reference's stop-training
reward thresholds (reference learn.py:78-81: 474.15 single / 949.5 multi
for one_d_rpm; 467 / 920 otherwise), saves the best and the final policy
as flax-msgpack artifacts (``rl.checkpoint.save_policy``, which the JAX
package reads), evaluates the best one deterministically 10 times and
replays it in ``HoverAviary`` (or ``MultiHoverAviary``) into the flight
``Logger``. ``obs="rgb"`` trains a ``CnnActorCritic`` on drone 0's
32x24 POV frames (``rl.ppo.rgb_hover_adapter``).

    python -m gym_pybullet_adrp_tpu_torch.examples.learn --multiagent false \\
        --local true
"""

import argparse
import copy
import os
import time
from datetime import datetime

import numpy as np
import torch

from ..envs import rl as rlenv
from ..envs.aviary import HoverAviary, MultiHoverAviary
from ..envs.core import AviaryConfig
from ..models.drone import drone_params
from ..models.policy import CnnActorCritic
from ..rl.checkpoint import save_policy
from ..rl.ppo import PPOConfig, make_ppo, make_ppo_core, rgb_hover_adapter
from ..utils.enums import ActionType, DroneModel, ObservationType
from ..utils.logger import Logger
from ..utils.utils import str2bool

DEFAULT_GUI = False
DEFAULT_RECORD_VIDEO = False
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False
DEFAULT_OBS = "kin"
DEFAULT_ACT = "one_d_rpm"
DEFAULT_AGENTS = 2
DEFAULT_MA = False
IMG_W, IMG_H = 32, 24


def run(
    multiagent=DEFAULT_MA,
    output_folder=DEFAULT_OUTPUT_FOLDER,
    gui=DEFAULT_GUI,
    plot=True,
    colab=DEFAULT_COLAB,
    record_video=DEFAULT_RECORD_VIDEO,
    local=True,
    act=DEFAULT_ACT,
    obs=DEFAULT_OBS,
    n_envs=512,
    max_iters=2000,
    n_eval=10,
    device="cuda",
):
    """Train, save, evaluate and replay; returns the best evaluation
    return. ``local=False`` trains 2 iterations (the reference's CI
    size); ``n_eval`` is the number of final deterministic evaluations
    (the reference's 10)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    filename = os.path.join(
        output_folder, "save-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
    os.makedirs(filename, exist_ok=True)

    act_type = ActionType(act)
    num_drones = DEFAULT_AGENTS if multiagent else 1
    rl_cfg = rlenv.RLConfig(
        aviary=AviaryConfig(ctrl_freq=30, num_drones=num_drones),
        act_type=act_type, task="multihover" if multiagent else "hover")
    params = drone_params(DroneModel.CF2X, device=device)
    init_xyzs = np.array([[x * 4 * 0.0397, x * 4 * 0.0397, 0.1125]
                          for x in range(num_drones)])
    init_rpys = np.zeros((num_drones, 3))

    # target cumulative rewards (reference learn.py:78-81)
    if act_type == ActionType.ONE_D_RPM:
        target_reward = 474.15 if not multiagent else 949.5
    else:
        target_reward = 467.0 if not multiagent else 920.0

    cfg = PPOConfig(n_envs=n_envs, n_steps=64, n_minibatches=8)
    if local:
        # linear LR decay over the full budget stabilizes the late phase
        cfg = PPOConfig(n_envs=n_envs, n_steps=64, n_minibatches=8,
                        total_updates=cfg.updates_for_iters(max_iters))
    if obs == "rgb":
        adapter = rgb_hover_adapter(cfg, rl_cfg, params, init_xyzs,
                                    init_rpys, width=IMG_W, height=IMG_H,
                                    device=device)
        network = CnnActorCritic(adapter.act_dim, img_h=IMG_H, img_w=IMG_W)
        init_fn, train_step, _ = make_ppo_core(cfg, adapter, device=device,
                                               network=network)
        # evaluation reads env 0 only: 16 envs render 16 frames a step
        eval_cfg = PPOConfig(n_envs=16, n_steps=cfg.n_steps)
        eval_adapter = rgb_hover_adapter(eval_cfg, rl_cfg, params, init_xyzs,
                                         init_rpys, width=IMG_W,
                                         height=IMG_H, device=device)
        _, _, eval_core = make_ppo_core(eval_cfg, eval_adapter,
                                        device=device, network=network)

        def eval_fn(net, n):
            return eval_core(net, n)[:1]
    else:
        init_fn, train_step, eval_fn = make_ppo(cfg, rl_cfg, params,
                                                init_xyzs, init_rpys,
                                                device=device)
    ts = init_fn(0)

    def evaluate(net):
        return float(eval_fn(net, 8 * 30 + 2)[0])

    budget_iters = max_iters if local else 2
    print(f"[INFO] training: {budget_iters} iterations x {cfg.batch_size} "
          f"steps")
    best_return = -np.inf
    best_net = copy.deepcopy(ts.params)
    t0 = time.time()
    for it in range(budget_iters):
        ts, metrics = train_step(ts)
        if it % 10 == 0 or it == budget_iters - 1:
            eval_ret = evaluate(ts.params)
            steps_done = (it + 1) * cfg.batch_size
            print(f"[{it:4d}] steps {steps_done:9d}  mean_ep_return "
                  f"{float(metrics['mean_episode_return']):8.2f}  "
                  f"eval_return {eval_ret:8.2f}  "
                  f"({steps_done / max(time.time() - t0, 1e-9):,.0f} "
                  f"steps/s)", flush=True)
            if eval_ret > best_return:
                best_return = eval_ret
                best_net = copy.deepcopy(ts.params)
                save_policy(os.path.join(filename, "best_model.msgpack"),
                            best_net)
            if eval_ret >= target_reward:
                print(f"[INFO] reward threshold {target_reward} reached; "
                      f"stopping")
                break

    save_policy(os.path.join(filename, "final_model.msgpack"), ts.params)
    print(filename)

    # deterministic evaluation (reference learn.py:142-146)
    rets = [evaluate(best_net) for _ in range(n_eval)]
    print(f"\n\n\nMean reward {np.mean(rets)} +- {np.std(rets)}\n\n")

    # replay with logging (reference learn.py:148-188)
    obs_type = ObservationType.RGB if obs == "rgb" else ObservationType.KIN
    if multiagent:
        test_env = MultiHoverAviary(num_drones=DEFAULT_AGENTS, act=act_type,
                                    obs=obs_type, gui=gui,
                                    record=record_video, device=device)
    else:
        test_env = HoverAviary(act=act_type, obs=obs_type, gui=gui,
                               record=record_video, device=device)
    logger = Logger(logging_freq_hz=int(test_env.CTRL_FREQ),
                    num_drones=num_drones, output_folder=output_folder,
                    colab=colab)
    if obs == "rgb":
        # the training camera's resolution; the gym env's frames are
        # uint8-valued where the adapter's are in [0, 1]
        test_env.IMG_RES = np.array([IMG_W, IMG_H])

        def to_net(o):
            return np.asarray(o[0], dtype=np.float32)[..., :3].reshape(
                1, -1) / 255.0
    else:
        def to_net(o):
            return np.asarray(o, dtype=np.float32).reshape(1, -1)
    obs_, info = test_env.reset(seed=42, options={})
    with torch.no_grad():
        for i in range((test_env.EPISODE_LEN_SEC + 2) * test_env.CTRL_FREQ):
            mean, _, _ = best_net(torch.from_numpy(to_net(obs_)).to(device))
            action = np.clip(mean.cpu().numpy(), -1, 1).reshape(
                num_drones, rl_cfg.act_size)
            obs_, reward, terminated, truncated, info = test_env.step(action)
            if obs == "kin":
                for d in range(num_drones):
                    logger.log(drone=d, timestamp=i / test_env.CTRL_FREQ,
                               state=np.hstack([obs_[d][0:3], np.zeros(4),
                                                obs_[d][3:12],
                                                np.resize(action[d], 4)]),
                               control=np.zeros(12))
            if terminated or truncated:
                obs_, info = test_env.reset(seed=42, options={})
    test_env.close()

    if plot and obs == "kin":
        logger.plot()
    return best_return


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="PPO hover training (batched envs)")
    parser.add_argument("--multiagent", default=DEFAULT_MA, type=str2bool)
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool)
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VIDEO,
                        type=str2bool)
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str)
    parser.add_argument("--colab", default=DEFAULT_COLAB, type=bool)
    parser.add_argument("--local", default=True, type=str2bool)
    parser.add_argument("--plot", default=True, type=str2bool)
    parser.add_argument("--act", default=DEFAULT_ACT, type=str)
    parser.add_argument("--obs", default=DEFAULT_OBS, type=str,
                        choices=["kin", "rgb"],
                        help="'rgb' trains pixels-to-actions: drone-POV "
                             "frames rendered on the device + a conv "
                             "actor-critic")
    parser.add_argument("--n_envs", default=512, type=int)
    parser.add_argument("--device", default="cuda")
    run(**vars(parser.parse_args()))

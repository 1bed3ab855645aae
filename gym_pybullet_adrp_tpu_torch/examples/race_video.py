"""Render a race episode to PNG frames (and an mp4) with the ray caster.

Counterpart of examples/race_video.py (``run`` :25): the scripted racers
(``hardcoded``) fly the getting_started track with 2 drones in
``MultiRaceAviary`` on ``device`` (the card unless the caller asks for the
CPU), and each control step a chase camera behind drone 0 is rendered by
ops/render.py and written as a PNG frame (the reference's video recording
in DIRECT mode, BaseAviary.py:296-321, without the GUI). The PNGs are
written without PIL (utils/rendering.png_bytes); the mp4 needs ffmpeg.

    python -m gym_pybullet_adrp_tpu_torch.examples.race_video \\
        --frames 60 --out results [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..envs.race import MultiRaceAviary
from ..ops.render import render, scene_from_race_state
from ..utils.rendering import VideoRecorder
from ..utils.utils import load_controller

# the chase camera's offset from drone 0 (m)
CHASE = (1.5, 1.5, 1.0)


def chase_frame(env, width, height):
    """The chase camera's frame of ``env``'s state: (rgba (H, W, 4) in
    [0, 255], depth, seg) on the env's device. The env's state carries a
    batch axis of one env: drone 0 is ``pos[0, 0]``."""
    st = env._state
    scene = scene_from_race_state(st.gates_actual[0], st.obstacles_actual[0],
                                  st.phys.pos[0])
    target = st.phys.pos[0, 0]
    eye = target + torch.tensor(CHASE, dtype=target.dtype,
                                device=target.device)
    return render(scene, eye, target, width=width, height=height)


def run(frames: int = 60, out: str = "results", width: int = 320,
        height: int = 240, device="cuda"):
    """Fly and record up to ``frames`` control steps; returns the
    ``VideoRecorder`` (its ``path`` holds frame_<n>.png)."""
    env = MultiRaceAviary("getting_started", num_drones=2, device=device)
    obs, info = env.reset()
    cls = load_controller("hardcoded")
    agents = []
    for d in range(2):
        i2 = dict(info, delay=d, device=str(env.device))
        agents.append(cls(d, obs[d], i2))

    rec = VideoRecorder(output_folder=out, fps=25)
    terminated = truncated = False
    step = 0
    while not (terminated or truncated) and step < frames:
        t = step / env.CTRL_FREQ
        actions = [a.predict(obs[i], ep_time=t) for i, a in enumerate(agents)]
        obs, _, terminated, truncated, _ = env.step(actions)
        rgba, _, _ = chase_frame(env, width, height)
        rec.add_frame(rgba.cpu().numpy().astype(np.uint8))
        step += 1

    mp4 = rec.to_mp4()
    print(f"frames: {rec.frame_num} -> {mp4 or rec.path}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="results")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return run(frames=a.frames, out=a.out, width=a.width, height=a.height,
               device=a.device)


if __name__ == "__main__":
    main()

"""Full-track learned racer: completes all 4 getting_started gates.

Round-2 artifact trained by scripts/train_race.py on the fused row kernel
(2.84 s/lap on the training platform vs 14.36 s for the scripted spline,
VALIDATION §4b). Same surface as the reference's
user_controller/RLController.py, whose shipped example policy handles the
first two gates only.

The port's copy of the repo's agents/rl_fulltrack.py, on the port's modules.
"""

from .rl_agent import REPO_AGENTS, RLController


class FullTrackController(RLController):
    def __init__(self, drone_id, initial_obs, initial_info,
                 buffer_size: int = 100, verbose: bool = False):
        super().__init__(
            drone_id, initial_obs, initial_info, buffer_size, verbose,
            model_path=str(REPO_AGENTS / "fulltrack_policy.msgpack"),
        )


Controller = FullTrackController

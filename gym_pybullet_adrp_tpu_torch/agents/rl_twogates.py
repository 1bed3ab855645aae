"""Learned twogates racer (reference user_controller/RLControllerTwoGates.py):
the RLController wired to the twogates policy artifact.

The port's copy of the repo's agents/rl_twogates.py, on the port's modules.
"""

from .rl_agent import REPO_AGENTS, RLController


class RLControllerTwoGates(RLController):
    """Loads the twogates-trained policy by default (reference :32)."""

    def __init__(self, drone_id, initial_obs, initial_info,
                 buffer_size: int = 100, verbose: bool = False,
                 model_path: str = None):
        super().__init__(
            drone_id, initial_obs, initial_info, buffer_size, verbose,
            model_path=model_path
            or str(REPO_AGENTS / "example_race_policy.msgpack"),
        )


Controller = RLControllerTwoGates

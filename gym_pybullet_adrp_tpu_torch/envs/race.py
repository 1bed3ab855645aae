"""Race scenario description: static spec, nominal track, model scalars.

Counterpart of gym_pybullet_adrp_tpu.envs.race (``RaceSpec`` :58,
``RaceTrack`` :165, ``track_from_config`` :177) and of
``envs/race_fast._model_scalars`` :159. The XLA ``race_step`` and the
gym-style ``MultiRaceAviary`` are not part of this package yet.
"""

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np

from ..models.drone import _REGISTRY
from ..utils.constants import CTRL_FREQ, DEG_TO_RAD, FIRMWARE_FREQ
from ..utils.enums import DroneModel, Physics, RaceMode


@dataclass(frozen=True)
class RaceSpec:
    """Static race configuration, built from a scenario config."""

    num_drones: int = 2
    num_gates: int = 4
    num_obstacles: int = 4
    racemode: RaceMode = RaceMode.COMPARE
    physics: Physics = Physics.PYB
    pyb_freq: int = 500
    ctrl_freq: int = 25
    episode_len_sec: float = 33.0
    drone_model: DroneModel = DroneModel.CF2X
    done_on_completion: bool = True
    done_on_collision: bool = True

    random_drone_state: bool = False
    rs_pos: Tuple[Tuple[float, float], ...] = (
        (-0.1, 0.1), (-0.1, 0.1), (0.0, 0.02),
    )
    rs_rot: Tuple[Tuple[float, float], ...] = (
        (-0.1, 0.1), (-0.1, 0.1), (-0.1, 0.1),
    )
    random_drone_inertia: bool = False
    ri_mass: Tuple[float, float] = (-0.01, 0.01)
    ri_ixx: Tuple[float, float] = (-1e-6, 1e-6)
    ri_iyy: Tuple[float, float] = (-1e-6, 1e-6)
    ri_izz: Tuple[float, float] = (-1e-6, 1e-6)
    random_gates_obstacles: bool = False
    rg_gates: Tuple[float, float] = (-0.15, 0.15)
    rg_obstacles: Tuple[float, float] = (-0.15, 0.15)
    disturbances: bool = False
    action_noise_std: float = 0.001
    dyn_dist_low: Tuple[float, float, float] = (-0.1, -0.1, -0.1)
    dyn_dist_high: Tuple[float, float, float] = (0.1, 0.1, 0.1)

    @property
    def steps_per_ctrl(self) -> int:
        return self.pyb_freq // self.ctrl_freq

    @property
    def obs_size(self) -> int:
        # 12 kin + 4 per gate + gate flags + 3 per obstacle + obstacle
        # flags + current gate id (+ opponents' pose under COMPETE)
        base = 12 + 5 * self.num_gates + 4 * self.num_obstacles + 1
        if self.racemode == RaceMode.COMPETE:
            base += 6 * (self.num_drones - 1)
        return base

    @classmethod
    def from_config(cls, config, num_drones: int, racemode: RaceMode,
                    physics: Physics = Physics.PYB):
        """Build from a loaded scenario config (utils/config.py).

        As in the reference, the config's ctrl_freq/pyb_freq are not read:
        the race always runs at FIRMWARE_FREQ=500 / CTRL_FREQ=25.
        """
        kw = dict(
            num_drones=num_drones,
            num_gates=len(config.gates),
            num_obstacles=len(config.obstacles),
            racemode=racemode,
            physics=physics,
            pyb_freq=FIRMWARE_FREQ,
            ctrl_freq=CTRL_FREQ,
            episode_len_sec=float(config.episode_len_sec),
            done_on_completion=bool(config.get("done_on_completion", True)),
            done_on_collision=bool(config.get("done_on_collision", True)),
            random_drone_state=bool(config.get("random_drone_state", False)),
            random_drone_inertia=bool(
                config.get("random_drone_inertia", False)
            ),
            random_gates_obstacles=bool(
                config.get("random_gates_obstacles", False)
            ),
            disturbances=bool(config.get("disturbances", False)),
        )
        if kw["random_drone_state"]:
            info = config.random_drone_state_info
            kw["rs_pos"] = (
                tuple(info.pos.x), tuple(info.pos.y), tuple(info.pos.z),
            )
            kw["rs_rot"] = (
                tuple(info.rot.r), tuple(info.rot.p), tuple(info.rot.y),
            )
        if kw["random_drone_inertia"]:
            info = config.random_drone_inertia_info
            kw["ri_mass"] = tuple(info.M.range)
            kw["ri_ixx"] = tuple(info.Ixx.range)
            kw["ri_iyy"] = tuple(info.Iyy.range)
            kw["ri_izz"] = tuple(info.Izz.range)
        if kw["random_gates_obstacles"]:
            info = config.random_gates_obstacles_info
            kw["rg_gates"] = tuple(info.gates.range)
            kw["rg_obstacles"] = tuple(info.obstacles.range)
        if kw["disturbances"]:
            info = config.disturbances_info
            kw["action_noise_std"] = float(info.action.std)
            kw["dyn_dist_low"] = tuple(info.dynamics.low)
            kw["dyn_dist_high"] = tuple(info.dynamics.high)
        return cls(**kw)


class RaceTrack(NamedTuple):
    """Nominal track + initial drone states, float32 numpy arrays."""

    gates_nominal: np.ndarray      # (G, 7) [x,y,z,r,p,yaw,type]
    obstacles_nominal: np.ndarray  # (O, 6)
    bounds: np.ndarray             # (2, 3) [lo, hi]
    init_pos: np.ndarray           # (N, 3)
    init_rpy: np.ndarray           # (N, 3) radians
    init_vel: np.ndarray           # (N, 3)
    init_pqr: np.ndarray           # (N, 3)


def track_from_config(config, num_drones: int) -> RaceTrack:
    """Track and start states from a scenario config (rpy given in
    degrees). Drones beyond the config's entries spawn in a grid offset
    from the last entry."""
    drones = list(config.init_states)

    def rows(field, scale=1.0):
        vals = [
            np.asarray(config.init_states[d][field], dtype=float)
            for d in drones
        ]
        while len(vals) < num_drones:
            k = len(vals) - len(drones) + 1
            extra = vals[len(drones) - 1].copy()
            if field == "pos":
                extra = extra + np.array([0.2 * k, -0.2 * k, 0.0])
            vals.append(extra)
        return np.array(vals[:num_drones], dtype=float) * scale

    f32 = np.float32
    return RaceTrack(
        gates_nominal=np.array(config.gates, dtype=float).astype(f32),
        obstacles_nominal=np.array(config.obstacles, dtype=float).astype(f32),
        bounds=np.array(config.bounds, dtype=float).astype(f32),
        init_pos=rows("pos").astype(f32),
        init_rpy=rows("rpy", DEG_TO_RAD).astype(f32),
        init_vel=rows("vel").astype(f32),
        init_pqr=rows("pqr").astype(f32),
    )


def model_scalars(spec: RaceSpec):
    """(kf, km, arm, ground_z) of the spec's drone model: the constants
    the race env never randomizes."""
    raw = _REGISTRY[spec.drone_model]
    ground_z = raw["collision_h"] / 2.0 - raw["collision_z_offset"]
    return raw["kf"], raw["km"], raw["arm"], ground_z

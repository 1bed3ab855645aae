"""The general race env: spec, track, reset, the 20-tick step, obs.

Counterpart of gym_pybullet_adrp_tpu.envs.race (``RaceSpec`` :58,
``RaceTrack`` :165, ``track_from_config`` :177, ``RaceState`` :216,
``_randomized_drone_params`` :234, ``race_reset`` :267, ``_collisions``
:335, ``_gate_progress`` :364, ``race_step`` :386, ``process_commands``
:458, ``finish_ctrl_step`` :475, ``compute_obs`` :518,
``actions_to_commands`` :571) and of ``envs/race_fast._model_scalars``
:159. N drones race through gates, each with its commander and Mellinger
firmware (control/), the physics of ops/dynamics.py and the collision
tests of ops/collision.py; the step runs its 20 firmware ticks as eager
tensor ops (envs/race_fast.py runs them in the window kernel). The gym
class ``MultiRaceAviary`` (:590 there) is one env of this step.

Batched: where the JAX package writes one env and vmaps it, every state
tensor here carries the env batch B first, ``(B, N, ...)`` per drone,
``(B, G, 7)`` for the gates, ``(B,)`` for the step counter; each env
gets what the JAX function gives it. Random numbers come from a
``torch.Generator`` (reset offsets, ``ResetDraws``; per-tick wind and
motor noise, ``TickNoise``) or are injected, so a test hands both
packages the same draws.
"""

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..control import commander as cmdr_mod
from ..control import mellinger as mel
from ..models.drone import CF2X_LEGACY, DroneParams, _REGISTRY
from ..ops import collision as col
from ..ops import dynamics, quat as quat_ops
from ..utils.constants import (
    CTRL_FREQ, DEG_TO_RAD, FIRMWARE_FREQ, VISIBILITY_RANGE,
)
from ..utils.device_consts import const
from ..ops import render
from ..utils.enums import (
    Command, DroneModel, ObservationType, Physics, RaceMode,
)
from .aviary import LazySpaces, box


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


# ---------------------------------------------------------------------------
# the general env's state, draws and reset


class RaceState(NamedTuple):
    """Race state of B envs. The JAX package's PRNG key has no
    counterpart: draws come from the caller."""

    phys: dynamics.PhysState       # (B, N, ...)
    rpms: torch.Tensor             # (B, N, 4) applied next substep
    prev_rpms: torch.Tensor        # (B, N, 4) for drag
    mell: mel.MellingerState       # (B, N, ...)
    cmdr: cmdr_mod.CommanderState  # (B, N, ...)
    current_gate: torch.Tensor     # (B, N) int32
    eliminated: torch.Tensor       # (B, N) bool
    finished: torch.Tensor         # (B, N) bool
    gates_actual: torch.Tensor     # (B, G, 7)
    obstacles_actual: torch.Tensor  # (B, O, 6)
    drone: DroneParams             # (B, N); J, drag_coeff (B, N, 3)
    step_counter: torch.Tensor     # (B,) int32, pyb substeps


class ResetDraws(NamedTuple):
    """The random numbers of B resets, as ``race_reset`` consumes them
    (None where the spec does not randomize). ``gate_off``/``obst_off``/
    ``mass_off`` are offsets in their ranges; ``pos_u``/``rot_u``/``j_u``
    are uniforms in [0, 1) that the reset scales."""

    gate_off: Optional[torch.Tensor]  # (B, G, 3) x, y, yaw
    obst_off: Optional[torch.Tensor]  # (B, O, 2) x, y
    mass_off: Optional[torch.Tensor]  # (B, N)
    j_u: Optional[torch.Tensor]       # (B, N, 3)
    pos_u: Optional[torch.Tensor]     # (B, N, 3)
    rot_u: Optional[torch.Tensor]     # (B, N, 3)


class TickNoise(NamedTuple):
    """Per-tick disturbances of one control step."""

    wind: torch.Tensor       # (n_ticks, B, N, 3) world force, N
    act: torch.Tensor        # (n_ticks, B, N, 4) thrust-space motor noise


def _t(x, like):
    """``x`` (numpy or tensor) as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def track_tensors(track: RaceTrack, device, dtype=torch.float32):
    """The track's arrays as tensors on ``device``: convert once, so that
    the step functions copy nothing to the card."""
    return RaceTrack(*(torch.as_tensor(np.asarray(x), dtype=dtype,
                                       device=device) for x in track))


def sample_reset_draws(spec: RaceSpec, B: int, generator, device):
    """B resets' draws from ``generator`` (uniform, as the JAX package
    draws them)."""
    dev = torch.device(device)

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def rng(lo, hi, *shape):
        return torch.clamp_min(u(*shape) * (hi - lo) + lo, lo)

    N, G, O = spec.num_drones, spec.num_gates, spec.num_obstacles
    gates = obst = mass = j = pos = rot = None
    if spec.random_gates_obstacles:
        gates = rng(spec.rg_gates[0], spec.rg_gates[1], B, G, 3)
        obst = rng(spec.rg_obstacles[0], spec.rg_obstacles[1], B, O, 2)
    if spec.random_drone_inertia:
        mass = rng(spec.ri_mass[0], spec.ri_mass[1], B, N)
        j = u(B, N, 3)
    if spec.random_drone_state:
        pos, rot = u(B, N, 3), u(B, N, 3)
    return ResetDraws(gates, obst, mass, j, pos, rot)


def sample_tick_noise(spec: RaceSpec, B: int, generator, device):
    """One control step's wind and motor noise from ``generator``, or
    None without disturbances."""
    if not spec.disturbances:
        return None
    dev = torch.device(device)
    shape = (spec.steps_per_ctrl, B, spec.num_drones)
    lo = const(tuple(spec.dyn_dist_low), torch.float32, dev)
    hi = const(tuple(spec.dyn_dist_high), torch.float32, dev)
    wind = torch.rand(shape + (3,), generator=generator,
                      device=dev) * (hi - lo) + lo
    act = torch.randn(shape + (4,), generator=generator,
                      device=dev) * spec.action_noise_std
    return TickNoise(wind, act)


def _randomized_drone_params(spec: RaceSpec, B: int, draws: ResetDraws,
                             device, dtype=torch.float32) -> DroneParams:
    """Per-drone mass and inertia; the bases come from the legacy cf2x
    urdf, not the IROS one (reference _drone_init:407-432)."""
    base = DroneParams(**{k: const(v, dtype, device) for k, v in
                          _REGISTRY[spec.drone_model].items()})
    n = spec.num_drones
    mass0 = torch.full((B, n), CF2X_LEGACY["mass"], dtype=dtype,
                       device=device)
    J0 = const(CF2X_LEGACY["J"], dtype, device).expand(B, n, 3)
    if spec.random_drone_inertia:
        lo = const((spec.ri_ixx[0], spec.ri_iyy[0], spec.ri_izz[0]), dtype,
                   device)
        hi = const((spec.ri_ixx[1], spec.ri_iyy[1], spec.ri_izz[1]), dtype,
                   device)
        mass0 = torch.clamp(mass0 + draws.mass_off, 0.0, 100.0)
        J0 = torch.clamp(J0 + (draws.j_u * (hi - lo) + lo), 0.0, 100.0)
    # every leaf per drone: (B, N), or (B, N, 3) for J and drag_coeff
    per_drone = {k: v.expand((B, n) + v.shape)
                 for k, v in base._asdict().items()}
    return DroneParams(**dict(per_drone, mass=mass0, J=J0.contiguous()))


def race_reset(spec: RaceSpec, track: RaceTrack, B: int,
               draws: Optional[ResetDraws] = None, generator=None,
               device="cuda", dtype=torch.float32) -> RaceState:
    """B fresh episodes (reference reset:127-167 + _addObstacles +
    _drone_init), from ``draws`` or, when None, from ``generator``."""
    dev = torch.device(device)
    if draws is None:
        draws = sample_reset_draws(spec, B, generator, dev)
    n = spec.num_drones
    ref = torch.zeros((), dtype=dtype, device=dev)
    gates = _t(track.gates_nominal, ref).expand(B, -1, -1).clone()
    obstacles = _t(track.obstacles_nominal, ref).expand(B, -1, -1).clone()
    if spec.random_gates_obstacles:
        # offsets apply to x, y, yaw (reference :366-369)
        for ch, k in ((0, 0), (1, 1), (5, 2)):
            gates[..., ch] = gates[..., ch] + draws.gate_off[..., k]
        for k in range(2):
            obstacles[..., k] = obstacles[..., k] + draws.obst_off[..., k]

    pos = _t(track.init_pos, ref)[:n].expand(B, n, 3)
    rpy = _t(track.init_rpy, ref)[:n].expand(B, n, 3)
    if spec.random_drone_state:
        lo_p, hi_p, lo_r, hi_r = (
            const(tuple(r[k] for r in rs), dtype, dev)
            for rs, k in ((spec.rs_pos, 0), (spec.rs_pos, 1),
                          (spec.rs_rot, 0), (spec.rs_rot, 1)))
        pos = pos + draws.pos_u * (hi_p - lo_p) + lo_p
        rpy = rpy + draws.rot_u * (hi_r - lo_r) + lo_r
    init_vel = _t(track.init_vel, ref)[:n].expand(B, n, 3)
    quat = quat_ops.from_euler_xyz(rpy)
    phys = dynamics.PhysState(
        pos=pos.contiguous(), quat=quat, vel=init_vel.contiguous(),
        # omega is body-frame: the init pqr (world) mapped through R^T
        omega=quat_ops.rotate_inv(quat, _t(track.init_pqr, ref)[:n]))
    # the controller starts from the initial kinematics (reference
    # MellingerControl.reset:143-150)
    mstate = mel.init_state((B, n), dtype, dev)._replace(
        prev_rpy=rpy.contiguous(), prev_vel=init_vel.contiguous())
    zeros4 = torch.zeros((B, n, 4), dtype=dtype, device=dev)
    return RaceState(
        phys=phys, rpms=zeros4, prev_rpms=zeros4.clone(), mell=mstate,
        cmdr=cmdr_mod.init_state((B, n), dtype, dev),
        current_gate=torch.zeros((B, n), dtype=torch.int32, device=dev),
        eliminated=torch.zeros((B, n), dtype=torch.bool, device=dev),
        finished=torch.zeros((B, n), dtype=torch.bool, device=dev),
        gates_actual=gates, obstacles_actual=obstacles,
        drone=_randomized_drone_params(spec, B, draws, dev, dtype),
        step_counter=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def tree_where(cond, new, old):
    """``new`` where ``cond`` (B,) else ``old``, leaf by leaf over nested
    NamedTuples whose leaves carry the batch axis first."""
    if isinstance(new, tuple):
        return type(new)(*(tree_where(cond, a, b) for a, b in zip(new, old)))
    return torch.where(cond.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


# ---------------------------------------------------------------------------
# collision / progress helpers


def _radius(state: RaceState):
    return torch.broadcast_to(state.drone.collision_r,
                              state.phys.pos.shape[:-1])


def _collisions(spec: RaceSpec, state: RaceState):
    """(B, N) bool: drone in contact with a gate, obstacle, the plane or
    (COMPETE) another drone (reference _collision:552-562)."""
    pos = state.phys.pos
    # per drone, against each gate, obstacle or other drone on the last axis
    radius = _radius(state)[..., None]
    half_h = (state.drone.collision_h / 2.0)[..., None]
    p = pos[..., :, None, :]
    gate_hit = col.drone_gate_collision(
        p, state.gates_actual[:, None, :, :6], radius, half_h)
    obst_hit = col.drone_obstacle_collision(
        p, state.obstacles_actual[:, None], radius, half_h)
    hit = (torch.any(gate_hit, dim=-1) | torch.any(obst_hit, dim=-1)
           | col.ground_collision(pos, state.drone.collision_h,
                                  state.drone.collision_z_offset))
    if spec.racemode == RaceMode.COMPETE:
        dd = col.drone_drone_collision(pos, radius, half_h)
        hit = hit | torch.any(dd, dim=-1)
    return hit


def _gate_progress(spec: RaceSpec, state: RaceState) -> RaceState:
    """Advance current_gate / finished, with the reference's one-step-late
    ``finished`` latch (reference _gate_progress:471-506)."""
    B, n = state.current_gate.shape
    idx = torch.clamp(state.current_gate, 0, spec.num_gates - 1).long()
    gate = torch.gather(state.gates_actual, 1,
                        idx[..., None].expand(B, n, 7))      # (B, N, 7)
    passed = col.gate_pass_rays(state.phys.pos, gate[..., :6],
                                gate[..., 6].to(torch.int32), _radius(state))
    cur = state.current_gate
    in_progress = cur < spec.num_gates
    finished = state.finished | (cur >= spec.num_gates)
    current = torch.where(in_progress & passed, cur + 1, cur)
    return state._replace(current_gate=current, finished=finished)


# ---------------------------------------------------------------------------
# step


def process_commands(spec: RaceSpec, state: RaceState, cmd_ids, cmd_args):
    """Per-control-step command fan-out (reference step:189-207):
    eliminated drones are forced to STOP, then the commands execute."""
    cmd_ids = torch.where(state.eliminated, int(Command.STOP), cmd_ids)
    sim_time = (state.step_counter.to(state.phys.pos.dtype)
                * mel.recip32(spec.pyb_freq))
    cmdr = cmdr_mod.process_command(
        state.cmdr, cmd_ids, cmd_args, sim_time[:, None], state.phys.pos,
        state.phys.vel, state.phys.rpy[..., 2])
    return state._replace(cmdr=cmdr)


def race_tick(spec: RaceSpec, st: RaceState, wind=None, act_noise=None):
    """One 500 Hz tick: physics with the rpms of the previous tick, then
    the commander's setpoint and the firmware on the fresh kinematics
    (reference step:215-254). ``wind`` (B, N, 3) and ``act_noise`` (B,
    N, 4) are this tick's disturbances, or None."""
    dt = 1.0 / spec.pyb_freq
    if spec.physics == Physics.DYN:
        phys = dynamics.dyn_substep(st.drone, st.phys, st.rpms, dt,
                                    spec.drone_model)
    else:
        phys = dynamics.pyb_substep(st.drone, st.phys, st.rpms,
                                    st.prev_rpms, dt, spec.drone_model,
                                    spec.physics, ext_force_world=wind)
    if act_noise is None:
        act_noise = torch.zeros_like(st.rpms)
    tick_time = st.mell.tick.to(phys.pos.dtype) * mel.recip32(FIRMWARE_FREQ)
    cmdr = cmdr_mod.update_setpoint(st.cmdr, tick_time)
    mell, rpm = mel.compute_control(st.mell, cmdr.setpoint, phys.pos,
                                    phys.rpy, phys.vel, act_noise,
                                    kf=st.drone.kf[..., None])
    # eliminated drones: motors off (reference :233-234)
    elim = st.eliminated[..., None]
    return st._replace(
        phys=phys, prev_rpms=torch.where(elim, 0.0, st.rpms),
        rpms=torch.where(elim, 0.0, rpm), mell=mell, cmdr=cmdr,
        step_counter=st.step_counter + 1)


def race_step(spec: RaceSpec, track: RaceTrack, state: RaceState, cmd_ids,
              cmd_args, noise: Optional[TickNoise] = None, generator=None):
    """One control step of B envs (reference step:171-270). cmd_ids (B, N)
    int Command ids, cmd_args (B, N, ARGS_DIM); ``noise``: the step's
    disturbances, drawn from ``generator`` when the spec has them and
    none are given. Returns (state, obs, reward, terminated, truncated,
    info) as ``finish_ctrl_step``."""
    state = process_commands(spec, state, cmd_ids, cmd_args)
    if noise is None:
        noise = sample_tick_noise(spec, state.step_counter.shape[0],
                                  generator, state.phys.pos.device)
    for i in range(spec.steps_per_ctrl):
        state = race_tick(spec, state,
                          None if noise is None else noise.wind[i],
                          None if noise is None else noise.act[i])
    return finish_ctrl_step(spec, track, state)


def finish_ctrl_step(spec: RaceSpec, track: RaceTrack, state: RaceState):
    """Control-rate tail: gate progress, obs, elimination and termination
    (reference step:257-270, _computeTerminated/_computeTruncated).
    Returns (state, obs (B, N, C), reward (B,), terminated (B,),
    truncated (B,), info)."""
    dtype = state.phys.pos.dtype
    state = _gate_progress(spec, state)
    obs = compute_obs(spec, track, state)
    pos = state.phys.pos
    out_of_bounds = torch.any(torch.abs(pos) > _t(track.bounds, pos)[1],
                              dim=-1)
    unstable = torch.any(torch.abs(state.phys.ang_vel_world) > 20.0, dim=-1)
    # done_on_collision False: contact does not eliminate
    eliminated = state.eliminated | out_of_bounds | unstable
    if spec.done_on_collision:
        eliminated = eliminated | _collisions(spec, state)
    state = state._replace(eliminated=eliminated)
    # done_on_completion False: a finished drone does not end the episode
    done_mask = (eliminated | state.finished if spec.done_on_completion
                 else eliminated)
    terminated = torch.all(done_mask, dim=-1)
    truncated = (state.step_counter.to(dtype) * mel.recip32(spec.pyb_freq)
                 > spec.episode_len_sec)
    info = {
        "task_completed": torch.all(state.finished, dim=-1),
        "current_gate": state.current_gate,
        "eliminated": eliminated,
        "finished": state.finished,
    }
    reward = torch.zeros(terminated.shape, dtype=dtype, device=pos.device)
    return state, obs, reward, terminated, truncated, info


def compute_obs(spec: RaceSpec, track: RaceTrack, state: RaceState):
    """(B, N, obs_size) observation (reference _computeObs:566-661)."""
    pos = state.phys.pos
    B, n = pos.shape[:2]
    kin = torch.cat([pos, state.phys.rpy, state.phys.vel,
                     state.phys.ang_vel_world], dim=-1)        # (B, N, 12)
    gates = state.gates_actual
    gate_in_range = col.drone_gate_distance(
        pos[..., None, :], gates[:, None, :, :6]) < VISIBILITY_RANGE
    xyzyaw = const((0, 1, 2, 5), torch.long, pos.device)
    gate_poses = torch.where(
        gate_in_range[..., None], gates[:, None].index_select(-1, xyzyaw),
        _t(track.gates_nominal, pos).index_select(-1, xyzyaw))
    obst = state.obstacles_actual
    obst_in_range = col.drone_obstacle_distance(
        pos[..., None, :], obst[:, None]) < VISIBILITY_RANGE
    obst_poses = torch.where(obst_in_range[..., None],
                             obst[:, None][..., :3],
                             _t(track.obstacles_nominal, pos)[:, :3])
    parts = [kin, gate_poses.reshape(B, n, -1), gate_in_range.to(kin.dtype),
             obst_poses.reshape(B, n, -1), obst_in_range.to(kin.dtype),
             state.current_gate.to(kin.dtype)[..., None]]
    if spec.racemode == RaceMode.COMPETE:
        # poses of the other drones, ascending, skipping self
        pose6 = torch.cat([pos, state.phys.rpy], dim=-1)
        others = const(tuple(j for i in range(n) for j in range(n)
                             if j != i), torch.long, pos.device)
        parts.append(pose6.index_select(1, others).reshape(B, n, -1))
    return torch.cat(parts, dim=-1)


def actions_to_commands(spec: RaceSpec, actions, step_counter):
    """(B, N, 4) [x, y, z, yaw] -> FULLSTATE commands (reference
    step:190-194); ``step_counter`` (B,) is each env's timestep arg."""
    B, n = actions.shape[:2]
    cmd_ids = torch.full((B, n), int(Command.FULLSTATE), dtype=torch.int32,
                         device=actions.device)
    args = torch.zeros((B, n, cmdr_mod.ARGS_DIM), dtype=actions.dtype,
                       device=actions.device)
    args[..., 0:3] = actions[..., 0:3]
    args[..., 9] = actions[..., 3]
    args[..., 13] = step_counter[:, None]
    return cmd_ids, args


# ---------------------------------------------------------------------------
# the gymnasium class


class MultiRaceAviary(LazySpaces):
    """Gymnasium-API shell over the race env (reference
    envs/MultiRaceAviary.py; the JAX package's class :590-835): one env
    of ``race_step`` on ``device`` (the card unless the caller asks for
    the CPU), its commands packed on the host and uploaded once a step,
    its obs, reward and flags downloaded as one tensor. Resets and
    disturbances draw from a ``torch.Generator`` seeded from
    ``reset(seed)`` or the config's ``seed`` (counting up per reset where
    ``reseed_on_reset`` is False), as the JAX class keys ``jax.random``.

    Like envs/aviary.py's classes it imports gymnasium only when its
    spaces are read. With ``obs=ObservationType.RGB`` it observes every
    drone's POV frame of the race scene (JAX :809-832), rendered in one
    call on the env's device."""

    metadata = {"render_modes": []}

    def __init__(self, race_config, drone_model: DroneModel = DroneModel.CF2X,
                 num_drones: int = 2, physics: Physics = Physics.PYB,
                 pyb_freq: int = None, ctrl_freq: int = None,
                 gui: bool = False, record: bool = False,
                 racemode: RaceMode = RaceMode.COMPARE, obs=None, act=None,
                 dtype=torch.float32, device="cuda"):
        if isinstance(race_config, str):
            from ..utils.config import load_config

            race_config = load_config(race_config)
        self.config = race_config
        self.observation_type = obs or ObservationType.KIN
        self.IMG_RES = np.array([64, 48])
        spec = RaceSpec.from_config(race_config, num_drones, racemode,
                                    physics)
        if pyb_freq or ctrl_freq:
            spec = dataclasses.replace(spec, pyb_freq=pyb_freq or
                                       spec.pyb_freq,
                                       ctrl_freq=ctrl_freq or spec.ctrl_freq)
        self.spec_ = spec
        self.dtype = dtype
        self.device = torch.device(device)
        self.track = track_from_config(race_config, num_drones)
        self._track = track_tensors(self.track, self.device, dtype)
        self.NUM_DRONES = num_drones
        self.CTRL_FREQ = spec.ctrl_freq
        self.PYB_FREQ = spec.pyb_freq
        self.PYB_STEPS_PER_CTRL = spec.steps_per_ctrl
        self.CTRL_TIMESTEP = 1.0 / self.CTRL_FREQ
        self.racemode = racemode
        self.num_gates = spec.num_gates
        self.EPISODE_LEN_SEC = spec.episode_len_sec
        self._seed_counter = int(race_config.get("seed", 1337))
        self._reseed = bool(race_config.get("reseed_on_reset", True))
        self._gen = torch.Generator(device=self.device)
        self._state: Optional[RaceState] = None
        self.step_counter = 0

    # -- spaces (reference :284-343) ----------------------------------------
    def _actionSpace(self):
        lim = np.ones((self.NUM_DRONES, 4))
        return box(-lim, lim, dtype=float)

    def _observationSpace(self):
        if self.observation_type == ObservationType.RGB:
            # reference _observationSpace:300-304 (latent RGB branch)
            return box(0, 255, np.uint8,
                       (self.NUM_DRONES, int(self.IMG_RES[1]),
                        int(self.IMG_RES[0]), 4))
        G, O = self.spec_.num_gates, self.spec_.num_obstacles
        lo = np.concatenate([
            [-5] * 3, [-np.pi] * 3, [-10] * 3, [-10] * 3,
            [-5, -5, -5, -np.pi] * G, [-1] * G, [-5] * 3 * O, [-1] * O,
            [-1]])
        hi = np.concatenate([
            [5] * 3, [np.pi] * 3, [10] * 3, [10] * 3,
            [5, 5, 5, np.pi] * G, [1] * G, [5] * 3 * O, [1] * O, [G]])
        if self.racemode == RaceMode.COMPETE:
            others = self.NUM_DRONES - 1
            lo = np.concatenate([lo, ([-5] * 3 + [-np.pi] * 3) * others])
            hi = np.concatenate([hi, ([5] * 3 + [np.pi] * 3) * others])
        return box(np.tile(lo, (self.NUM_DRONES, 1)),
                   np.tile(hi, (self.NUM_DRONES, 1)), dtype=np.float64)

    # -- API ----------------------------------------------------------------
    @property
    def current_gate(self):
        return self._state.current_gate[0].cpu().numpy()

    @property
    def drones_eliminated(self):
        return self._state.eliminated[0].cpu().numpy()

    @property
    def drones_finished(self):
        return self._state.finished[0].cpu().numpy()

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is None:
            if not self._reseed:
                # reseed_on_reset False: episode-varying randomness (level3)
                self._seed_counter += 1
            seed = self._seed_counter
        self._gen.manual_seed(int(seed))
        self._state = race_reset(self.spec_, self._track, 1,
                                 generator=self._gen, device=self.device,
                                 dtype=self.dtype)
        self.step_counter = 0
        if self._rgb:
            return self._rgbObs(), {"answer": 42}
        obs = compute_obs(self.spec_, self._track, self._state)[0]
        return obs.cpu().numpy().astype(np.float64), {"answer": 42}

    @property
    def _rgb(self):
        return self.observation_type == ObservationType.RGB

    def _rgbObs(self):
        """(N, H, W, 4) float32 frames in [0, 255], drone i's from its own
        camera (reference _computeObs RGB branch, :574-588; the JAX
        package's :809-832), every drone's sphere in the scene."""
        from ..ops import render

        st = self._state
        scene = render.scene_from_race_state(
            st.gates_actual[0], st.obstacles_actual[0], st.phys.pos[0])
        eye, target = render.drone_camera(st.phys.pos[0], st.phys.quat[0],
                                          st.drone.arm[0])
        rgba, _, _ = render.render(scene, eye, target,
                                   width=int(self.IMG_RES[0]),
                                   height=int(self.IMG_RES[1]))
        return rgba.cpu().numpy().astype(np.float32)

    def _commands(self, action):
        """(cmd ids (N,), args (N, ARGS_DIM)) on the host: FULLSTATE
        targets from an ndarray (N, 4) [x, y, z, yaw], or each drone's
        ``(Command, args)`` tuple (reference step:189-207)."""
        n = self.NUM_DRONES
        args = np.zeros((n, cmdr_mod.ARGS_DIM), np.float32)
        if isinstance(action, (list, tuple)):
            ids = np.zeros((n,), np.int32)
            for i, (cmd, a) in enumerate(action):
                ids[i], args[i] = cmdr_mod.pack_command(cmd, a)
        else:
            action = np.asarray(action, dtype=np.float32).reshape(n, 4)
            ids = np.full((n,), int(Command.FULLSTATE), np.int32)
            args[:, 0:3] = action[:, 0:3]
            args[:, 9] = action[:, 3]
            args[:, 13] = self.step_counter
        return ids, args

    def step(self, action):
        """``action``: ndarray (N, 4) or a list of (Command, args) per
        drone. Returns (obs (N, C) float64, reward, terminated, truncated,
        info)."""
        ids, args = self._commands(action)
        up = torch.from_numpy(np.concatenate(
            [ids[:, None].astype(np.float32), args], axis=1)).to(self.device)
        state, obs, reward, term, trunc, info = race_step(
            self.spec_, self._track, self._state,
            up[None, :, 0].to(torch.int32), up[None, :, 1:].to(self.dtype),
            generator=self._gen)
        self._state = state
        # the device counter advances PYB_STEPS_PER_CTRL a step
        self.step_counter += self.PYB_STEPS_PER_CTRL
        dt = obs.dtype
        packed = torch.cat([obs[0].reshape(-1), reward.to(dt), term.to(dt),
                            trunc.to(dt), info["task_completed"].to(dt)])
        packed = packed.cpu().numpy().astype(np.float64)
        tail = packed[-4:]
        obs_out = (self._rgbObs() if self._rgb
                   else packed[:-4].reshape(self.NUM_DRONES, -1))
        return (obs_out, float(tail[0]),
                bool(tail[1] > 0.5), bool(tail[2] > 0.5),
                {"answer": 42, "task_completed": bool(tail[3] > 0.5)})

    def render(self, mode: str = "human", close: bool = False):
        return None

    def close(self):
        pass

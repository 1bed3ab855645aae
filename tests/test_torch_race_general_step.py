"""Port: the general race env's step against the JAX package, on CPU.

``race_step`` is compared tick by tick from shared states: the JAX
package flies B envs through a TAKEOFF (the planner), hovering and
FULLSTATE targets, and at every tick both packages take one tick
(``race.race_tick``; JAX: its ``race_step`` substep body, jitted) from
the same JAX state, with no disturbances and with injected wind and
motor noise (``pyb_substep(ext_force_world=)``,
``compute_control(act_noise)``). A closed-loop comparison would measure
the firmware's D-term, which multiplies ulp differences ~500x a tick.
Tolerances as tests/test_torch_race_general.py, on envs whose gating is
rounding-independent (``mell_stable``); the planner's setpoint at rtol
1e-5 of its terms' magnitudes.

``finish_ctrl_step`` (gate progress, collisions, elimination,
termination, obs) runs on states placed around the gates, obstacles and
bounds, COMPETE with two drones: obs at ``check_blocks``' tolerances
(positions and velocities atol 1e-5, angles and world rates 1e-3, track
channels and flags equal, opponent channels 1e-3), the discrete outputs
equal. ``process_commands`` and ``actions_to_commands`` are compared too.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.control import commander as jcmd
from gym_pybullet_adrp_tpu.control import mellinger as jmel
from gym_pybullet_adrp_tpu.envs import race as jrace
from gym_pybullet_adrp_tpu.ops import dynamics as jdyn
from gym_pybullet_adrp_tpu.utils.constants import FIRMWARE_FREQ
from gym_pybullet_adrp_tpu.utils.enums import Command as JCommand
from gym_pybullet_adrp_tpu_torch.envs import race as prace

from _torch_port import (
    ATOL, CTL_ATOL, GYRO_ATOL, RTOL, assert_race_obs,
    assert_setpoint as _assert_setpoint, assert_trees, mell_stable,
    race_specs, tensor, to_port,
)

F32 = np.float32
T = tensor
TICK_ATOL = {"control_rpyt": CTL_ATOL, "gyro_lpf.d1": GYRO_ATOL}


def jax_tick(spec, st, wind, act):
    """One tick of the JAX package's race_step (its scan body, envs/
    race.py:402-447) with the given disturbances."""
    dt = jnp.asarray(1.0 / spec.pyb_freq, dtype=jnp.float32)
    phys = jdyn.pyb_substep(st.drone, st.phys, st.rpms, st.prev_rpms, dt,
                            spec.drone_model, spec.physics,
                            ext_force_world=wind)
    tick_time = st.mell.tick.astype(jnp.float32) / FIRMWARE_FREQ
    cmdr = jcmd.update_setpoint(st.cmdr, tick_time)
    mell, rpm = jmel.compute_control(st.mell, cmdr.setpoint, phys.pos,
                                     phys.rpy, phys.vel, act,
                                     kf=st.drone.kf[..., None])
    elim = st.eliminated[..., None]
    return st._replace(phys=phys, prev_rpms=jnp.where(elim, 0.0, st.rpms),
                       rpms=jnp.where(elim, 0.0, rpm), mell=mell, cmdr=cmdr,
                       step_counter=st.step_counter + 1)


def _cmds(n_envs, n, step):
    """Drone 0 takes off (planner) then holds; drone 1 flies FULLSTATE
    targets; a few envs land."""
    ids = np.zeros((n_envs, n), np.int32)
    args = np.zeros((n_envs, n, 14), np.float32)
    if step == 0:
        ids[:, 0] = int(JCommand.TAKEOFF)
        args[:, 0, :2] = (0.4, 1.0)
        ids[::3, 0] = int(JCommand.GOTO)
        args[::3, 0, :6] = (0.2, -0.1, 0.5, 0.3, 1.2, 1.0)
    if step == 2:
        ids[::4, 0] = int(JCommand.LAND)
        args[::4, 0, :2] = (0.05, 1.5)
    if n > 1:
        ids[:, 1] = int(JCommand.FULLSTATE)
        args[:, 1, 0:3] = (0.3 * step, -0.2, 0.2 + 0.1 * step)
        args[:, 1, 9] = 0.2 * step
    return ids, args


@pytest.mark.parametrize("noise", [False, True], ids=["calm", "wind"])
def test_race_tick_matches_jax(noise):
    pspec, ptrack, jspec, jtrack = race_specs("getting_started", 2)
    B, n = 16, 2
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jst = jax.vmap(lambda k: jrace.race_reset(jspec, jtrack, k,
                                              dtype=jnp.float32))(keys)
    pl = prace.race_reset(pspec, ptrack, B, device="cpu")   # template
    tick = jax.jit(jax.vmap(lambda s, w, a: jax_tick(jspec, s, w, a)))
    proc = jax.jit(jax.vmap(
        lambda s, i, a: jrace.process_commands(jspec, s, i, a)))
    rng = np.random.default_rng(int(noise))
    compared = stable_envs = 0
    z0 = np.asarray(jst.phys.pos)[:, 0, 2].copy()
    for step in range(3):
        ids, args = _cmds(B, n, step)
        jst = proc(jst, jnp.asarray(ids), jnp.asarray(args))
        for i in range(pspec.steps_per_ctrl):
            if noise:
                wind = rng.uniform(-0.1, 0.1, (B, n, 3)).astype(F32)
                act = rng.normal(0.0, 0.001, (B, n, 4)).astype(F32)
            else:
                wind, act = None, np.zeros((B, n, 4), F32)
            ref = tick(jst, wind, act)
            pst = to_port(jst, pl)
            got = prace.race_tick(pspec, pst, None if wind is None
                                  else T(wind), T(act))
            rows = mell_stable(jst.mell, 1)
            t_now = (np.asarray(jst.mell.tick).astype(F32)
                     * (F32(1) / F32(500)))
            _assert_setpoint(got.cmdr, ref.cmdr, t_now, rows)
            assert_trees(got._replace(cmdr=pl.cmdr),
                         to_port(ref, pl)._replace(cmdr=pl.cmdr),
                         f"step {step} tick {i}", TICK_ATOL, rows)
            compared += 1
            stable_envs += int(rows.sum())
            jst = ref
    assert compared == 60 and stable_envs >= 0.5 * 60 * B, stable_envs
    # the flight went somewhere: drone 0 is taking off
    assert (np.asarray(jst.phys.pos)[:, 0, 2] > z0 + 0.002).all()


def _placed_state(jspec, jtrack, B, rng):
    """A JAX race state of B envs with the drones placed around their
    current gates, the obstacles, the plane and the bounds."""
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    st = jax.vmap(lambda k: jrace.race_reset(jspec, jtrack, k,
                                             dtype=jnp.float32))(keys)
    n, G = jspec.num_drones, jspec.num_gates
    gates = np.asarray(st.gates_actual)
    cur = rng.integers(0, G + 1, (B, n)).astype(np.int32)
    g = np.take_along_axis(gates, np.clip(cur, 0, G - 1)[..., None]
                           .repeat(7, -1), axis=1)
    yaw = g[..., 5]
    normal = np.stack([-np.sin(yaw), np.cos(yaw), 0 * yaw], -1)
    along = np.stack([np.cos(yaw), np.sin(yaw), 0 * yaw], -1)
    height = np.where(g[..., 6] == 0, 1.0, 0.525)[..., None]
    pos = (np.concatenate([g[..., :2], height], -1)
           + normal * rng.uniform(-0.08, 0.08, (B, n, 1))
           + along * rng.uniform(-0.35, 0.35, (B, n, 1))
           + rng.normal(0, 0.1, (B, n, 3)) * [0, 0, 1]).astype(F32)
    obst = np.asarray(st.obstacles_actual)[:, :n]
    near = rng.random((B, n)) < 0.2
    pos[near] = (obst[near][:, :3] + rng.normal(0, .06, (near.sum(), 3))
                 ).astype(F32)
    pos[:, :, 2][rng.random((B, n)) < 0.1] = 0.01      # on the plane
    pos[:, :, 0][rng.random((B, n)) < 0.05] = 9.0      # out of bounds
    if n > 1:   # a pair in contact
        pos[::5, 1] = pos[::5, 0] + [0.05, 0.0, 0.01]
    rpy = rng.uniform(-0.4, 0.4, (B, n, 3)).astype(F32)
    phys = st.phys._replace(
        pos=jnp.asarray(pos),
        quat=jrace.quat_ops.from_euler_xyz(jnp.asarray(rpy)),
        vel=jnp.asarray(rng.normal(0, 1, (B, n, 3)).astype(F32)),
        omega=jnp.asarray(rng.normal(0, 8, (B, n, 3)).astype(F32)))
    steps = rng.integers(0, 900, B).astype(np.int32)
    steps[::6] = int(jspec.episode_len_sec * jspec.pyb_freq) + 20
    return st._replace(
        phys=phys, current_gate=jnp.asarray(cur),
        finished=jnp.asarray(rng.random((B, n)) < 0.2),
        eliminated=jnp.asarray(rng.random((B, n)) < 0.1),
        step_counter=jnp.asarray(steps))


@pytest.mark.parametrize("config,n,compete", [
    ("level2", 2, True), ("getting_started", 1, False)],
    ids=["level2-compete", "getting_started"])
def test_finish_ctrl_step_matches_jax(config, n, compete):
    pspec, ptrack, jspec, jtrack = race_specs(config, n, compete)
    B = 256
    rng = np.random.default_rng(7)
    jst = _placed_state(jspec, jtrack, B, rng)
    ref = jax.jit(jax.vmap(
        lambda s: jrace.finish_ctrl_step(jspec, jtrack, s)))(jst)
    pl = prace.race_reset(pspec, ptrack, B, device="cpu")
    got = prace.finish_ctrl_step(pspec, ptrack, to_port(jst, pl))
    rs, obs, _, term, trunc, info = got
    jrs, jobs, _, jterm, jtrunc, jinfo = ref
    for k in ("current_gate", "eliminated", "finished"):
        np.testing.assert_array_equal(getattr(rs, k).numpy(),
                                      np.asarray(getattr(jrs, k)), err_msg=k)
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(info["task_completed"].numpy(),
                                  np.asarray(jinfo["task_completed"]))
    assert_race_obs(obs.numpy(), np.asarray(jobs), pspec.num_gates,
                    pspec.num_obstacles)
    # the data reaches every outcome
    elim_new = rs.eliminated.numpy() & ~np.asarray(jst.eliminated)
    passed = rs.current_gate.numpy() > np.asarray(jst.current_gate)
    assert elim_new.any() and passed.any() and term.any() and trunc.any()
    assert (~elim_new & ~np.asarray(jst.eliminated)).any()


def test_process_commands_matches_jax():
    """Every command to live and eliminated drones (forced to STOP)."""
    pspec, ptrack, jspec, jtrack = race_specs("level2", 2)
    B = 22
    rng = np.random.default_rng(2)
    jst = _placed_state(jspec, jtrack, B, rng)
    jst = jst._replace(eliminated=jnp.asarray(
        np.arange(2 * B).reshape(B, 2) % 5 == 0))
    ids = (np.arange(2 * B).reshape(B, 2) % 11).astype(np.int32)
    args = rng.uniform(-1, 1, (B, 2, 14)).astype(F32)
    args[..., 1] = rng.uniform(0.5, 2.0, (B, 2))
    ref = jax.jit(jax.vmap(lambda s, i, a: jrace.process_commands(
        jspec, s, i, a)))(jst, ids, args)
    pl = prace.race_reset(pspec, ptrack, B, device="cpu")
    got = prace.process_commands(pspec, to_port(jst, pl), T(ids), T(args))
    c, jc_ = got.cmdr, ref.cmdr
    scale = np.abs(np.asarray(jc_.coeffs)).max(-1, keepdims=True)
    assert (np.abs(c.coeffs.numpy() - np.asarray(jc_.coeffs))
            <= ATOL + RTOL * scale).all()
    assert_trees(c._replace(coeffs=c.coeffs * 0),
                 to_port(jc_, c)._replace(coeffs=c.coeffs * 0), "cmdr")
    stop = np.asarray(jst.eliminated)
    assert stop.any() and (np.asarray(jc_.setpoint.mode_xyz)[stop] == 0).all()
    act = rng.uniform(-1, 1, (B, 2, 4)).astype(F32)
    sc = np.asarray(jst.step_counter).astype(F32)
    jid, jargs = jax.vmap(lambda a, s: jrace.actions_to_commands(
        jspec, a, s))(act, sc)
    pid, pargs = prace.actions_to_commands(pspec, T(act), T(sc))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(pargs.numpy(), np.asarray(jargs))

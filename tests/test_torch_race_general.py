"""Port: the general race env's modules against the JAX package, on CPU.

The commander (every command), the Mellinger firmware in object form
(``compute_control`` and each of its parts), every collision and
proximity function, and ``race_reset``/``rl_race_reset`` with injected
draws, on the same seeded float32 inputs, batched on the port's side and
``jax.vmap``-ed (or broadcast) on the JAX side, JAX jitted as it runs.

Tolerances: discrete outputs (modes, flags, ticks, counters, gate ids,
contact booleans) equal; continuous ones rtol 1e-5 / atol 1e-6, except
where XLA's contracted multiply-adds (the port rounds every operation)
meet a large gain or an ill-conditioned sum, each stated where it is
used:
  control_rpyt   atol 0.32 = 1e-5 of the +-32000 command range (the
                 attitude error's ulps times the 70000 gain; measured
                 <= 0.05 here, <= 0.18 in flight)
  gyro biquad    atol 1e-2 deg/s: an ulp of a pi-sized Euler angle
                 (atan2/asin in each package) differenced over one 0.002
                 s tick is 6.8e-3 deg/s (measured <= 1.6e-5 here, <=
                 3.4e-3 in flight, tests/test_torch_race_general_step.py)
  poly7 setpoint rtol 1e-5 of the sum of the evaluated terms'
                 magnitudes: the port evaluates by Horner (the window
                 kernel's form, shared), the JAX package by powers, so
                 the two round a cancelling sum differently (measured
                 <= 2.5e-3 m/s^2 on terms of ~1e4)
The tick gating is compared on states whose last-call gaps lie away
from the thresholds by more than rounding (the general path's
``gating_stable``), so gating flags and stamps are equal.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.control import commander as jcmd
from gym_pybullet_adrp_tpu.control import mellinger as jmel
from gym_pybullet_adrp_tpu.envs import race_rl as jrl
from gym_pybullet_adrp_tpu.ops import collision as jcol
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.control import commander as pcmd
from gym_pybullet_adrp_tpu_torch.control import mellinger as pmel
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs import race_rl as prl
from gym_pybullet_adrp_tpu_torch.ops import collision as pcol
from gym_pybullet_adrp_tpu_torch.utils.enums import Command

from _torch_port import (
    ATOL, CTL_ATOL, GYRO_ATOL, REPO, RTOL, assert_trees, jax_reset_draws,
    poly_term_scale, race_specs, tensor, to_port,
)

F32 = np.float32
T = tensor


# ---------------------------------------------------------------------------
# commander


def _commands(rng, B):
    """A batch holding every command, with args in their ranges."""
    ids = np.arange(B, dtype=np.int32) % len(Command)
    args = rng.uniform(-1, 1, (B, 14)).astype(F32)
    args[:, 1] = rng.uniform(0.5, 2.0, B)       # duration / speed
    args[:, 4] = rng.uniform(0.5, 2.0, B)       # goto duration
    args[:, 2] = rng.random(B) < 0.5            # relative (VEL variants)
    args[:, 5] = rng.random(B) < 0.5            # relative (GOTO)
    args[::7, 1] = -1.0                         # T <= 0: the constant
    return ids, args


def test_pack_command_matches_jax():
    for cmd, args in (
            (Command.FULLSTATE, ([1, 2, 3], [4, 5, 6], [7, 8, 9], 0.5,
                                 [0.1, 0.2, 0.3], 1.25)),
            (Command.TAKEOFF, (0.4, 1.5)), (Command.LANDYAW, (0.1, 2.0, 0.3)),
            (Command.TAKEOFFVEL, (0.5, 0.2, True)),
            (Command.GOTO, ([0.5, -0.5, 1.0], 0.2, 3.0, False)),
            (Command.STOP, ()), (Command.NOTIFY, ())):
        pid, pvec = pcmd.pack_command(cmd, args)
        jid, jvec = jcmd.pack_command(jenums.Command(int(cmd)), args)
        assert pid == jid
        np.testing.assert_array_equal(pvec, jvec)


def test_commander_matches_jax():
    """process_command over a batch of every command, then the planner's
    per-tick setpoint at several times, from a state that already holds
    a plan and a FULLSTATE setpoint."""
    rng = np.random.default_rng(0)
    B = 44
    ids, args = _commands(rng, B)
    pos, vel = (rng.uniform(-1, 1, (B, 3)).astype(F32) for _ in range(2))
    yaw = rng.uniform(-3, 3, B).astype(F32)
    t0 = F32(1.234)
    jst = jcmd.init_state((B,), dtype=jnp.float32)
    pst = pcmd.init_state((B,), device="cpu")
    for k in range(2):   # a second command on top of the first's state
        ids_k = np.roll(ids, 5 * k)
        jst = jax.jit(jcmd.process_command)(
            jst, jnp.asarray(ids_k), jnp.asarray(args), jnp.float32(t0),
            jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(yaw))
        pst = pcmd.process_command(pst, T(ids_k), T(args), torch.tensor(t0),
                                   T(pos), T(vel), T(yaw))
        # coeffs: the 8x8 basis product, rtol 1e-5 of the row's largest
        got, ref = pst.coeffs.numpy(), np.asarray(jst.coeffs)
        scale = np.abs(ref).max(-1, keepdims=True)
        assert (np.abs(got - ref) <= ATOL + RTOL * scale).all()
        assert_trees(pst._replace(coeffs=pst.coeffs * 0),
                     jst._replace(coeffs=jst.coeffs * 0), f"cmd {k}")
    for t in (1.3, 2.0, 2.9, 6.0):
        ju = jax.jit(jcmd.update_setpoint)(jst, jnp.float32(t))
        pu = pcmd.update_setpoint(pst, torch.tensor(F32(t)))
        rel = t - np.asarray(jst.t_begin)
        sp_, sv, sa = poly_term_scale(np.asarray(jst.coeffs), rel,
                                      np.asarray(jst.duration))
        use = (~np.asarray(jst.full_state_override)
               & np.asarray(jst.planner_active))
        for f, scale in (("pos", sp_[:, :3]), ("vel", sv[:, :3]),
                         ("acc", sa[:, :3]),
                         ("att_rpy", sp_[:, 3:] * pcmd.RAD_TO_DEG),
                         ("att_rate", sv[:, 3:] * pcmd.RAD_TO_DEG)):
            g = getattr(pu.setpoint, f).numpy()
            r = np.asarray(getattr(ju.setpoint, f))
            tol = ATOL + RTOL * (np.abs(r) + np.where(use[:, None], scale, 0))
            if f in ("att_rpy", "att_rate"):
                g, r, tol = g[:, 2:], r[:, 2:], tol[:, -1:]
            assert (np.abs(g - r) <= tol).all(), (t, f)
        for f in ("att_quat", "thrust", "mode_xyz", "mode_rpy", "mode_quat"):
            np.testing.assert_array_equal(getattr(pu.setpoint, f).numpy(),
                                          np.asarray(getattr(ju.setpoint, f)))


# ---------------------------------------------------------------------------
# Mellinger, object form


def _firmware_inputs(rng, B):
    """A controller state and setpoint in flight ranges: ticks whose
    last-call gaps sit 5e-5 or more from the 0.002 / 0.01 thresholds,
    every setpoint mode, a few tumbling states."""
    def u(lo, hi, *s):
        return rng.uniform(lo, hi, s).astype(F32)

    tick = rng.integers(0, 2000, B).astype(np.int32)
    cur = (tick.astype(F32) * (F32(1) / F32(500))).astype(F32)

    def last(center, spread):
        g = u(center - spread, center + spread, B)
        g = np.where(np.abs(g - center) < 5e-5, g + 1e-4, g).astype(F32)
        return (cur - g).astype(F32)

    ms = jmel.MellingerState(
        i_error_pos=u(-.1, .1, B, 3), i_error_m=u(-.1, .1, B, 3),
        prev_omega_rp=u(-1, 1, B, 2), prev_setpoint_omega_rp=u(-1, 1, B, 2),
        control_rpyt=np.concatenate([u(-3e3, 3e3, B, 3),
                                     u(2e4, 5e4, B, 1)], 1),
        tick=tick, last_pos_pid_call=last(0.01, 0.005),
        last_att_pid_call=last(0.002, 0.0015),
        tumble_counter=rng.integers(0, 35, B).astype(np.int32),
        error_flag=rng.random(B) < 0.1,
        prev_rpy=u(-.3, .3, B, 3), prev_vel=u(-1, 1, B, 3),
        acc_lpf=jmel.Lpf2pState(u(-1, 1, B, 3), u(-1, 1, B, 3)),
        gyro_lpf=jmel.Lpf2pState(u(-50, 50, B, 3), u(-50, 50, B, 3)),
        sensor_history=np.zeros((B, 0, 6), F32))
    q = u(-1, 1, B, 4)
    sp = jmel.Setpoint(
        pos=u(-1, 1, B, 3), vel=u(-1, 1, B, 3), acc=u(-1, 1, B, 3),
        att_rpy=u(-30, 30, B, 3), att_rate=u(-50, 50, B, 3),
        att_quat=(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(F32),
        thrust=u(0, 4e4, B),
        mode_xyz=rng.integers(0, 2, (B, 1)).repeat(3, 1).astype(np.int32),
        mode_rpy=rng.integers(0, 3, (B, 3)).astype(np.int32),
        mode_quat=rng.integers(0, 2, B).astype(np.int32))
    kin = dict(cur_pos=u(-1, 1, B, 3),
               cur_rpy=(ms.prev_rpy + u(-2e-3, 2e-3, B, 3)).astype(F32),
               cur_vel=(ms.prev_vel + u(-.02, .02, B, 3)).astype(F32),
               disturbance=u(-1e-3, 1e-3, B, 4))
    pms = to_port(ms, pmel.init_state((B,), device="cpu"))
    psp = to_port(sp, pmel.zero_setpoint((B,), device="cpu"))
    return ms, sp, kin, pms, psp


FIRMWARE_PARTS = ("compute_control", "update_sensor_and_state",
                  "step_controller", "controller_mellinger", "compute_pwms",
                  "pwms_to_rpm_with_disturbance")


@pytest.mark.parametrize("part", FIRMWARE_PARTS)
def test_firmware_matches_jax(part):
    rng = np.random.default_rng(FIRMWARE_PARTS.index(part))
    B = 2048
    ms, sp, kin, pms, psp = _firmware_inputs(rng, B)
    k = kin
    pk = {n: T(v) for n, v in k.items()}
    tol = {"control_rpyt": CTL_ATOL, "gyro_lpf.d1": GYRO_ATOL}
    if part == "compute_control":
        ref = jax.jit(lambda *a: jmel.compute_control(*a, kf=3.16e-10))(
            ms, sp, k["cur_pos"], k["cur_rpy"], k["cur_vel"],
            k["disturbance"])
        got = pmel.compute_control(pms, psp, pk["cur_pos"], pk["cur_rpy"],
                                   pk["cur_vel"], pk["disturbance"],
                                   kf=3.16e-10)
        assert_trees(got[0], ref[0], part, tol)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=RTOL)
        return
    # the sensor stage feeds the controller stages on both sides
    jsen = jax.jit(jmel.update_sensor_and_state)(
        ms, k["cur_pos"], k["cur_rpy"], k["cur_vel"])
    psen = pmel.update_sensor_and_state(pms, pk["cur_pos"], pk["cur_rpy"],
                                        pk["cur_vel"])
    if part == "update_sensor_and_state":
        assert_trees(psen[0], jsen[0], part, tol)
        assert_trees(psen[1], jsen[1], part)
        np.testing.assert_allclose(psen[2].numpy(), jsen[2], rtol=RTOL,
                                   atol=GYRO_ATOL)
        np.testing.assert_allclose(psen[3].numpy(), jsen[3], rtol=RTOL,
                                   atol=ATOL)
        return
    # controller stages from the JAX sensor outputs, handed to both
    fw = jsen[1]
    pfw = to_port(fw, pmel.FirmwareState(*[psen[1][i] for i in range(5)]))
    gyro = np.asarray(jsen[2])
    if part == "step_controller":
        ref = jax.jit(jmel.step_controller)(ms, sp, fw, gyro, jsen[3])
        got = pmel.step_controller(pms, psp, pfw, T(gyro), T(jsen[3]))
        assert_trees(got[0], ref[0], part, tol)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=RTOL,
                                   atol=CTL_ATOL)
    elif part == "controller_mellinger":
        run = rng.random(B) < 0.7
        ref = jax.jit(jmel.controller_mellinger)(ms, sp, gyro, fw, run)
        got = pmel.controller_mellinger(pms, psp, T(gyro), pfw, T(run))
        assert_trees(got[0], ref[0], part, tol)
    elif part == "compute_pwms":
        ctl = rng.uniform(-4e4, 7e4, (B, 4)).astype(F32)
        np.testing.assert_allclose(
            pmel.compute_pwms(T(ctl)).numpy(),
            jax.jit(jmel.compute_pwms)(ctl), rtol=RTOL, atol=ATOL)
    else:
        pwm = rng.uniform(1e4, 7e4, (B, 4)).astype(F32)
        dist = k["disturbance"] * 50
        np.testing.assert_allclose(
            pmel.pwms_to_rpm_with_disturbance(T(pwm), 3.16e-10,
                                              T(dist)).numpy(),
            jax.jit(lambda p, d: jmel.pwms_to_rpm_with_disturbance(
                p, 3.16e-10, d))(pwm, dist), rtol=RTOL)


# ---------------------------------------------------------------------------
# collisions


def _geometry(rng, n=4096):
    """Drones scattered around gates, obstacles and the plane, close
    enough that every contact test both fires and misses."""
    gate = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                           rng.uniform(0.5, 1.2, (n, 1)),
                           np.zeros((n, 2)), rng.uniform(-3, 3, (n, 1))],
                          1).astype(F32)
    pos = (gate[:, :3] + rng.normal(0, 0.3, (n, 3))).astype(F32)
    pos[::9, 2] = rng.uniform(-0.01, 0.03, len(pos[::9]))
    return pos, gate


COLLISION_FNS = ("point_segment_distance", "gate_beam_segments",
                 "drone_gate_distance", "drone_obstacle_distance",
                 "gate_pass_rays", "drone_drone_collision",
                 "drone_gate_collision", "drone_obstacle_collision",
                 "ground_collision")


@pytest.mark.parametrize("fn", COLLISION_FNS)
def test_collision_matches_jax(fn):
    rng = np.random.default_rng(COLLISION_FNS.index(fn) + 10)
    pos, gate = _geometry(rng)
    n = len(pos)
    r = np.full(n, 0.06, F32)
    args = {
        "point_segment_distance": (pos, gate[:, :3],
                                   (gate[:, :3] + rng.normal(0, .3, (n, 3))
                                    ).astype(F32)),
        "gate_beam_segments": (gate[:, :6],),
        "drone_gate_distance": (pos, gate[:, :6]),
        "drone_obstacle_distance": (pos, gate),
        "gate_pass_rays": (pos, gate[:, :6],
                           rng.integers(0, 2, n).astype(np.int32), r),
        "drone_drone_collision": (
            (pos[:, None] * 0.1 + rng.normal(0, .05, (n, 4, 3))
             ).astype(F32).reshape(n, 4, 3), np.full((n, 4, 1), .06, F32),
            np.full((n, 4, 1), .0125, F32)),
        "drone_gate_collision": (pos, gate[:, :6], r, np.full(n, .0125, F32)),
        "drone_obstacle_collision": (pos, gate, r, np.full(n, .0125, F32)),
        "ground_collision": (pos, np.full(n, .025, F32), np.zeros(n, F32)),
    }[fn]
    ref = jax.jit(getattr(jcol, fn))(*args)
    got = getattr(pcol, fn)(*(T(a) for a in args))
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    for g, rr in zip(got, ref):
        g, rr = g.numpy(), np.asarray(rr)
        assert g.shape == rr.shape
        if g.dtype == bool:
            np.testing.assert_array_equal(g, rr, err_msg=fn)
            assert 0 < g.sum() < g.size, f"{fn}: one-sided data"
        else:
            np.testing.assert_allclose(g, rr, rtol=RTOL, atol=ATOL,
                                       err_msg=fn)


# ---------------------------------------------------------------------------
# reset


@pytest.mark.parametrize("config,n_drones", [
    ("getting_started", 1), ("level2", 2), ("level3", 4)])
def test_race_reset_matches_jax(config, n_drones):
    pspec, ptrack, jspec, jtrack = race_specs(config, n_drones,
                                              n_drones > 2)
    B = 8
    keys = jax.random.split(jax.random.PRNGKey(n_drones), B)
    jst = jax.vmap(lambda k: jrl.rl_race_reset(jspec, jtrack, k,
                                               dtype=jnp.float32))(keys)
    pst = prl.rl_race_reset(pspec, ptrack, B, jax_reset_draws(pspec, keys),
                            device="cpu")
    assert_trees(pst, to_port(jst, pst), config)
    # the same draws give the port's race_reset the same race state
    rs = prace.race_reset(pspec, ptrack, B, jax_reset_draws(pspec, keys),
                          device="cpu")
    assert_trees(rs, pst.race, config)
    if pspec.random_gates_obstacles:   # the draws moved the track
        assert not np.allclose(rs.gates_actual[0], rs.gates_actual[1])


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py imports jax, flax or
    the JAX package (a static check of their import lines)."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|gym_pybullet_adrp_tpu)"
                     r"(\s|\.|$)", re.M)
    files = sorted((REPO / "gym_pybullet_adrp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert len(files) > 30 and not hits, hits


def test_quat_rotate_x_matches_jax():
    """The body +x axis in the world frame (the body camera's forward)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(F32)
    ref = jax.vmap(lambda x: jrl.quat_rotate_x(x, jnp.float32))(q)
    np.testing.assert_allclose(prl.quat_rotate_x(T(q)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)

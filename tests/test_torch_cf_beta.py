"""Port: CFAviary, CFPIDAviary and BetaAviary (envs/cf.py, envs/beta.py)
against the JAX package on CPU.

* The firmware window tick by tick (Mellinger at 500 Hz and controllerPid
  at 1 kHz): the JAX package flies 16 envs through TAKEOFF, GOTO,
  FULLSTATE, LAND and STOP commands, and at every tick both packages take
  one tick from the same JAX state (the JAX env built with ``ctrl_freq``
  equal to the firmware rate, whose jitted window is one tick, vmapped).
  A closed loop would compare the firmware's D-term, which multiplies ulp
  differences ~500x a tick. On envs whose tick gating does not depend on
  rounding (``mell_stable``; XLA fuses ``tick * c - last``): the state at
  rtol 1e-5 / atol 1e-6, the commands at ``CTL_ATOL``, the gyro filter at
  ``GYRO_ATOL`` (tests/test_torch_race_general_step.py's), the PID loops
  at rtol 1e-5 / atol 2e-2 (deg, deg/s: their errors take the gyro), the
  planner's setpoint at rtol 1e-5 of its terms; ticks, flags and modes
  equal.
* The command queue pops one command a step; more than one drone is
  refused.
* ``ctbr2beta`` against the float64 transcription of the reference and the
  JAX function (channels equal except where the pre-round value lies
  within 1e-3 of a half, the float32 ulp at 2000 being 1.2e-4),
  ``beta2ctbr`` inverting it to one RC count, ``beta_motors_to_rpm`` and
  the SITL chain at rtol 1e-6.
* The Beta step from shared states of a 2-drone hover against the JAX
  package's jitted step: rtol 1e-5, atol 1e-5 on drones whose RC channels
  are not within 1e-3 of a half.
* Closed loops at tests/test_cf_beta.py's thresholds: the Mellinger
  takeoff-goto-land, STOP's motor cut, the RC gating before TRAJ_TIME and
  the 2-drone CTBR hover. The other flights of tests/test_cf_beta.py (PID
  tracking and landing, FULLSTATE, NOTIFY, the takeoff and land variants,
  relative GOTO) are long closed loops over the same window the per-tick
  tests cover, and are marked ``slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.control import CTBRControl as JCTBRControl
from gym_pybullet_adrp_tpu.envs import beta as jbeta
from gym_pybullet_adrp_tpu.envs import cf as jcf
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.utils.enums import Command as JCommand
from gym_pybullet_adrp_tpu_torch.control import CTBRControl, ctbr
from gym_pybullet_adrp_tpu_torch.envs import beta, cf
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
from gym_pybullet_adrp_tpu_torch.utils.constants import (
    MIN_PWM, PWM2RPM_CONST, PWM2RPM_SCALE,
)

from _torch_port import (
    CTL_ATOL, GYRO_ATOL, assert_setpoint, assert_trees, mell_stable, tensor,
    to_port,
)

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
F32 = np.float32
T = tensor
B = 16


def _jax_commands(step):
    """Per env (B, 1) command ids and args of control step ``step``."""
    ids = np.full((B, 1), -1, np.int32)
    args = np.zeros((B, 1, 14), F32)
    if step == 0:
        ids[:, 0] = int(JCommand.TAKEOFF)
        args[:, 0, :2] = (0.4, 1.0)
        ids[1::4, 0] = int(JCommand.TAKEOFFYAW)
        args[1::4, 0, :3] = (0.5, 1.0, 0.6)
    if step == 4:
        ids[::4, 0] = int(JCommand.GOTO)
        args[::4, 0, :6] = (0.2, -0.1, 0.5, 0.3, 1.2, 1.0)
        ids[2::4, 0] = int(JCommand.FULLSTATE)
        args[2::4, 0, 0:3] = (0.1, 0.1, 0.45)
        args[2::4, 0, 9] = 0.2
        ids[3::8, 0] = int(JCommand.LAND)
        args[3::8, 0, :2] = (0.05, 1.5)
    if step == 6:
        ids[7::8, 0] = int(JCommand.STOP)
    return ids, args


def _port_carry(jc, like):
    """The JAX window's (core, mell, pid, cmdr, action) carry, vmapped, as
    the port's FirmwareCarry."""
    core, mell, pid, cmdr, act = jc
    return cf.FirmwareCarry(
        core=to_port(core, like.core), mell=to_port(mell, like.mell),
        pid=to_port(pid, like.pid), cmdr=to_port(cmdr, like.cmdr),
        act_buf=T(np.moveaxis(np.asarray(act), 1, 0)))


def _template(env):
    """A port FirmwareCarry of B envs (the shapes ``to_port`` fills)."""
    from gym_pybullet_adrp_tpu_torch.control import commander, mellinger
    from gym_pybullet_adrp_tpu_torch.control import firmware_pid
    from gym_pybullet_adrp_tpu_torch.envs import core

    z = np.zeros((1, 3))
    return cf.FirmwareCarry(
        core=core.core_reset(env.cfg, z, z, B, device="cpu"),
        mell=mellinger.init_state((B, 1), device="cpu"),
        pid=firmware_pid.init_state((B, 1), device="cpu"),
        cmdr=commander.init_state((B, 1), device="cpu"),
        act_buf=torch.zeros((1, B, 1, 4)))


# the PID loops' errors take the finite-difference gyro (GYRO_ATOL) and the
# angle errors in degrees: atol 2e-2 on their integrators and memories
PID_ATOL = {"integ": 2e-2, "prev_error": 2e-2, "control_rpyt": CTL_ATOL,
            "att_desired_rpy": 1e-4, "actuator_thrust": 0.05}
TICK_ATOL = {"control_rpyt": CTL_ATOL, "gyro_lpf.d1": GYRO_ATOL,
             "act_buf": 0.05}


@pytest.mark.parametrize("controller", ["mellinger", "pid"])
def test_firmware_tick_matches_jax(controller):
    from gym_pybullet_adrp_tpu.control import commander as jcmd

    pid = controller == "pid"
    jcls = jcf.CFPIDAviary if pid else jcf.CFAviary
    fw_freq = 1000 if pid else 500
    jenv = jcls(pyb_freq=fw_freq, ctrl_freq=fw_freq)  # a one-tick window
    penv = (cf.CFPIDAviary if pid else cf.CFAviary)(pyb_freq=fw_freq,
                                                    device="cpu")
    like = _template(penv)
    rng = np.random.default_rng(3)
    jc = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape),
        (jenv._state, jenv._mell, jenv._pid, jenv._cmdr, jenv._action))
    pos = np.asarray(jc[0].phys.pos).copy()
    pos[..., :2] += rng.uniform(-0.2, 0.2, (B, 1, 2)).astype(F32)
    pos[..., 2] += rng.uniform(0.0, 0.05, (B, 1)).astype(F32)
    core = jc[0]._replace(phys=jc[0].phys._replace(pos=jnp.asarray(pos)))
    jc = (core,) + jc[1:]
    tick = jax.vmap(lambda *c: jenv._jit_window(*c)[:5])

    n_ticks = fw_freq // 25
    compared = stable = 0
    for step in range(8):
        ids, args = _jax_commands(step)   # id -1: no command
        core = jc[0]
        cmdr = jcmd.process_command(
            jc[3], jnp.asarray(ids), jnp.asarray(args),
            jnp.full((B, 1), step / 25, jnp.float32), core.phys.pos,
            core.phys.vel, core.phys.rpy[..., 2])
        jc = jc[:3] + (cmdr, jc[4])
        for i in range(n_ticks):
            ref = tick(*jc)
            got = cf.firmware_tick(penv.cfg, penv.params, fw_freq, pid,
                                   _port_carry(jc, like))
            rows = mell_stable(jc[1], 1, 1.0 / fw_freq)
            t_now = (np.asarray(jc[1].tick).astype(F32)
                     * (F32(1) / F32(fw_freq)))
            assert_setpoint(got.cmdr, ref[3], t_now, rows)
            refp = _port_carry(ref, like)
            tag = f"{controller} step {step} tick {i}"
            # the action ring's batch axis is its second
            assert_trees(
                got._replace(cmdr=like.cmdr, pid=like.pid,
                             act_buf=got.act_buf.movedim(0, 1)),
                refp._replace(cmdr=like.cmdr, pid=like.pid,
                              act_buf=refp.act_buf.movedim(0, 1)),
                tag, TICK_ATOL, rows)
            assert_trees(got.pid, refp.pid, tag, PID_ATOL, rows)
            compared += 1
            stable += int(rows.sum())
            jc = ref
    assert compared == 8 * n_ticks and stable >= 0.5 * compared * B, stable
    z = np.asarray(jc[0].phys.pos)[:, 0, 2]
    assert (z > pos[:, 0, 2] + 0.01).sum() >= B // 2   # they took off


def test_cf_command_queue_pops_one_per_step():
    """Exactly one queued command executes per control step (reference
    _process_command_queue:428-433); the window counts its ticks."""
    env = cf.CFAviary(device="cpu")
    env.reset()
    env.sendTakeoffCmd(0.3, 1.5)
    env.sendGotoCmd([0.2, 0.2, 0.4], 0.0, 2.0, False)
    env.sendLandCmd(0.05, 2.0)
    assert len(env.command_queue) == 3
    for i, left in enumerate((2, 1, 0)):
        env.step(i)
        assert len(env.command_queue) == left
    assert env.tick == 60 == int(env._carry.mell.tick)
    assert env.step_counter == 60 == int(env._carry.core.step_counter)
    assert len(env.states) == 3 and env.states[-1][0] == 60 / 500
    with pytest.raises(NotImplementedError):
        cf.CFAviary(num_drones=2, device="cpu")


def test_cf_mellinger_takeoff_goto_land():
    """tests/test_cf_beta.py:14 on the port."""
    env = cf.CFAviary(device="cpu")
    obs, info = env.reset()
    assert obs.shape == (1, 20) and info == {"answer": 42}
    env.sendTakeoffCmd(0.3, 1.5)
    for i in range(100):
        obs, *_ = env.step(i)
    assert 0.2 < obs[0][2] < 0.5
    env.sendGotoCmd([0.5, 0.5, 0.5], 0.0, 2.0, False)
    for i in range(100, 200):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][:3], [0.5, 0.5, 0.5], atol=0.08)
    env.sendLandCmd(0.05, 2.0)
    for i in range(200, 275):
        obs, *_ = env.step(i)
    assert obs[0][2] < 0.15


def test_cf_stop_cuts_motors():
    """tests/test_cf_beta.py:177 on the port: STOP drops the drone, the
    motors at the MIN_PWM idle clip."""
    env = cf.CFAviary(device="cpu")
    env.reset()
    env.sendTakeoffCmd(0.5, 1.5)
    for i in range(70):
        obs, *_ = env.step(i)
    z_hover = float(obs[0][2])
    assert z_hover > 0.4
    env.sendStopCmd()
    for i in range(70, 100):
        obs, *_ = env.step(i)
    assert float(obs[0][2]) < z_hover - 0.2
    idle = PWM2RPM_SCALE * MIN_PWM + PWM2RPM_CONST
    np.testing.assert_allclose(obs[0][16:20], idle, atol=0.1)


@pytest.mark.slow
def test_cf_firmware_pid_tracks_and_lands():
    """tests/test_cf_beta.py:34 and :197 on the port."""
    env = cf.CFPIDAviary(pyb_freq=1000, device="cpu")
    assert env.firmware_freq == 1000
    env.reset()
    env.sendTakeoffCmd(0.3, 1.5)
    for i in range(100):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][2], 0.3, atol=0.05)
    env.sendGotoCmd([0.4, 0.2, 0.5], 0.0, 2.0, False)
    for i in range(100, 250):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][:3], [0.4, 0.2, 0.5], atol=0.02)
    env.reset()
    env.sendTakeoffCmd(0.4, 1.5)
    for i in range(80):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][2], 0.4, atol=0.05)
    env.sendLandCmd(0.05, 2.0)
    for i in range(80, 160):
        obs, *_ = env.step(i)
    assert obs[0][2] < 0.12


@pytest.mark.slow
def test_cf_command_variants_fly():
    """tests/test_cf_beta.py:49, :93, :136 and :158 on the port: FULLSTATE
    override; TAKEOFF, FULLSTATE stream, NOTIFY, LAND; TAKEOFFYAW and
    TAKEOFFVEL; relative GOTO and LANDVEL."""
    env = cf.CFAviary(device="cpu")
    env.reset()
    env.sendTakeoffCmd(0.3, 1.0)
    for i in range(50):
        obs, *_ = env.step(i)
    env.sendFullStateCmd([0.3, -0.3, 0.6], np.zeros(3), np.zeros(3), 0.0,
                         np.zeros(3), 2.0)
    for i in range(50, 150):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][:3], [0.3, -0.3, 0.6], atol=0.1)

    obs, _ = env.reset()
    i = 0
    env.sendTakeoffCmd(0.4, 1.5)
    for _ in range(60):
        obs, *_ = env.step(i)
        i += 1
    assert 0.3 < obs[0][2] < 0.5
    for k in range(50):
        env.sendFullStateCmd([0.3 * k / 50, 0.0, 0.4], np.zeros(3),
                             np.zeros(3), 0.0, np.zeros(3),
                             i / env.ctrl_freq)
        obs, *_ = env.step(i)
        i += 1
    assert obs[0][0] > 0.15
    env.notifySetpointStop()
    obs, *_ = env.step(i)
    i += 1
    env.sendLandCmd(0.03, 2.0)
    for _ in range(75):
        obs, *_ = env.step(i)
        i += 1
    assert obs[0][2] < 0.15

    env.reset()
    env.sendTakeoffYawCmd(0.5, 2.0, 0.8)
    for i in range(80):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][2], 0.5, atol=0.07)
    np.testing.assert_allclose(obs[0][9], 0.8, atol=0.15)
    env.reset()
    env.sendTakeoffVelCmd(0.4, 0.4, False)
    for i in range(60):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][2], 0.4, atol=0.08)

    env.reset()
    env.sendTakeoffCmd(0.4, 1.5)
    for i in range(60):
        obs, *_ = env.step(i)
    x0 = float(obs[0][0])
    env.sendGotoCmd([0.3, 0.0, 0.0], 0.0, 2.0, True)
    for i in range(60, 140):
        obs, *_ = env.step(i)
    np.testing.assert_allclose(obs[0][0], x0 + 0.3, atol=0.08)
    env.sendLandVelCmd(0.05, 0.3, False)
    for i in range(140, 220):
        obs, *_ = env.step(i)
    assert obs[0][2] < 0.15


# ---------------------------------------------------------------------------
# Betaflight unit conversions (reference BetaAviary.py:176-188, :239-267)


def _ctbr2beta_reference(thrust, roll, pitch, yaw):
    """Float64 transcription of reference ctbr2beta:176-188 and the RC
    packet's round() (step:150-157), with the pre-round values."""
    mid, d = 1500.0, 500.0
    thro = np.clip(thrust / 40.9 * d * 2 + 1000, 1000, 2000)
    rates = np.clip(np.stack([roll, pitch, -yaw], -1) / np.pi * 180 / 360
                    * d + mid, 1000, 2000)
    return thro, rates


def _near_half(x, tol=1e-3):
    return np.abs(np.abs(x - np.floor(x)) - 0.5) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ctbr2beta_matches_reference_and_jax(dtype):
    rng = np.random.default_rng(3)
    n = 4096
    a = np.stack([rng.uniform(-5.0, 50.0, n),
                  *rng.uniform(-2 * np.pi, 2 * np.pi, (3, n))], -1)
    thro_ref, rates_ref = _ctbr2beta_reference(*a.T)
    t = torch.as_tensor(a, dtype=dtype)
    thro, rates = beta.ctbr2beta(*t.unbind(-1))
    with jax.disable_jit():
        jthro, jrates = jbeta.ctbr2beta(*jnp.asarray(
            a.astype(np.float32)).T)
    for got, pre, jref in ((thro, thro_ref, jthro), (rates, rates_ref,
                                                     jrates)):
        got = got.numpy()
        ok = ~_near_half(pre)
        assert ok.mean() > 0.99
        # round() of the reference, half to even as numpy, jnp and torch
        np.testing.assert_array_equal(got[ok], np.round(pre)[ok])
        if dtype == torch.float32:
            np.testing.assert_array_equal(got, np.asarray(jref))
    # the inverse decodes to one RC count
    t2, r2 = beta.beta2ctbr(thro, rates)
    live = (a[:, 0] > 0) & (a[:, 0] < 40.9)
    assert (np.abs(t2.numpy() - a[:, 0])[live] <= 40.9 / 2000 + 1e-5).all()
    inside = (np.abs(a[:, 1:]) < np.pi).all(-1)
    assert (np.abs(r2.numpy() - a[:, 1:])[inside]
            <= np.radians(360 / 1000) + 1e-5).all()
    with jax.disable_jit():
        jt2, jr2 = jbeta.beta2ctbr(jnp.asarray(thro.numpy(), jnp.float32),
                                   jnp.asarray(rates.numpy(), jnp.float32))
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), rtol=1e-6)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), rtol=1e-6,
                               atol=1e-7)


def test_beta_motor_remap_and_rpm_map():
    """_preprocessAction (reference :239-267): remap [2, 1, 3, 0], then
    rpm = sqrt(MAX_THRUST / 4 / KF * u); the SITL's pre-permuted outputs
    recover the rate loop's rpm when no motor saturates."""
    params = drone_params(dtype=torch.float64, device="cpu")
    kf, max_thrust = float(params.kf), float(params.max_thrust)
    u = np.random.default_rng(5).uniform(0.0, 1.0, 4)
    ref = np.sqrt(max_thrust / 4 / kf * u[[2, 1, 3, 0]])
    got = beta.beta_motors_to_rpm(torch.as_tensor(u), params.max_thrust,
                                  params.kf)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    thrust = torch.tensor(9.8, dtype=torch.float64)
    rate_sp = torch.tensor([0.5, -0.3, 0.2], dtype=torch.float64)
    omega = torch.tensor([0.1, 0.0, -0.1], dtype=torch.float64)
    u_sitl = ctbr.betaflight_motor_outputs(params, thrust, rate_sp, omega)
    np.testing.assert_allclose(
        beta.beta_motors_to_rpm(u_sitl, params.max_thrust, params.kf),
        ctbr.rate_loop_rpm(params, thrust, rate_sp, omega), rtol=1e-9)
    jp = jdrone.drone_params(dtype=jnp.float32)
    pp = drone_params(device="cpu")
    uu = np.random.default_rng(6).uniform(0, 1, (64, 4)).astype(F32)
    with jax.disable_jit():
        jr = jbeta.beta_motors_to_rpm(jnp.asarray(uu), jp.max_thrust, jp.kf)
    np.testing.assert_allclose(
        beta.beta_motors_to_rpm(T(uu), pp.max_thrust, pp.kf).numpy(),
        np.asarray(jr), rtol=1e-6)


def test_beta_step_matches_jax():
    """The Beta step from shared states (a 2-drone CTBR hover flown by the
    JAX package) against its jitted step, with the controller's actions
    and random ones."""
    jenv = jbeta.BetaAviary(num_drones=2)
    penv = beta.BetaAviary(num_drones=2, device="cpu")
    obs, _ = jenv.reset()
    penv.reset()
    jctrl = JCTBRControl(jenv.DRONE_MODEL)
    target = np.array([[0.0, 0.0, 1.0], [0.3, 0.0, 1.0]])
    rng = np.random.default_rng(8)
    act = np.zeros((2, 4))
    checked = 0
    for i in range(48):
        live = float(np.float32(i / 25)) > beta.TRAJ_TIME
        for a in (act, act + rng.normal(0, [0.5, 0.3, 0.3, 0.3], (2, 4))):
            a32 = a.astype(F32)
            ref_state, _ = jenv._jit_step(jenv._state, jnp.asarray(a32),
                                          jnp.asarray(i / 25, jnp.float32))
            like = penv._state
            got = beta.beta_step(penv.cfg, penv.params,
                                 to_port(_batch1(jenv._state), like),
                                 T(a32)[None], live)
            thro_pre, rates_pre = _ctbr2beta_reference(
                *a32.T.astype(np.float64))
            pre = np.concatenate([thro_pre[:, None], rates_pre], -1)
            ok = ~_near_half(pre).any(-1) | (not live)
            ref = to_port(_batch1(ref_state), like)
            for name in ("pos", "quat", "vel", "omega"):
                np.testing.assert_allclose(
                    getattr(got.phys, name).numpy()[0][ok],
                    getattr(ref.phys, name).numpy()[0][ok], rtol=1e-5,
                    atol=1e-5, err_msg=f"step {i} {name}")
            np.testing.assert_allclose(
                got.last_clipped_action.numpy()[0][ok],
                ref.last_clipped_action.numpy()[0][ok], rtol=1e-5)
            assert int(got.step_counter[0]) == int(ref.step_counter)
            checked += int(ok.sum())
        obs, *_ = jenv.step(act, i)
        for j in range(2):
            act[j] = jctrl.computeControlFromState(1 / 25, obs[j], target[j])
    assert checked >= 0.9 * 48 * 2 * 2


def _batch1(state):
    """A JAX per-env CoreState with a batch axis of one."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], state)


def test_beta_rc_gating_and_ctbr_hover():
    """tests/test_cf_beta.py:289 and :357 on the port: motors off until
    TRAJ_TIME, then a 2-drone CTBR hover within 0.05 m of its targets."""
    env = beta.BetaAviary(num_drones=1, device="cpu")
    env.reset()
    act = np.array([[9.8, 0.0, 0.0, 0.0]])
    dead = int(beta.TRAJ_TIME * env.CTRL_FREQ)
    for i in range(dead):
        obs, *_ = env.step(act, i)
    assert np.all(obs[0][16:20] == 0.0) and obs[0][2] < 0.12
    obs, *_ = env.step(act, dead + 1)
    assert np.any(obs[0][16:20] > 0.0)

    env = beta.BetaAviary(num_drones=2, device="cpu")
    obs, _ = env.reset()
    ctrl = CTBRControl(env.DRONE_MODEL, device="cpu")
    target = np.array([[0.0, 0.0, 1.0], [0.3, 0.0, 1.0]])
    act = np.zeros((2, 4))
    for i in range(100):
        obs, *_ = env.step(act, i)
        for j in range(2):
            act[j] = ctrl.computeControlFromState(1 / 25, obs[j], target[j])
    np.testing.assert_allclose(obs[0][:3], target[0], atol=0.05)
    np.testing.assert_allclose(obs[1][:3], target[1], atol=0.05)
    assert env.step_counter == 100 * 20 == int(env._state.step_counter[0])

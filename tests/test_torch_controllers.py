"""Port: the firmware PID controller, the CTBR functions and the object
controller API (control/firmware_pid.py, control/ctbr.py, control/api.py)
against the JAX package on CPU, from the same seeded numpy inputs.

* ``controller_pid`` on 512 random firmware states, setpoints of every
  mode and random tick gates, against the jitted JAX function: integrators
  and errors at rtol 1e-5 / atol 1e-4 (degrees), the held thrust at rtol
  1e-6, the actuator commands at atol ``CTL_ATOL`` (1e-5 of their int16
  range: the rate D-term multiplies an ulp of the error by 2.5 x 500),
  ticks and gated leaves equal where the gate is closed. ``_wrap180``
  equals Python's floor modulo on negative and positive angles (atol 1e-4
  deg: float32 of angles up to 1000 deg).
* ``position_to_ctbr``, ``rate_loop_rpm`` and ``betaflight_motor_outputs``
  on 512 random states against the JAX functions run eagerly (as the JAX
  package's ``CTBRControl`` calls them): rtol 1e-5, atol 1e-5 (rates
  rad/s, thrust m/s^2), rpm at rtol 1e-5.
* The api: ``DSLPIDControl`` equals ``dslpid.compute_control`` on the same
  inputs (bit for bit) and the JAX wrapper at the DSL PID test's tolerances
  (rpm atol 0.05, errors atol 1e-5); ``CTBRControl`` the JAX wrapper at
  atol 1e-5; ``BaseControl._getURDFParameter`` the JAX one; the
  object-style ``MellingerControl`` flies a queued TAKEOFF on
  ``CtrlAviary`` at 500 Hz to 0.35-0.7 m (tests/test_controllers.py:211).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_pybullet_adrp_tpu.control import api as japi
from gym_pybullet_adrp_tpu.control import ctbr as jctbr
from gym_pybullet_adrp_tpu.control import firmware_pid as jfp
from gym_pybullet_adrp_tpu.control import mellinger as jmel
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.control import (
    CTBRControl, DSLPIDControl, MellingerControl, ctbr, dslpid,
    firmware_pid as fp, mellinger as mel,
)
from gym_pybullet_adrp_tpu_torch.envs.aviary import CtrlAviary
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
from gym_pybullet_adrp_tpu_torch.utils.enums import DroneModel

from _torch_port import CTL_ATOL, leaves, tensor, to_port

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
F32 = np.float32
B = 512


def _quat(rng, n):
    q = rng.normal(size=(n, 4)) * np.array([0.2, 0.2, 0.6, 1.0])
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(F32)


def _pid_inputs(rng):
    """Numpy leaves of a controllerPid state, setpoint, gyro, firmware
    state and gates."""
    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, (B,) + shape).astype(F32)

    pid = {}
    for name, lim in (("att_roll", 20.0), ("att_pitch", 20.0),
                      ("att_yaw", 360.0), ("rate_roll", 33.3),
                      ("rate_pitch", 33.3), ("rate_yaw", 166.7),
                      ("pos_z", 5.0), ("vel_x", 5.0), ("vel_y", 5.0),
                      ("vel_z", 5.0)):
        pid[name] = (u(-lim, lim), u(-30.0, 30.0))
    state = dict(pid=pid, control_rpyt=u(-3e4, 3e4, 4),
                 att_desired_rpy=u(-20.0, 20.0, 3),
                 actuator_thrust=u(2e4, 6e4),
                 tick=rng.integers(0, 5000, B).astype(np.int32),
                 last_pos_call=u(0.0, 10.0), last_att_call=u(0.0, 10.0))
    thrust = u(0.0, 6e4)
    thrust[::7] = 0.0
    sp = dict(pos=u(-1, 1, 3), vel=u(-1.5, 1.5, 3), acc=u(-2, 2, 3),
              att_rpy=u(-30, 30, 3), att_rate=u(-200, 200, 3),
              att_quat=_quat(rng, B), thrust=thrust,
              mode_xyz=rng.integers(0, 3, (B, 3)).astype(np.int32),
              mode_rpy=rng.integers(0, 3, (B, 3)).astype(np.int32),
              mode_quat=rng.integers(0, 2, B).astype(np.int32))
    rpy = np.concatenate([u(-30, 30, 2), u(-720, 720, 1)], -1)
    fw = dict(pos=u(-1, 1, 3), vel=u(-1.5, 1.5, 3), acc=u(-1, 1, 3),
              rpy_deg=rpy, quat=_quat(rng, B))
    gyro = u(-300, 300, 3)
    run_att = rng.random(B) < 0.6
    run_pos = run_att & (rng.random(B) < 0.5)
    return state, sp, fw, gyro, run_pos, run_att


def _pid_state(mod, d, conv):
    return mod.PidControllerState(
        **{k: mod.Pid(conv(v[0]), conv(v[1])) for k, v in d["pid"].items()},
        **{k: conv(v) for k, v in d.items() if k != "pid"})


def test_controller_pid_matches_jax():
    rng = np.random.default_rng(11)
    st, sp, fw, gyro, run_pos, run_att = _pid_inputs(rng)
    jout = jax.jit(jfp.controller_pid)(
        _pid_state(jfp, st, jnp.asarray),
        jmel.Setpoint(**{k: jnp.asarray(v) for k, v in sp.items()}),
        jnp.asarray(gyro),
        jmel.FirmwareState(**{k: jnp.asarray(v) for k, v in fw.items()}),
        jnp.asarray(run_pos), jnp.asarray(run_att))
    pst = _pid_state(fp, st, tensor)
    got_st, got_ctl = fp.controller_pid(
        pst, mel.Setpoint(**{k: tensor(v) for k, v in sp.items()}),
        tensor(gyro), mel.FirmwareState(**{k: tensor(v)
                                           for k, v in fw.items()}),
        tensor(run_pos), tensor(run_att))
    ref_st = to_port(jout[0], pst)
    np.testing.assert_allclose(got_ctl.numpy(), np.asarray(jout[1]),
                               rtol=0, atol=CTL_ATOL)
    for (name, g), (_, r) in zip(leaves(got_st), leaves(ref_st)):
        if name == ".control_rpyt":
            np.testing.assert_allclose(g, r, rtol=0, atol=CTL_ATOL)
        elif name == ".actuator_thrust":
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)
        elif g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
    # closed gates hold the statics exactly
    held = ~run_att
    np.testing.assert_array_equal(got_st.rate_roll.integ.numpy()[held],
                                  st["pid"]["rate_roll"][0][held])
    assert (got_ctl.numpy()[~run_att] == st["control_rpyt"][~run_att]).all()
    assert run_att.any() and run_pos.any() and held.any()


def test_wrap180_is_floor_modulo():
    x = np.concatenate([np.linspace(-1000, 1000, 4001),
                        [-540.0, -360.0, -190.0, -180.0, 180.0, 190.0]]
                       ).astype(F32)
    ref = (x.astype(np.float64) + 180.0) % 360.0 - 180.0
    got = fp._wrap180(tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jfp._wrap180(jnp.asarray(x))),
                               atol=1e-4)
    assert got[x == F32(-190.0)] == pytest.approx(170.0)
    assert (got >= -180.0).all() and (got < 180.0 + 1e-4).all()


def test_position_to_ctbr_matches_jax():
    rng = np.random.default_rng(12)
    pos, vel = rng.uniform(-1, 1, (2, B, 3)).astype(F32)
    tgt = rng.uniform(-1, 1, (B, 3)).astype(F32)
    tvel = rng.uniform(-0.5, 0.5, (B, 3)).astype(F32)
    q = _quat(rng, B)
    with jax.disable_jit():
        jt, jr = jctbr.position_to_ctbr(*(jnp.asarray(x) for x in
                                          (pos, q, vel, tgt, tvel)))
        jt0, jr0 = jctbr.position_to_ctbr(*(jnp.asarray(x) for x in
                                            (pos, q, vel, tgt)))
    t, r = ctbr.position_to_ctbr(*(tensor(x) for x in
                                   (pos, q, vel, tgt, tvel)))
    t0, r0 = ctbr.position_to_ctbr(*(tensor(x) for x in (pos, q, vel, tgt)))
    for g, ref in ((t, jt), (r, jr), (t0, jt0), (r0, jr0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("model", ["CF2X", "RACE"])
def test_rate_loop_matches_jax(model):
    rng = np.random.default_rng(13)
    jp = jdrone.drone_params(jenums.DroneModel[model])
    pp = drone_params(DroneModel[model], device="cpu")
    thrust = rng.uniform(-2.0, 40.0, B).astype(F32)
    sp, om = rng.uniform(-6, 6, (2, B, 3)).astype(F32)
    with jax.disable_jit():
        jrpm = jctbr.rate_loop_rpm(jp, *(jnp.asarray(x)
                                         for x in (thrust, sp, om)))
        ju = jctbr.betaflight_motor_outputs(jp, *(jnp.asarray(x)
                                                  for x in (thrust, sp, om)))
    rpm = ctbr.rate_loop_rpm(pp, *(tensor(x) for x in (thrust, sp, om)))
    u = ctbr.betaflight_motor_outputs(pp, *(tensor(x)
                                            for x in (thrust, sp, om)))
    np.testing.assert_allclose(rpm.numpy(), np.asarray(jrpm), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-7)
    # both saturations and the zero clip are exercised
    assert (u.numpy() == 1.0).any() and (u.numpy() == 0.0).any()


def test_dslpid_control_object_matches():
    rng = np.random.default_rng(14)
    jc = japi.DSLPIDControl(jenums.DroneModel.CF2X)
    pc = DSLPIDControl(DroneModel.CF2X, device="cpu")
    params = drone_params(device="cpu")
    ctl = dslpid.init_state((), device="cpu")
    for k in range(12):
        args = [rng.uniform(-1, 1, 3), _quat(rng, 1)[0],
                rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3),
                rng.uniform(-1, 1, 3), np.array([0, 0, rng.uniform(-1, 1)]),
                rng.uniform(-0.5, 0.5, 3), np.zeros(3)]
        kw = dict(cur_pos=args[0], cur_quat=args[1], cur_vel=args[2],
                  cur_ang_vel=args[3], target_pos=args[4],
                  target_rpy=args[5], target_vel=args[6],
                  target_rpy_rates=args[7])
        rpm, pos_e, yaw_e = pc.computeControl(1 / 48, **kw)
        jrpm, jpos_e, jyaw_e = jc.computeControl(1 / 48, **kw)
        t = [tensor(np.asarray(a, dtype=F32)) for a in args]
        ref = dslpid.compute_control(params, ctl, float(F32(1 / 48)), t[0],
                                     t[1], t[2], t[4], t[5], t[6], t[7])
        ctl = ref[1]
        np.testing.assert_array_equal(rpm, ref[0].numpy())
        np.testing.assert_array_equal(pos_e, ref[2].numpy())
        assert yaw_e == float(ref[3])
        np.testing.assert_array_equal(pc.integral_pos_e,
                                      ctl.integral_pos_e.numpy())
        np.testing.assert_allclose(rpm, jrpm, atol=0.05)
        np.testing.assert_allclose(pos_e, jpos_e, atol=1e-5)
        np.testing.assert_allclose(yaw_e, jyaw_e, atol=1e-5)
        np.testing.assert_allclose(pc.integral_rpy_e, jc.integral_rpy_e,
                                   atol=1e-5)
    assert pc.control_counter == 12
    pc.setPIDCoefficients(p_coeff_pos=[1.0, 1.0, 1.0])
    np.testing.assert_array_equal(pc.P_COEFF_FOR, [1.0, 1.0, 1.0])
    with pytest.raises(AttributeError):
        CTBRControl(DroneModel.CF2X, device="cpu").setPIDCoefficients()
    for name in ("m", "arm", "kf", "km", "ixx", "izz", "drag_coeff_z",
                 "gnd_eff_coeff", "dw_coeff_1"):
        assert pc._getURDFParameter(name) == pytest.approx(
            jc._getURDFParameter(name), rel=1e-6)


def test_ctbr_control_object_matches():
    rng = np.random.default_rng(15)
    jc = japi.CTBRControl(jenums.DroneModel.CF2X)
    pc = CTBRControl(DroneModel.CF2X, device="cpu")
    for _ in range(8):
        state = np.zeros(20)
        state[0:3] = rng.uniform(-1, 1, 3)
        state[3:7] = _quat(rng, 1)[0]
        state[10:13] = rng.uniform(-1, 1, 3)
        target = rng.uniform(-1, 1, 3)
        tvel = rng.uniform(-0.3, 0.3, 3)
        got = pc.computeControlFromState(1 / 25, state, target,
                                         target_vel=tvel)
        ref = jc.computeControlFromState(1 / 25, state, target,
                                         target_vel=tvel)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_oo_mellinger_wrapper_flies():
    """tests/test_controllers.py:211 on the port: the queued TAKEOFF on
    CtrlAviary at 500 Hz climbs to 0.35-0.7 m; the queue pops one command
    per call."""
    env = CtrlAviary(num_drones=1, pyb_freq=500, ctrl_freq=500,
                     initial_xyzs=np.array([[0, 0, 0.1]]), device="cpu")
    obs, _ = env.reset()
    ctrl = MellingerControl(0, DroneModel.CF2X, device="cpu")
    init_obs = np.hstack([obs[0][:3], obs[0][7:10], obs[0][10:13],
                          obs[0][13:16]])[None]
    ctrl.reset(init_obs)
    ctrl.sendTakeoffCmd(0.5, 2.0)
    ctrl.sendStopCmd()
    ctrl.process_command_queue(0.0)
    assert len(ctrl.command_queue) == 1
    ctrl.command_queue.clear()
    action = np.zeros((1, 4))
    for _ in range(1500):
        obs, *_ = env.step(action)
        action[0] = ctrl.computeControl(1 / 500, obs[0][:3], obs[0][7:10],
                                        obs[0][10:13], obs[0][13:16],
                                        np.zeros(4))
    assert 0.35 < obs[0][2] < 0.7
    assert int(ctrl.mell.tick) == 1500

"""Port: the hover env's modules against the JAX package, on CPU.

Drone params (rtol 1e-6), quaternion ops (atol 1e-6), one control step
of the rigid-body dynamics in all six physics modes (atol 2e-5 on
pos/quat/vel, 2e-4 on the body rates), and the RL env (rl_step and
autoreset_step over 20 steps, RPM and ONE_D_RPM, hover and multihover:
obs atol 1e-5, reward atol 1e-5, terminated/truncated equal). The same
float32 inputs, drawn with numpy, go to both sides. XLA on CPU contracts
multiply-adds into FMAs and the port rounds every op separately, hence
tolerances rather than equality. The last tests port the hover checks of
tests/test_rl.py to the port alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.envs import core as jcore
from gym_pybullet_adrp_tpu.envs import rl as jrl
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.ops import dynamics as jdyn
from gym_pybullet_adrp_tpu.ops import quat as jquat
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.convert import (
    drone_params_from_numpy, rl_state_from_numpy,
)
from gym_pybullet_adrp_tpu_torch.envs import core, rl as rlenv
from gym_pybullet_adrp_tpu_torch.models import drone
from gym_pybullet_adrp_tpu_torch.ops import dynamics, quat
from gym_pybullet_adrp_tpu_torch.utils.enums import (
    ActionType, DroneModel, Physics,
)

F32 = np.float32
INIT_XYZS = np.array([[0.0, 0.0, 0.1125]])
INIT_RPYS = np.zeros((1, 3))
DERIVED = ("J_inv", "gravity", "hover_rpm", "max_rpm", "max_thrust",
           "max_z_torque", "gnd_eff_h_clip", "speed_limit")


def _np(x):
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("model", list(DroneModel), ids=lambda m: m.name)
def test_drone_params_match_jax(model):
    jp = jdrone.drone_params(jenums.DroneModel[model.name], dtype=jnp.float32)
    p = drone.drone_params(model, device="cpu")
    for name in p._fields + DERIVED:
        np.testing.assert_allclose(_np(getattr(p, name)),
                                   _np(getattr(jp, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        _np(drone.max_xy_torque(model, p)),
        _np(jdrone.max_xy_torque(jenums.DroneModel[model.name], jp)),
        rtol=1e-6)
    assert p.kf.device.type == "cpu"
    for a, b in zip(drone_params_from_numpy(jp, device="cpu"), p):
        assert torch.equal(a, b)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(F32)


def _quat_cases():
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng), _quats(rng)
    v = rng.normal(size=(64, 3)).astype(F32)
    rpy = rng.uniform(-np.pi / 2, np.pi / 2, size=(64, 3)).astype(F32)
    om = rng.normal(0, 3, size=(64, 3)).astype(F32)
    om[:4] = 0.0                              # the omega = 0 branch
    mat = np.asarray(jquat.to_matrix(jnp.asarray(q1)), dtype=F32)
    return {
        "from_euler_xyz": (rpy,), "to_euler_xyz": (q1,),
        "to_matrix": (q1,), "from_matrix": (mat,),
        "from_euler_intrinsic_xyz": (rpy,), "to_euler_intrinsic_xyz": (q1,),
        "multiply": (q1, q2), "conjugate": (q1,),
        "normalize": (q1 * 1.7,), "rotate": (q1, v), "rotate_inv": (q1, v),
        "integrate_body": (q1, om, F32(1 / 240)),
        "integrate_world": (q1, om, F32(1 / 240)),
    }


@pytest.mark.parametrize("fn", sorted(_quat_cases()))
def test_quat_matches_jax(fn):
    args = _quat_cases()[fn]
    ref = getattr(jquat, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(quat, fn)(*[torch.from_numpy(np.array(a)) if
                              np.ndim(a) else float(a) for a in args])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _phys_inputs(rng, B=4, N=2):
    pos = rng.uniform(-0.3, 0.3, size=(B, N, 3)) + [0, 0, 0.6]
    pos[:, 1, :2] = pos[:, 0, :2] + 0.05        # stacked: downwash acts
    pos[0, :, 2] = [0.02, 0.5]                  # one drone near the ground
    rpy = rng.uniform(-0.3, 0.3, size=(B, N, 3))
    vel = rng.uniform(-1, 1, size=(B, N, 3))
    om = rng.uniform(-2, 2, size=(B, N, 3))
    rpm = rng.uniform(0.9, 1.1, size=(B, N, 4))
    prev = rng.uniform(0.9, 1.1, size=(B, N, 4))
    return [x.astype(F32) for x in (pos, rpy, vel, om, rpm, prev)]


@pytest.mark.parametrize("physics", list(Physics), ids=lambda p: p.name)
def test_ctrl_step_all_physics_modes_match_jax(physics):
    rng = np.random.default_rng(int(physics))
    pos, rpy, vel, om, rpm, prev = _phys_inputs(rng)
    jp = jdrone.drone_params(jenums.DroneModel.CF2X, dtype=jnp.float32)
    p = drone.drone_params(DroneModel.CF2X, device="cpu")
    hover = float(p.hover_rpm)
    rpm, prev = rpm * F32(hover), prev * F32(hover)
    jphys = jenums.Physics(int(physics))
    quat0 = np.array(jquat.from_euler_xyz(jnp.asarray(rpy)), dtype=F32)

    def one(s, r, pr):
        return jdyn.ctrl_step(jp, s, r, pr, jnp.float32(1 / 240), 8,
                              jenums.DroneModel.CF2X, jphys)[0]

    jstate = jdyn.PhysState(*(jnp.asarray(x) for x in (pos, quat0, vel, om)))
    ref = jax.jit(jax.vmap(one))(jstate, jnp.asarray(rpm), jnp.asarray(prev))
    state = dynamics.PhysState(*(torch.from_numpy(x)
                                 for x in (pos, quat0, vel, om)))
    got, last = dynamics.ctrl_step(p, state, torch.from_numpy(rpm),
                                   torch.from_numpy(prev), 1 / 240, 8,
                                   DroneModel.CF2X, physics)
    assert torch.equal(last, torch.from_numpy(rpm))
    for name, tol in (("pos", 2e-5), ("quat", 2e-5), ("vel", 2e-5),
                      ("omega", 2e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)


def _cfgs(act, task, n):
    kw = dict(act_type=act, task=task)
    return (rlenv.RLConfig(aviary=core.AviaryConfig(ctrl_freq=30,
                                                    num_drones=n), **kw),
            jrl.RLConfig(aviary=jcore.AviaryConfig(ctrl_freq=30,
                                                   num_drones=n),
                         act_type=jenums.ActionType[act.name], task=task))


@pytest.mark.parametrize("act,task", [
    (ActionType.RPM, "hover"), (ActionType.ONE_D_RPM, "hover"),
    (ActionType.RPM, "multihover"), (ActionType.ONE_D_RPM, "multihover")],
    ids=["rpm-hover", "one_d_rpm-hover", "rpm-multihover",
         "one_d_rpm-multihover"])
def test_rl_autoreset_step_matches_jax(act, task):
    n = 2 if task == "multihover" else 1
    B = 8
    cfg, jcfg = _cfgs(act, task, n)
    init = np.array([[0.0, 0.0, 0.1125], [0.3, 0.3, 0.1125]])[:n]
    rpys = np.zeros((n, 3))
    jp = jdrone.drone_params(jenums.DroneModel.CF2X, dtype=jnp.float32)
    p = drone.drone_params(DroneModel.CF2X, device="cpu")
    jreset = jrl.rl_reset(jcfg, init, rpys)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), jreset)
    jstep = jax.jit(jax.vmap(
        lambda s, a: jrl.autoreset_step(jcfg, jp, jreset, s, a)))
    reset = rlenv.rl_reset(cfg, init, rpys, 1, device="cpu")
    # two envs head for the bounds, so episodes end and reset in the run
    rng = np.random.default_rng(5)
    pos0 = np.asarray(jstate.core.phys.pos).copy()
    vel0 = np.zeros_like(pos0)
    pos0[1, 0, 0], vel0[1, 0, 0] = 1.6, 1.0
    pos0[2, 0, 2], vel0[2, 0, 2] = 1.7, 1.0
    jstate = jstate._replace(core=jstate.core._replace(
        phys=jstate.core.phys._replace(pos=jnp.asarray(pos0, jnp.float32),
                                       vel=jnp.asarray(vel0, jnp.float32))))
    state = rl_state_from_numpy(jstate, device="cpu")
    n_done = 0
    for i in range(20):
        a = rng.uniform(-1, 1, size=(B, n, cfg.act_size)).astype(F32)
        jstate, jobs, jrew, jterm, jtrunc = jstep(jstate, jnp.asarray(a))
        state, obs, rew, term, trunc = rlenv.autoreset_step(
            cfg, p, reset, state, torch.from_numpy(a))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-5)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        n_done += int((trunc | term).sum())
    assert n_done >= 2
    assert obs.shape == (B, n, cfg.obs_size)


def test_rl_step_final_obs_and_pid_types_reset():
    """The final obs of an ended episode; and the PID action types, which
    the port refused until it had the DSL PID controller, now reset with
    a zeroed controller state per drone (their steps are held against
    JAX in tests/test_torch_dslpid.py)."""
    cfg, _ = _cfgs(ActionType.RPM, "hover", 1)
    p = drone.drone_params(DroneModel.CF2X, device="cpu")
    reset = rlenv.rl_reset(cfg, INIT_XYZS, INIT_RPYS, 1, device="cpu")
    bad = rlenv.rl_reset(cfg, np.array([[5.0, 0.0, 0.5]]), INIT_RPYS, 2,
                         device="cpu")
    st, obs, final, *_ = rlenv.autoreset_step_with_final(
        cfg, p, reset, bad, torch.zeros((2, 1, 4)))
    assert final[:, 0, 0].gt(4.9).all() and obs[:, 0, 0].abs().lt(1e-6).all()
    for act in (ActionType.PID, ActionType.VEL, ActionType.ONE_D_PID):
        c, _ = _cfgs(act, "hover", 1)
        st = rlenv.rl_reset(c, INIT_XYZS, INIT_RPYS, device="cpu")
        for leaf in st.ctrl:
            assert leaf.shape == (1, 1, 3) and not leaf.any()


# ---- tests/test_rl.py:25-94, on the port -----------------------------------

PARAMS = drone.drone_params(DroneModel.CF2X, device="cpu")


def _cfg(act=ActionType.RPM, task="hover", n=1):
    return _cfgs(act, task, n)[0]


def _reset(cfg, xyz=INIT_XYZS, rpy=INIT_RPYS):
    return rlenv.rl_reset(cfg, xyz, rpy, 1, device="cpu")


def test_port_obs_contains_action_history():
    cfg = _cfg()
    state, obs, *_ = rlenv.rl_step(cfg, PARAMS, _reset(cfg),
                                   torch.full((1, 1, 4), 0.25))
    np.testing.assert_allclose(obs[0, 0, -4:].numpy(), 0.25, atol=1e-6)
    np.testing.assert_allclose(obs[0, 0, 12:16].numpy(), 0.0, atol=1e-6)


def test_port_hover_reward_formula():
    cfg = _cfg()
    r = float(rlenv.compute_reward(cfg, _reset(cfg))[0])
    err = np.linalg.norm([0, 0, 1 - 0.1125])
    assert abs(r - max(0, 2 - err ** 4)) < 1e-5


def test_port_truncation_on_tilt_and_bounds():
    cfg = _cfg()
    assert bool(rlenv.compute_truncated(
        cfg, _reset(cfg, xyz=np.array([[1.6, 0.0, 0.5]])))[0])
    assert bool(rlenv.compute_truncated(
        cfg, _reset(cfg, rpy=np.array([[0.5, 0.0, 0.0]])))[0])
    assert not bool(rlenv.compute_truncated(cfg, _reset(cfg))[0])


def test_port_multihover_reward_sums_drones():
    init = np.array([[0.0, 0.0, 0.1125], [0.3, 0.3, 0.1125]])
    cfg = _cfg(task="multihover", n=2)
    r = float(rlenv.compute_reward(cfg, _reset(cfg, init, np.zeros((2, 3))))[0])
    expected = max(0, 2 - 1.0 ** 4) + max(0, 2 - 0.5 ** 4)
    assert abs(r - expected) < 1e-5


def test_port_autoreset_restores_initial_state():
    cfg = _cfg()
    bad = _reset(cfg, xyz=np.array([[5.0, 0.0, 0.5]]))
    new_state, obs, reward, term, trunc = rlenv.autoreset_step(
        cfg, PARAMS, _reset(cfg), bad, torch.zeros((1, 1, 4)))
    assert bool(trunc[0])
    np.testing.assert_allclose(new_state.core.phys.pos[0].numpy(), INIT_XYZS,
                               atol=1e-6)
    np.testing.assert_allclose(obs[0, 0, :3].numpy(), INIT_XYZS[0],
                               atol=1e-6)


def test_port_one_d_rpm_symmetry():
    """ONE_D_RPM keeps the drone level (all motors equal) and climbs at
    a = 0.1 (thrust 1.01x weight)."""
    cfg = _cfg(act=ActionType.ONE_D_RPM)
    state = _reset(cfg)
    for _ in range(20):
        state, obs, *_ = rlenv.rl_step(cfg, PARAMS, state,
                                       torch.full((1, 1, 1), 0.1))
    np.testing.assert_allclose(state.core.phys.rpy[0, 0].numpy(), 0.0,
                               atol=1e-5)
    assert float(state.core.phys.pos[0, 0, 2]) > 0.125

"""Port: the DSL PID controller (control/dslpid.py) and the PID, VEL and
ONE_D_PID action types of envs/rl.py, against the JAX package on CPU.

* ``compute_control`` on 256 seeded drones (random poses, velocities,
  targets, yaw and velocity targets, controller states), both mixers:
  the state and errors at rtol 1e-5 / atol 1e-5, the rpm at atol 0.05
  (rpm ~ 1e4: the PWM sum of the thrust and the torques, which the
  attitude gains multiply by 2e4-7e4, carries each package's float32
  rounding of the Euler angles), ``one23d_interface`` at rtol 1e-6.
* ``rl_step`` per action type, 8 envs of 1 and 2 drones over 12 steps,
  each step from the JAX state (a closed loop would compare the
  attitude D-term's amplification of ulp differences): obs atol 1e-4,
  reward atol 1e-4, flags equal, the PID state atol 1e-4.
* tests/test_controllers.py:17's position-step tracking on the port in
  float64: within 3 cm of [0.2, -0.1, 0.8] after 2 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.control import dslpid as jpid
from gym_pybullet_adrp_tpu.envs import core as jcore
from gym_pybullet_adrp_tpu.envs import rl as jrl
from gym_pybullet_adrp_tpu.models import drone as jdrone
from gym_pybullet_adrp_tpu.utils import enums as jenums
from gym_pybullet_adrp_tpu_torch.control import dslpid
from gym_pybullet_adrp_tpu_torch.convert import rl_state_from_numpy
from gym_pybullet_adrp_tpu_torch.envs import core, rl as rlenv
from gym_pybullet_adrp_tpu_torch.models import drone
from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType, DroneModel

from _torch_port import tensor

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
F32 = np.float32


def _rand_quat(rng, n):
    q = rng.normal(size=(n, 4)) * np.array([0.2, 0.2, 0.6, 1.0])
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(F32)


@pytest.mark.parametrize("model", ["CF2X", "CF2P"])
def test_compute_control_matches_jax(model):
    rng = np.random.default_rng(7)
    n = 256
    x = {k: rng.uniform(-1, 1, (n, 3)).astype(F32)
         for k in ("pos", "vel", "tpos", "tvel", "rates")}
    x["tpos"] = x["pos"] + 0.5 * x["tpos"]
    x["quat"] = _rand_quat(rng, n)
    x["trpy"] = np.stack([np.zeros(n), np.zeros(n),
                          rng.uniform(-np.pi, np.pi, n)], -1).astype(F32)
    st = [rng.uniform(-0.3, 0.3, (n, 3)).astype(F32) for _ in range(3)]
    jm, pm = jenums.DroneModel[model], DroneModel[model]
    jp = jdrone.drone_params(jm, dtype=jnp.float32)
    pp = drone.drone_params(pm, device="cpu")
    dt = 1.0 / 48
    ref = jpid.compute_control(
        jp, jpid.PIDState(*map(jnp.asarray, st)), dt,
        *(jnp.asarray(x[k]) for k in ("pos", "quat", "vel", "tpos")),
        target_rpy=jnp.asarray(x["trpy"]), target_vel=jnp.asarray(x["tvel"]),
        target_rpy_rates=jnp.asarray(x["rates"]), model=jm)
    got = dslpid.compute_control(
        pp, dslpid.PIDState(*map(tensor, st)), dt,
        *(tensor(x[k]) for k in ("pos", "quat", "vel", "tpos")),
        target_rpy=tensor(x["trpy"]), target_vel=tensor(x["tvel"]),
        target_rpy_rates=tensor(x["rates"]), model=pm)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=0.05,
                               rtol=0)
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    thrust = rng.uniform(0.05, 0.2, (n, 4)).astype(F32)
    for d in (1, 2, 4):
        np.testing.assert_allclose(
            dslpid.one23d_interface(pp, tensor(thrust[:, :d])).numpy(),
            np.asarray(jpid.one23d_interface(jp, jnp.asarray(thrust[:, :d]))),
            rtol=1e-6)


@pytest.mark.parametrize("act,n", [(ActionType.PID, 1), (ActionType.VEL, 1),
                                   (ActionType.ONE_D_PID, 1),
                                   (ActionType.VEL, 2)],
                         ids=["pid", "vel", "one_d_pid", "vel-2drones"])
def test_rl_step_pid_types_match_jax(act, n):
    task = "multihover" if n > 1 else "hover"
    cfg = rlenv.RLConfig(aviary=core.AviaryConfig(ctrl_freq=30,
                                                  num_drones=n),
                         act_type=act, task=task)
    jcfg = jrl.RLConfig(aviary=jcore.AviaryConfig(ctrl_freq=30,
                                                  num_drones=n),
                        act_type=jenums.ActionType[act.name], task=task)
    init = np.array([[0.0, 0.0, 0.3], [0.3, 0.3, 0.3]])[:n]
    B = 8
    jp = jdrone.drone_params(jenums.DroneModel.CF2X, dtype=jnp.float32)
    pp = drone.drone_params(DroneModel.CF2X, device="cpu")
    js = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, (B,) + v.shape),
        jrl.rl_reset(jcfg, init, np.zeros((n, 3))))
    jstep = jax.jit(jax.vmap(lambda s, a: jrl.rl_step(jcfg, jp, s, a)))
    rng = np.random.default_rng(3)
    for i in range(12):
        a = rng.uniform(-1, 1, (B, n, cfg.act_size)).astype(F32)
        ps = rl_state_from_numpy(js, device="cpu")
        js, jobs, jrew, jterm, jtrunc = jstep(js, jnp.asarray(a))
        ps, obs, rew, term, trunc = rlenv.rl_step(cfg, pp, ps, tensor(a))
        tag = f"{act.name} step {i}"
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4,
                                   err_msg=tag)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-4,
                                   err_msg=tag)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        for g, r in zip(ps.ctrl, js.ctrl):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                       err_msg=tag)
    # the controller ran: finite obs, its attitude memory filled
    assert torch.isfinite(obs).all()
    assert ps.ctrl.last_rpy.abs().sum() > 0


def test_dslpid_tracks_position_step():
    """tests/test_controllers.py:17 on the port (float64)."""
    f64 = torch.float64
    params = drone.drone_params(DroneModel.CF2X, dtype=f64, device="cpu")
    cfg = core.AviaryConfig(ctrl_freq=48, pyb_freq=240)
    state = core.core_reset(cfg, np.array([[0.0, 0.0, 0.5]]),
                            np.zeros((1, 3)), 1, f64, "cpu")
    ctl = dslpid.init_state((1, 1), f64, "cpu")
    target = torch.tensor([[[0.2, -0.1, 0.8]]], dtype=f64)
    for _ in range(96):
        sv = core.state_vector(state)
        rpm, ctl, _, _ = dslpid.compute_control(
            params, ctl, cfg.ctrl_timestep, sv[..., 0:3], sv[..., 3:7],
            sv[..., 10:13], target)
        state = core.core_step(cfg, params, state, rpm)
    np.testing.assert_allclose(state.phys.pos[0, 0].numpy(),
                               [0.2, -0.1, 0.8], atol=0.03)

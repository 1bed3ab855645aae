"""Port: the plain race_window (K3) against the JAX package's Pallas
race_window (interpret mode), on CPU.

Inputs: mid-episode states of 128 envs x 2 drones on level1, flown by the
shipped level1 policy through the port's own env, with window statics
from the policy's action, optionally the poly7 planner on half of the
agents (random coefficients), and optionally an injected noise block.
All are float32 and handed to both sides.

Tolerances, per window of 20 ticks (XLA on CPU contracts multiply-adds
into FMAs and the port does not, so the two differ in the last bits;
the firmware's rate D-term multiplies such differences by ~500 per tick):
  pos/quat/vel            atol 1e-5     (measured <= 3.2e-6)
  body rates, rpy         atol 1e-3     (measured <= 2.6e-4)
  rpms                    rtol 3e-4     (measured <= 1.1e-4, ~2 rpm)
  accel biquad state      atol 1e-3     (measured <= 1.1e-4)
  gyro biquad state       atol 0.2 deg/s (measured <= 0.053)
  position/moment integrals atol 1e-5
  previous rates          atol 1e-3
  roll/pitch/yaw/thrust commands  atol 20, of ranges of +-32000 and
                          ~1.6e5 (measured <= 7.9)
  tick, last calls, tumble, error flag: equal
on the lanes whose tick gating does not depend on FMA contraction
(_torch_port.gating_stable); the chosen states have them all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.ops import pallas_race
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import make_row_env
from gym_pybullet_adrp_tpu_torch.ops import race_window as rw
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

from _torch_port import REPO, gating_stable

STEPS = (2, 14, 20)   # window starts whose gating is rounding-independent
ABS = [
    (list(range(0, 10)) + [24, 25, 26], 1e-5, "pos/quat/vel"),
    ([10, 11, 12, 21, 22, 23], 1e-3, "body rates/rpy"),
    (list(range(27, 33)), 1e-3, "accel biquad"),
    (list(range(33, 39)), 0.2, "gyro biquad"),
    (list(range(39, 45)), 1e-5, "integrals"),
    ([45, 46, 47, 48], 1e-3, "previous rates"),
    ([49, 50, 51, 52], 20.0, "commands"),
]
REL = [
    (list(range(13, 21)), 3e-4, "rpms"),
]
EXACT = [53, 54, 55, 56, 57]
NOISE_SPEC = (0.001, (-0.1, -0.1, -0.1), (0.1, 0.1, 0.1))


@pytest.fixture(scope="module")
def flown_states():
    """(S, W) numpy blocks at the STEPS window starts."""
    cfg = load_config("level1")
    spec = prace.RaceSpec.from_config(cfg, 2, RaceMode.COMPARE)
    env = make_row_env(spec, prace.track_from_config(cfg, 2), 128,
                       generator=torch.Generator().manual_seed(3))
    net = pck.load_policy(REPO / "results/level1_robust.msgpack")
    st = env.reset()
    obs = env.initial_obs(st)
    out = {}
    with torch.no_grad():
        for j in range(max(STEPS) + 1):
            act = torch.clamp(net(obs.reshape(256, -1))[0], -1, 1)
            act = act.reshape(128, 2, 4)
            if j in STEPS:
                W = env.build_W(st, env.action_rows(act))
                out[j] = (st.S.numpy().copy(), W.numpy().copy())
            st, obs, _, _ = env.step(st, act)
    return env, out


@pytest.fixture(scope="module")
def jax_window():
    fns = {}

    def run(S, W, noise_rows):
        key = noise_rows is not None
        if key not in fns:
            fns[key] = jax.jit(lambda S, W, n: pallas_race.race_window(
                3.16e-10, 7.94e-12, 0.0397, 0.0125, S, W, interpret=True,
                noise=NOISE_SPEC if n is not None else None, noise_rows=n))
        return np.asarray(fns[key](
            jnp.asarray(S), jnp.asarray(W),
            None if noise_rows is None else jnp.asarray(noise_rows)))

    return run


@pytest.mark.parametrize("noise", [False, True], ids=["calm", "noise"])
@pytest.mark.parametrize("planner", [False, True], ids=["hold", "planner"])
def test_window_matches_jax(flown_states, jax_window, planner, noise):
    env, states = flown_states
    rng = np.random.default_rng(10 * planner + noise)
    for j in STEPS:
        S, W = states[j]
        W = W.copy()
        if planner:
            plan = rng.random(S.shape[1:]) < 0.5
            W[16] = plan
            W[17] = S[53] * np.float32(0.002)
            W[18] = rng.uniform(1.0, 2.0, S.shape[1:])
            W[20:52] = rng.normal(0.0, 0.2, (32,) + S.shape[1:])
            W[20] += S[0]
            W[28] += S[1]
            W[36] += S[2]
        W = W.astype(np.float32)
        nz = None
        if noise:
            nz = np.concatenate([
                rng.uniform(-0.1, 0.1, (20, 3) + S.shape[1:]),
                rng.normal(0.0, 0.001, (20, 4) + S.shape[1:]),
            ], axis=1).astype(np.float32)
        ref = jax_window(S, W, nz)
        got = rw.race_window(
            env.kf, env.km, env.arm, env.ground_z, torch.from_numpy(S),
            torch.from_numpy(W),
            noise_rows=None if nz is None else torch.from_numpy(nz),
        ).numpy()
        assert got.shape == ref.shape == S.shape
        assert np.isfinite(got).all()
        stable = gating_stable(S)
        assert stable.all(), f"step {j}: gating depends on rounding"
        for chans, tol, name in ABS:
            err = np.abs(got[chans] - ref[chans]).max()
            assert err <= tol, f"step {j} {name}: {err} > {tol}"
        for chans, tol, name in REL:
            err = (np.abs(got[chans] - ref[chans])
                   / np.maximum(np.abs(ref[chans]), 1.0)).max()
            assert err <= tol, f"step {j} {name}: rel {err} > {tol}"
        np.testing.assert_array_equal(got[EXACT], ref[EXACT])


def test_window_noise_enters_dynamics(flown_states):
    """The injected block moves the state (wind and thrust noise are
    applied) and a zero block matches the noise-free branch except for
    the thrust round trip's rounding."""
    env, states = flown_states
    S, W = (torch.from_numpy(x) for x in states[14])
    calm = rw.race_window(env.kf, env.km, env.arm, env.ground_z, S, W)
    zero = rw.race_window(env.kf, env.km, env.arm, env.ground_z, S, W,
                          noise_rows=torch.zeros((20, 7) + S.shape[1:]))
    wind = torch.zeros((20, 7) + S.shape[1:])
    wind[:, 0] = 0.1
    windy = rw.race_window(env.kf, env.km, env.arm, env.ground_z, S, W,
                           noise_rows=wind)
    assert torch.allclose(zero[:13], calm[:13], atol=1e-3)
    assert (windy[7] - calm[7]).min() > 0.0   # +x wind speeds every agent

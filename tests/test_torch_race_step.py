"""Port: the plain fused race step (K4) and the row env against the JAX
package's Pallas race_step_fused and make_row_env (interpret mode), CPU.

Scenarios: level1 with one drone (reference drone-0 reward, per-tick
disturbances, randomized starts and inertia) and getting_started with two
drones in COMPETE (per-drone reward, drone-drone collisions, opponent
observation channels). Inputs are mid-episode states of 128 envs flown
through the port's env (the level1 policy, or a scripted gate chaser for
two drones), a few envs forced eliminated so the step's autoreset runs,
and injected actions, reset draws and noise block, all float32 and handed
to both sides. Telemetry is on.

Tolerances per step (XLA on CPU fuses multiply-adds, the port rounds
them separately; see tests/_torch_port.py): on gating-stable envs,
  S: as tests/test_torch_race_window.py
  R: rows 0-3 (gate, eliminated, finished, shaping gate) equal;
     targets/previous position/mass/inertia atol 1e-5
  OBS: positions and velocities atol 1e-5, angles and world rates atol
     1e-3, gate/obstacle poses, flags and gate id equal
  REW atol 1e-4; GG, OO, EP, DONE, INFO equal.
On the other envs the attitude loop fires on other ticks, and one step
still agrees to 2 cm in position (measured <= 9.5 mm).

The closed-loop check runs both make_row_envs for 24 steps, each step
from the port's state with the same actions and the JAX env's own draws
(captured from its call into race_step_fused): the two float roundings
drift apart by ~5 cm within 5 steps when each env is left to its own
state, so each step is compared from a shared state instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.envs import race as jrace
from gym_pybullet_adrp_tpu.envs import race_rl_rowfast as jrow
from gym_pybullet_adrp_tpu.ops import pallas_race_step as jprs
from gym_pybullet_adrp_tpu.utils.config import load_config as jload
from gym_pybullet_adrp_tpu.utils.enums import Physics as JPhysics
from gym_pybullet_adrp_tpu.utils.enums import RaceMode as JRaceMode
from gym_pybullet_adrp_tpu_torch.convert import (
    row_state_from_numpy, row_state_to_numpy,
)
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
    StepDraws, make_row_env,
)
from gym_pybullet_adrp_tpu_torch.ops import race_step as rs
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

from _torch_port import REPO, env_stable, gating_stable

SCENARIOS = {
    "level1-1drone": ("level1", 1, False),
    "gs-2drone-compete": ("getting_started", 2, True),
}
NOISE_SPEC = (0.001, (-0.1, -0.1, -0.1), (0.1, 0.1, 0.1))
S_ABS = [
    (list(range(0, 10)) + [24, 25, 26], 1e-5),
    ([10, 11, 12, 21, 22, 23, 45, 46, 47, 48], 1e-3),
    (list(range(27, 33)), 1e-3),
    (list(range(33, 39)), 0.2),
    (list(range(39, 45)), 1e-5),
    ([49, 50, 51, 52], 20.0),
]


def _port_env(name, fused=True):
    cfg_name, N, per_drone = SCENARIOS[name]
    cfg = load_config(cfg_name)
    mode = RaceMode.COMPETE if N > 1 else RaceMode.COMPARE
    spec = prace.RaceSpec.from_config(cfg, N, mode)
    return make_row_env(spec, prace.track_from_config(cfg, N), 128,
                        generator=torch.Generator().manual_seed(11),
                        telemetry=True, per_drone_reward=per_drone,
                        fused=fused)


def _jax_env(name):
    cfg_name, N, per_drone = SCENARIOS[name]
    cfg = jload(cfg_name)
    mode = JRaceMode.COMPETE if N > 1 else JRaceMode.COMPARE
    spec = jrace.RaceSpec.from_config(cfg, N, mode, JPhysics.PYB)
    track = jrace.track_from_config(cfg, N)
    return jrow.make_row_env(spec, track, 128, interpret=True,
                             per_drone_reward=per_drone, telemetry=True)


def _policy_actions(env, net, obs, rng):
    """Actions that fly the track: the level1 policy for one drone, a
    proportional chase of the current gate for several."""
    if env.N == 1:
        with torch.no_grad():
            return torch.clamp(net(obs)[0], -1.0, 1.0)
    G, O = env.G, env.O
    gate_id = obs[..., 12 + 5 * G + 4 * O].long().clamp(max=G - 1)
    gates = torch.from_numpy(env.gates[:, :3])
    tgt = gates[gate_id]                                  # (B, N, 3)
    a = torch.clamp(0.5 * (tgt - obs[..., :3]), -0.5, 0.5)
    a = a + torch.from_numpy(rng.normal(0.0, 0.05, a.shape)).float()
    return torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)


@pytest.fixture(scope="module", params=list(SCENARIOS))
def flown(request):
    """(env, [(state, action, draws)] at 3 consecutive mid-episode steps)."""
    env = _port_env(request.param)
    net = pck.load_policy(REPO / "results/level1_robust.msgpack")
    rng = np.random.default_rng(2)
    st = env.reset()
    obs = env.initial_obs(st)
    cases = []
    for j in range(16):
        act = _policy_actions(env, net, obs, rng)
        draws = env.step_draws()
        if j >= 13:
            cases.append((st, act, draws))
        st, obs, _, _, _ = env.step(st, act, draws)
    return request.param, env, cases


def _jax_step_fn(env):
    noise = NOISE_SPEC if env.spec.disturbances else None

    def f(S, A, R, GG, OO, EP, RST, RSTG, RSTO, nr):
        return jprs.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, S, A, R, GG, OO, EP,
            RST, RSTG, RSTO, n_ticks=env.n_ticks, dt=env.dt,
            spec_tail=env.spec_tail, interpret=True, noise=noise,
            noise_rows=nr, telemetry=True)

    return jax.jit(f)


def _check_step(env, S_in, got, ref, tag):
    """Compare K4 outputs (numpy tuples) on gating-stable envs."""
    N, Tb, G, O = env.N, env.Tb, env.G, env.O
    envs = env_stable(S_in, N)                     # (Tb, 128)
    assert envs.mean() >= 0.3, f"{tag}: only {envs.mean():.2f} stable"
    agents = np.concatenate([envs] * N, axis=0)    # (T, 128)
    S, R, GG, OO, EP, OBS, REW, DONE, INFO = got
    rS, rR, rGG, rOO, rEP, rOBS, rREW, rDONE, rINFO = ref
    for x in got:
        assert np.isfinite(x).all(), tag
    for chans, tol in S_ABS:
        err = np.abs(S[chans][:, agents] - rS[chans][:, agents]).max()
        assert err <= tol, f"{tag} S {chans}: {err} > {tol}"
    rel = (np.abs(S[13:21] - rS[13:21]) / np.maximum(np.abs(rS[13:21]), 1))
    assert rel[:, agents].max() <= 3e-4, f"{tag} rpms"
    np.testing.assert_array_equal(S[53:58][:, agents], rS[53:58][:, agents])
    np.testing.assert_array_equal(R[:4][:, agents], rR[:4][:, agents],
                                  err_msg=tag)
    assert np.abs(R[4:] - rR[4:])[:, agents].max() <= 1e-5, tag
    kin_abs = [0, 1, 2, 6, 7, 8]
    kin_ang = [3, 4, 5, 9, 10, 11]
    assert np.abs(OBS[kin_abs] - rOBS[kin_abs])[:, agents].max() <= 1e-5
    assert np.abs(OBS[kin_ang] - rOBS[kin_ang])[:, agents].max() <= 1e-3
    track = slice(12, 12 + 5 * G + 4 * O + 1)
    np.testing.assert_array_equal(OBS[track][:, agents],
                                  rOBS[track][:, agents], err_msg=tag)
    if OBS.shape[0] > track.stop:                  # opponent channels
        opp = OBS[track.stop:] - rOBS[track.stop:]
        assert np.abs(opp[:, agents]).max() <= 1e-3, tag
    assert np.abs(REW - rREW)[agents].max() <= 1e-4, tag
    for a, b, name in ((GG, rGG, "GG"), (OO, rOO, "OO"), (EP, rEP, "EP"),
                       (DONE, rDONE, "DONE")):
        np.testing.assert_array_equal(a[..., envs], b[..., envs],
                                      err_msg=f"{tag} {name}")
    np.testing.assert_array_equal(INFO[:, agents], rINFO[:, agents],
                                  err_msg=f"{tag} INFO")
    # every env, stable or not, stays close in position
    assert np.abs(S[:3] - rS[:3]).max() <= 2e-2, tag


def test_step_matches_jax(flown):
    name, env, cases = flown
    jstep = _jax_step_fn(env)
    n_reset = 0
    for i, (st, act, draws) in enumerate(cases):
        R = st.R.clone()
        if i == 1:
            R[1, :, :8] = 1.0          # eliminate 8 envs: autoreset runs
        A = env.action_rows(act)
        args = [st.S, A, R, st.GG, st.OO, st.EP, draws.RST, draws.RSTG,
                draws.RSTO]
        nr = draws.noise_rows
        got = rs.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, *args,
            n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
            noise_rows=nr, telemetry=True)
        ref = jstep(*[jnp.asarray(x.numpy()) for x in args],
                    None if nr is None else jnp.asarray(nr.numpy()))
        got = [x.numpy() for x in got]
        ref = [np.asarray(x) for x in ref]
        n_reset += int(ref[7].sum())
        _check_step(env, st.S.numpy(), got, ref, f"{name} step {i}")
    assert n_reset >= 8


def test_fused_matches_unfused(flown):
    """race_window + the plain tail == the fused step, bit for bit, on
    the same draws (the port's two step paths)."""
    name, env, cases = flown
    env_u = _port_env(name, fused=False)
    for st, act, draws in cases:
        out_f = env.step(st, act, draws)
        out_u = env_u.step(st, act, draws)
        for a, b in zip(out_f[0], out_u[0]):
            assert torch.equal(a, b), name
        for a, b in zip(out_f[1:4], out_u[1:4]):
            assert torch.equal(a, b), name
        for k in out_f[4]:
            assert torch.equal(out_f[4][k], out_u[4][k]), (name, k)


def test_closed_loop_matches_jax_env(flown):
    """24 steps of both make_row_envs: per step, each env steps from the
    port's state with the same actions and the JAX env's draws."""
    name, env, _ = flown
    jenv_reset, jenv_step = _jax_env(name)
    captured = {}

    def capture(*a, **k):
        captured["draws"] = (a[10], a[11], a[12], k.get("noise_rows"))
        return orig(*a, **k)

    orig = jprs.race_step_fused
    jprs.race_step_fused = capture
    try:
        @jax.jit
        def jstep(st, act, key):
            return jenv_step(st, act, key), captured["draws"]

        jst = jenv_reset(jax.random.PRNGKey(4))
        st = row_state_from_numpy(*[np.asarray(x) for x in jst])
        rng = np.random.default_rng(5)
        shape = (128, env.N, 4) if env.N > 1 else (128, 4)
        n_stable = 0
        for i in range(24):
            a = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
            a[..., 2] += 0.3
            jst = jrow.RowRaceState(*[jnp.asarray(x)
                                      for x in row_state_to_numpy(st)])
            (jst, jobs, jrew, jdone, jinfo), d = jstep(jst, jnp.asarray(a),
                                                      jax.random.PRNGKey(i))
            draws = StepDraws(
                None if d[3] is None
                else torch.from_numpy(np.array(d[3], np.float32)),
                *[torch.from_numpy(np.array(x, np.float32))
                  for x in d[:3]])
            S_in = st.S.numpy()
            st, obs, rew, done, info = env.step(st, torch.from_numpy(a),
                                                draws)
            stable = gating_stable(S_in)
            if env.N > 1:
                stable = stable.reshape(env.N, -1).T       # (B, N)
            else:
                stable = stable.reshape(-1)
            dpos = np.abs(obs.numpy()[..., :3] - np.asarray(jobs)[..., :3])
            if stable.any():
                n_stable += 1
                assert dpos[stable].max() <= 1e-4, (name, i)
            assert dpos.max() <= 2e-2, (name, i)
            for k in ("current_gate", "eliminated", "finished"):
                np.testing.assert_array_equal(
                    info[k].numpy()[stable], np.asarray(jinfo[k])[stable],
                    err_msg=f"{name} step {i} {k}")
        assert n_stable >= 9, n_stable
    finally:
        jprs.race_step_fused = orig

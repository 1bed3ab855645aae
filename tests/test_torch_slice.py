"""Port: the whole slice (a shipped policy flying the row env through the
fused step, eval_race's rollout and metrics) against the JAX package, on
CPU, and the package's import hygiene.

Per-step check: 20 steps of the port's evaluation rollout of
agents/fulltrack_policy.msgpack on getting_started (deterministic resets,
mean actions); at every step the JAX policy + row env (interpret mode)
steps from the port's state and observation. On envs whose tick gating
does not depend on FMA contraction (tests/_torch_port.py) positions agree
to 1e-4 and the telemetry rows are equal; everywhere to 2 cm. Left to
their own states, XLA-on-CPU's fused multiply-adds and the port's
separately rounded arithmetic drift ~5 cm apart within five steps and
the JAX run loses the track (0 of 128 envs pass a gate on CPU), so the
closed loop is pinned on the port alone: it reproduces the JAX package's
published TPU result for this policy, 128 of 128 envs through all four
gates with a 2.84 s lap.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_adrp_tpu.envs import race as jrace
from gym_pybullet_adrp_tpu.envs import race_rl_rowfast as jrow
from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu.rl import checkpoint as jck
from gym_pybullet_adrp_tpu.utils.config import load_config as jload
from gym_pybullet_adrp_tpu.utils.enums import Physics as JPhysics
from gym_pybullet_adrp_tpu.utils.enums import RaceMode as JRaceMode
from gym_pybullet_adrp_tpu_torch import eval_race
from gym_pybullet_adrp_tpu_torch.convert import row_state_to_numpy
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck

from _torch_port import REPO, gating_stable

POLICY = REPO / "agents/fulltrack_policy.msgpack"


def test_slice_matches_jax_per_step():
    cfg = jload("getting_started")
    spec = jrace.RaceSpec.from_config(cfg, 1, JRaceMode.COMPARE,
                                      JPhysics.PYB)
    track = jrace.track_from_config(cfg, 1)
    jreset, jstep_env = jrow.make_row_env(
        spec, track, 128, interpret=True, per_drone_reward=True,
        telemetry=True)
    fnet = FlaxAC(act_dim=4)
    params = jck.load_policy(
        str(POLICY), fnet.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, spec.obs_size), jnp.float32)))

    @jax.jit
    def jstep(st, obs):
        mean, _, _ = fnet.apply(params, obs)
        return jstep_env(st, jnp.clip(mean, -1.0, 1.0),
                         jax.random.PRNGKey(0))

    env = eval_race.make_eval_env("getting_started", 128, "cpu")
    net = pck.load_policy(POLICY, device="cpu")
    st = env.reset()
    obs = env.initial_obs(st)
    # deterministic resets: both packages start from the same blocks
    jst0 = jreset(jax.random.PRNGKey(0))
    for a, b in zip(row_state_to_numpy(st), jst0):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(obs.numpy(),
                                  np.asarray(jreset.initial_obs(jst0)))
    n_stable = 0
    for i in range(20):
        jst = jrow.RowRaceState(*[jnp.asarray(x)
                                  for x in row_state_to_numpy(st)])
        _, jobs, _, jdone, jinfo = jstep(jst, jnp.asarray(obs.numpy()))
        S_in = st.S.numpy()
        cg, fin, el, done, st, obs = eval_race.rollout(net, env, 1,
                                                       state=st, obs=obs)
        stable = gating_stable(S_in).reshape(-1)
        dpos = np.abs(obs.numpy()[:, :3] - np.asarray(jobs)[:, :3])
        assert np.isfinite(obs.numpy()).all()
        assert dpos.max() <= 2e-2, (i, dpos.max())
        if stable.any():
            n_stable += 1
            assert dpos[stable].max() <= 1e-4, (i, dpos[stable].max())
            for got, k in ((cg, "current_gate"), (fin, "finished"),
                           (el, "eliminated")):
                np.testing.assert_array_equal(
                    got[0, :, 0].numpy()[stable],
                    np.asarray(jinfo[k])[stable], err_msg=f"{i} {k}")
            np.testing.assert_array_equal(done[0].numpy()[stable],
                                          np.asarray(jdone)[stable])
    assert n_stable >= 5


def test_slice_reproduces_published_lap():
    """The port flies the full-track policy through all 4 gates in every
    env with the 2.84 s lap the JAX package reports from the TPU."""
    env = eval_race.make_eval_env("getting_started", 128, "cpu")
    net = pck.load_policy(POLICY, device="cpu")
    cgs, fins, els, dones, _, _ = eval_race.rollout(net, env, 75)
    m = eval_race.race_metrics(cgs.numpy(), fins.numpy(), els.numpy(),
                               dones.numpy(), env.G, env.n_ticks, 500)
    assert m["completion_rate"] == 1.0, m
    assert m["gates_hist"] == {0: 0, 1: 0, 2: 0, 3: 0, 4: 128}, m
    assert abs(m["mean_lap_time"] - 2.84) < 1e-9, m


def test_package_imports_no_jax():
    """Importing every module of the port, the trainer, the learner and
    the hover env, kernels and calibration included, leaves jax, flax,
    yaml, gymnasium, msgpack, PIL and the JAX package unimported (the
    card's machine has none of them)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import gym_pybullet_adrp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax', 'yaml', 'gymnasium', "
        "'msgpack', 'PIL', 'gym_pybullet_adrp_tpu') if m in sys.modules]\n"
        "new = ['gym_pybullet_adrp_tpu_torch.' + m for m in ("
        "'train_race', 'rl.ppo', 'ops.race_rollout', 'envs.fast_hover', "
        "'envs.rl', 'ops.hover_step', 'ops.hover_variants', "
        "'op_calibrate', 'control.dslpid', 'envs.aviary', 'envs.vector', "
        "'envs.race_vector', 'envs.race', 'utils.utils', 'agents.base', "
        "'agents.hardcoded', 'agents.hardcoded_twogates', 'agents.hover', "
        "'agents.rl_agent', 'agents.rl_fulltrack', 'agents.rl_twogates', "
        "'sim', 'rl.checkpoint', 'ops.render', 'models.urdf', "
        "'eval_race_rgb', 'utils.rendering', 'envs.race_rl', "
        "'models.policy', 'convert')]\n"
        "missing = [m for m in new if m not in sys.modules]\n"
        "print('LOADED', bad, 'MISSING', missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors."""
    from gym_pybullet_adrp_tpu_torch.ops import (
        race_rollout, race_step, race_window,
    )

    S = torch.zeros((58, 1, 128), device="meta")
    W = torch.zeros((57, 1, 128), device="meta")
    with pytest.raises(ValueError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125, S, W)
    for policy_pack in (None, torch.zeros(8, device="meta")):
        with pytest.raises(ValueError):
            race_step.race_step_fused(
                0, 0, 0, 0, S, None, None, None, None, None, None, None,
                None, n_ticks=20, dt=0.002, spec_tail=None,
                policy_pack=policy_pack)
        with pytest.raises(ValueError):
            race_rollout.race_rollout(
                0, 0, 0, 0, S, None, None, None, None, None, None, None,
                None, n_ticks=20, dt=0.002, spec_tail=None,
                policy_pack=policy_pack)


@pytest.mark.slow
def test_level1_policy_floor_on_cpu():
    """The noise-hardened level1 artifact on the port's CPU path, at the
    reference's CPU pin (tests/test_learned_racing.py:107-136: the JAX
    package measures 39.8% on its CPU backend, 96-100% on the TPU; the
    port measured 96.1%)."""
    out = eval_race.evaluate(str(REPO / "results/level1_robust.msgpack"),
                             "level1", 128, device="cpu")
    assert out["completion_rate"] >= 0.35, out
    assert out["mean_lap_time"] is not None and out["mean_lap_time"] < 6.0, \
        out
    assert out["mean_gates"] >= 1.2, out

"""Port: the CUDA race kernels against their plain PyTorch versions, and
the K-step rollout kernel against K launches of the step kernel, on the
card. Marked ``cuda``: they skip where no CUDA device is present.

This file imports no JAX, so it also runs on a machine without it:
  python -m pytest tests/test_torch_cuda.py --noconftest -q

Both sides round every + - * / and sqrt alike (kernels built with
-fmad=false), so the outputs are expected equal; the stated tolerance
(atol 1e-4 on S, 1e-3 on OBS/REW) leaves room for the last bit of a
libm sinf/cosf; the policy's ACT/VAL/LOGP (built from tanhf/expf) take
atol 1e-5. race_rollout and race_step run the same device function, so
K5 and K launches of K4 are held equal bit for bit.
"""

import pytest
import torch

from gym_pybullet_adrp_tpu_torch import eval_race
from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
    RowRaceState, pack_policy_params,
)
from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic
from gym_pybullet_adrp_tpu_torch.ops import (
    race_rollout, race_step, race_window,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("noise", [False, True], ids=["calm", "noise"])
def test_race_window_kernel_matches_plain(dev, noise):
    env = eval_race.make_eval_env("level1", 256, dev, seed=1, n_drones=2)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((256, 2, 4), generator=gen, device=dev) * 2 - 1
    W = env.build_W(st, env.action_rows(a)).contiguous()
    W[16] = 1.0                                    # planner branch
    W[18] = 2.0
    W[20:52] = torch.randn((32,) + W.shape[1:], generator=gen, device=dev)
    nz = env.step_draws().noise_rows if noise else None
    before = race_window.race_window.launches
    got = race_window.race_window(env.kf, env.km, env.arm, env.ground_z,
                                  st.S, W, noise_rows=nz)
    ref = race_window.race_window_plain(env.kf, env.km, env.arm,
                                        env.ground_z, st.S, W, noise_rows=nz)
    torch.cuda.synchronize()
    assert race_window.race_window.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("cfg,n_drones", [("level1", 1),
                                          ("getting_started", 2)])
def test_race_step_kernel_matches_plain(dev, cfg, n_drones):
    env = eval_race.make_eval_env(cfg, 256, dev, seed=2, n_drones=n_drones)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(12):
        shape = (256, n_drones, 4) if n_drones > 1 else (256, 4)
        a = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        d = env.step_draws()
        args = (env.kf, env.km, env.arm, env.ground_z, st.S,
                env.action_rows(a), st.R, st.GG, st.OO, st.EP, d.RST,
                d.RSTG, d.RSTO)
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows=d.noise_rows, telemetry=True)
        got = race_step.race_step_fused(*args, **kw)
        ref = race_step.race_step_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=1e-6)
        for j in (5, 6):
            torch.testing.assert_close(got[j], ref[j], atol=1e-3, rtol=0)
        for j in (1, 2, 3, 4, 7, 8):
            torch.testing.assert_close(got[j], ref[j], atol=1e-4, rtol=0)
        st = st._replace(S=ref[0], R=ref[1], GG=ref[2], OO=ref[3],
                         EP=ref[4])


def test_wrappers_validate_inputs(dev):
    S = torch.zeros((58, 1, 128), device=dev)
    W = torch.zeros((57, 1, 128), device=dev)
    with pytest.raises(TypeError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125,
                                S.double(), W)
    with pytest.raises(ValueError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125, S,
                                W[:, :, :64])
    with pytest.raises(ValueError):
        race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125, S,
                                W.cpu())


def _policy(env, hidden=(64, 64)):
    net = ActorCritic(env.obs_size, 4, hidden,
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        net.log_std.fill_(-1.0)
    return pack_policy_params(net.to(env.device))


@pytest.mark.parametrize("cfg,n_drones,hidden", [
    ("getting_started", 1, (64, 64)), ("twogates", 2, (64, 64)),
    ("level1", 1, (256, 128))])
def test_policy_option_matches_plain(dev, cfg, n_drones, hidden):
    env = eval_race.make_eval_env(cfg, 256, dev, seed=4, n_drones=n_drones)
    pack = _policy(env, hidden)
    st = env.reset()
    obs = env.initial_obs_rows(st)
    gen = torch.Generator(device=dev).manual_seed(2)
    before = race_step.race_step_fused.policy_launches
    for _ in range(6):
        actn = torch.randn((4, env.T, 128), generator=gen, device=dev)
        d = env.step_draws()
        args = (env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R,
                st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO)
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows=d.noise_rows, telemetry=True, policy_pack=pack,
                  obs_rows=obs, actn=actn, policy_hidden=hidden)
        got = race_step.race_step_fused(*args, **kw)
        ref = race_step.race_step_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        for j in (9, 10, 11):                       # ACT, LOGP, VAL
            torch.testing.assert_close(got[j], ref[j], atol=1e-5, rtol=0)
        torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=1e-6)
        for j in (5, 6):
            torch.testing.assert_close(got[j], ref[j], atol=1e-3, rtol=0)
        for j in (1, 2, 3, 4, 7, 8):
            torch.testing.assert_close(got[j], ref[j], atol=1e-4, rtol=0)
        st, obs = RowRaceState(*ref[:5]), ref[5]
    assert race_step.race_step_fused.policy_launches == before + 6


@pytest.mark.parametrize("mode", ["actions", "policy"])
def test_rollout_kernel_equals_step_launches(dev, mode):
    """One race_rollout launch of K=8 steps == 8 race_step launches, bit
    for bit (level2: randomized draws and disturbances; policy mode:
    two COMPETE drones)."""
    K = 8
    cfg, n = ("level2", 1) if mode == "actions" else ("twogates", 2)
    env = eval_race.make_eval_env(cfg, 256, dev, seed=6, n_drones=n)
    st = env.reset()
    obs = env.initial_obs_rows(st)
    gen = torch.Generator(device=dev).manual_seed(5)
    seq = torch.randn((K, 4, env.T, 128), generator=gen, device=dev)
    pack = _policy(env) if mode == "policy" else None
    d = env.stacked_draws(K)
    kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
              telemetry=True)
    pol = ({} if pack is None else
           dict(policy_pack=pack, obs_rows=obs, actn_seq=seq))
    before = race_rollout.race_rollout.launches
    got = race_rollout.race_rollout(
        env.kf, env.km, env.arm, env.ground_z, st.S,
        None if pack is not None else seq.clamp(-1, 1), st.R, st.GG, st.OO,
        st.EP, d.RST, d.RSTG, d.RSTO, noise_rows_seq=d.noise_rows, **pol,
        **kw)
    assert race_rollout.race_rollout.launches == before + 1
    outs = []
    for k in range(K):
        at = (lambda x: x[k if x.shape[0] > 1 else 0])
        pk = ({} if pack is None else
              dict(policy_pack=pack, obs_rows=obs, actn=seq[k]))
        o = race_step.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, st.S,
            None if pack is not None else seq[k].clamp(-1, 1), st.R, st.GG,
            st.OO, st.EP, at(d.RST), at(d.RSTG), at(d.RSTO),
            noise_rows=None if d.noise_rows is None else d.noise_rows[k],
            **pk, **kw)
        st, obs = RowRaceState(*o[:5]), o[5]
        outs.append(o)
    torch.cuda.synchronize()
    for j, x in enumerate(st):
        assert torch.equal(got[j], x), j
    order = [6, 7, 5, 8] + ([9, 10, 11] if pack is not None else [])
    for g, j in zip(got[5:], order):    # REW, DONE, OBS, INFO[, policy]
        assert torch.equal(g, torch.stack([o[j] for o in outs])), j

"""Port: the CUDA kernels against their plain PyTorch versions (the race
kernels, then the hover kernels and op chains), and the K-step race
rollout kernel against K launches of the step kernel, on the card.
Marked ``cuda``: they skip where no CUDA device is present.

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


# ---- the hover kernels (K1, K2, K7, K8) and the op chains (K6) -------------
# Both sides round every + - * / and sqrt alike; K1 and the exact
# integrator also call sinf/cosf, which may differ from PyTorch's CUDA
# sin/cos in the last bit: atol 1e-6 on the state, 1e-5 on the body rates
# and 1e-4 on the reward sums. The small-angle rollout (K2's default, K8)
# has no libm call and is held equal bit for bit; so are K7/K8 against the
# K2 instantiations they equal. The op chains: bit for bit for the correctly
# rounded ops, rtol 1e-5 for the libm ones.

from gym_pybullet_adrp_tpu_torch import op_calibrate  # noqa: E402
from gym_pybullet_adrp_tpu_torch.envs import fast_hover  # noqa: E402
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params  # noqa: E402
from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs  # noqa: E402
from gym_pybullet_adrp_tpu_torch.ops import hover_variants as hv  # noqa: E402
from gym_pybullet_adrp_tpu_torch.ops import quat as quat_ops  # noqa: E402


def _hover_state(dev, n_envs=1024, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    P = drone_params(device=dev)
    pos = u(-1, 1, n_envs, 3) + torch.tensor([0.0, 0.0, 1.5], device=dev)
    quat = quat_ops.from_euler_xyz(u(-0.3, 0.3, n_envs, 3))
    packed = hs.pack_state(pos, quat, u(-1, 1, n_envs, 3),
                           u(-2, 2, n_envs, 3))
    packed[2, 0] = 0.02                      # 128 envs in ground contact
    packed[9, 0] = -1.0
    rpm = (u(0.9, 1.1, 4, n_envs // 128, 128) * P.hover_rpm).contiguous()
    rpm[:, 0] = 0.0
    return P, packed, rpm, gen


def test_hover_step_kernel_matches_plain(dev):
    P, packed, rpm, _ = _hover_state(dev)
    before = hs.ctrl_step_packed.launches
    got = hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240)
    ref = hs.ctrl_step_packed_plain(P, packed, rpm, 8, 1 / 240)
    torch.cuda.synchronize()
    assert hs.ctrl_step_packed.launches == before + 1
    torch.testing.assert_close(got[:10], ref[:10], atol=1e-6, rtol=0)
    torch.testing.assert_close(got[10:], ref[10:], atol=1e-5, rtol=0)
    assert (got[2, 0] == 0.0125).all()


@pytest.mark.parametrize("smallangle", [True, False],
                         ids=["smallangle", "exact"])
@pytest.mark.parametrize("mode", ["injected", "random"])
def test_hover_rollout_kernel_matches_plain(dev, smallangle, mode):
    _, _, _, gen = _hover_state(dev)
    P = drone_params(device=dev)
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 1024, device=dev).packed
    acts = ((torch.rand((64, 4, 8, 128), generator=gen, device=dev) - 0.5)
            * 0.1) if mode == "injected" else None
    before = hs.hover_rollout.launches
    got = hs.hover_rollout(P, st, 21, 64, smallangle=smallangle,
                           actions=acts, count_resets=True)
    ref = hs.hover_rollout_plain(P, st, 21, 64, smallangle=smallangle,
                                 actions=acts, count_resets=True)
    torch.cuda.synchronize()
    assert hs.hover_rollout.launches == before + 1
    if smallangle:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(got[0][:10], ref[0][:10], atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(got[0][10:], ref[0][10:], atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("mode", ["injected", "random"])
def test_variants_equal_rollout_instantiations(dev, mode):
    P, _, _, gen = _hover_state(dev)
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 1024, device=dev).packed
    acts = ((torch.rand((32, 4, 8, 128), generator=gen, device=dev) - 0.5)
            * 0.1) if mode == "injected" else None
    pairs = [(hv.hover_rollout_v2(P, st, 3, 32, exact_sqrt=True,
                                  actions=acts),
              hs.hover_rollout(P, st, 3, 32, smallangle=False, actions=acts)),
             (hv.hover_rollout_v3(P, st, 3, 32, actions=acts),
              hs.hover_rollout(P, st, 3, 32, actions=acts))]
    for a, b in pairs:
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("variant", ["v2", "v2_exact_sqrt", "v3"])
@pytest.mark.parametrize("mode", ["injected", "random"])
def test_variant_kernels_match_plain(dev, variant, mode):
    _, _, _, gen = _hover_state(dev)
    P = drone_params(device=dev)
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 1024, device=dev).packed
    acts = ((torch.rand((32, 4, 8, 128), generator=gen, device=dev) - 0.5)
            * 0.1) if mode == "injected" else None
    kw = dict(actions=acts, count_resets=True)
    if variant == "v3":
        fn, before = hv.hover_rollout_v3, hv.hover_rollout_v3.launches
        got = fn(P, st, 4, 32, **kw)
        ref = hv.hover_rollout_v3_plain(P, st, 4, 32, **kw)
    else:
        kw["exact_sqrt"] = variant == "v2_exact_sqrt"
        fn, before = hv.hover_rollout_v2, hv.hover_rollout_v2.launches
        got = fn(P, st, 4, 32, **kw)
        ref = hv.hover_rollout_v2_plain(P, st, 4, 32, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if variant == "v3":
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(got[0][:10], ref[0][:10], atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(got[0][10:], ref[0][10:], atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("op", list(op_calibrate.OPS))
def test_op_chain_kernel_matches_plain(dev, op):
    x = 0.3 + 0.9 * torch.rand((64, 128), device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(1))
    before = op_calibrate.op_chain.launches
    got = op_calibrate.op_chain(op, x, 2)
    ref = op_calibrate.op_chain_plain(op, x, 2)
    torch.cuda.synchronize()
    assert op_calibrate.op_chain.launches == before + 1
    if op in ("fma", "mul", "add", "max", "div", "sqrt"):
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0,
                                   equal_nan=True)


def test_hover_wrappers_validate_inputs(dev):
    P = drone_params(device=dev)
    st = torch.zeros((13, 1, 128), device=dev)
    rpm = torch.zeros((4, 1, 128), device=dev)
    for args in ((st.double(), rpm), (st[:, :, :64], rpm), (st, rpm.cpu()),
                 (st, rpm[:3])):
        with pytest.raises((TypeError, ValueError)):
            hs.ctrl_step_packed(P, *args, 8, 1 / 240)
    with pytest.raises(TypeError):
        hs.hover_rollout(P, st.double(), 0, 4)
    with pytest.raises(ValueError):
        hs.hover_rollout(P, st, 0, 4, actions=torch.zeros((3, 4, 1, 128),
                                                          device=dev))
    with pytest.raises(ValueError):
        hv.hover_rollout_v2(P, st, 0, 4, actions=torch.zeros(
            (4, 4, 1, 128)))
    with pytest.raises(ValueError):
        hv.hover_rollout_v3(P, st[:, :, :64], 0, 4)
    # <smallangle, near_sqrt> is not built: the launch reports an error
    with pytest.raises(RuntimeError, match="invalid argument"):
        hs.launch_rollout("hover_rollout", hs.hover_consts(P), st, 0, 4,
                          True, True, None, False)
    with pytest.raises(TypeError):
        op_calibrate.op_chain("sin", torch.zeros((8, 128), device=dev,
                                                 dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        op_calibrate.op_chain("sin", torch.zeros((8, 64), device=dev), 2)

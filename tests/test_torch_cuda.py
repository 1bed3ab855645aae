"""Port: the CUDA kernels against their plain PyTorch versions (the race
kernels, then the hover kernels and op chains), and the K-step race
rollout kernel against K launches of the step kernel, on the card.
Marked ``cuda``: they skip where no CUDA device is present.

This file imports no JAX, so it also runs on a machine without it:
  python -m pytest tests/test_torch_cuda.py --noconftest -q

Both sides round every + - * / and sqrt alike (kernels built with
-fmad=false), and the race step's libm calls (cosf/sinf) give the bits
PyTorch's CUDA cos/sin give, so K4 with and without the policy is held
equal to its plain version bit for bit, every output, whatever the lane
group that runs an agent's window (race_step.cuh); the window kernel K3
at level1's 256 x 2 is held with atol 1e-4 on S (its planner's per-tick
cosf/sinf), and bit for bit on every lane group at the general
trainer's, level1's and 65536 agents. K5 runs
the same tile step as K4, so K5 and K launches of K4 are held equal bit
for bit.

The pixels path has no kernel of the port: the renderer on the card is
held against itself on the CPU (seg equal in every pixel, depth 1e-5
relative), and the shipped pixel policies' heads on the card (cuDNN, TF32
off) within 1e-5 of the CPU's.
"""

from pathlib import Path

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
REPO = Path(__file__).resolve().parent.parent


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


@pytest.mark.parametrize("lanes", [None, 1, 4], ids=["picked", "L1", "L4"])
@pytest.mark.parametrize("cfg,n_envs,n_drones", [
    ("twogates", 4096, 1), ("level1", 4096, 2),
    ("getting_started", 65536, 1)], ids=["4096", "8192", "65536"])
def test_race_window_lane_groups_match_plain(dev, cfg, n_envs, n_drones,
                                             lanes, monkeypatch):
    """K3 on a lane group of L = 1 or 4 per agent equals its plain version
    bit for bit, with and without the planner and noise, at the general
    trainer's (4096 x 1), level1's (8192) and 65536 agents."""
    from gym_pybullet_adrp_tpu_torch.race_kernel_times import k3_window

    env = eval_race.make_eval_env(cfg, n_envs, dev, seed=3,
                                  n_drones=n_drones)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (env.n_ticks, 3, env.T, 128)
    nz = torch.cat([torch.rand(shape, generator=gen, device=dev) * 0.2 - 0.1,
                    torch.randn((env.n_ticks, 4, env.T, 128), generator=gen,
                                device=dev) * 0.001], dim=1).contiguous()
    if lanes is not None:
        monkeypatch.setattr(race_window, "lane_count",
                            lambda a, n_sm=132: lanes)
    c = race_window.window_consts(env.kf, env.km, env.arm, env.ground_z,
                                  env.dt, env.n_ticks)
    for planner in (False, True):
        W = k3_window(env, st, gen, planner)
        for noise in (None, nz):
            got = race_window.race_window(env.kf, env.km, env.arm,
                                          env.ground_z, st.S, W, env.n_ticks,
                                          env.dt, noise, consts=c)
            ref = race_window.race_window_plain(
                env.kf, env.km, env.arm, env.ground_z, st.S, W, env.n_ticks,
                env.dt, noise)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            assert torch.equal(got, ref), (planner, noise is not None)


def test_general_fast_path_on_the_card(dev):
    """The general env's K3 route on the card: one launch per step for all
    agents, in closed loop within tests/test_pallas_race.py's bounds of
    the eager race_step, and the --fast trainer at 64 launches an
    iteration."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.control import commander as pcmd
    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs import race_fast as pfast
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Command, RaceMode

    cfg = load_config("getting_started")
    spec = prace.RaceSpec.from_config(cfg, 2, RaceMode.COMPARE)
    track = prace.track_tensors(prace.track_from_config(cfg, 2), dev)
    B = 256
    s_ref = prace.race_reset(spec, track, B, device=dev)
    s_fast = prace.race_reset(spec, track, B, device=dev)
    seq = ([(Command.TAKEOFF, (0.3, 1.0))] + [(Command.NONE, ())] * 12
           + [(Command.FULLSTATE, ([0.5, 0.5, 0.5], [0, 0, 0], [0, 0, 0],
                                   0.1, [0, 0, 0], 0.6))] * 5)
    before = race_window.race_window.launches
    for cmd, args in seq:
        cid, vec = pcmd.pack_command(cmd, args)
        ids = torch.full((B, 2), cid, dtype=torch.int32, device=dev)
        arg = torch.as_tensor(vec, device=dev).expand(B, 2, -1)
        s_ref = prace.race_step(spec, track, s_ref, ids, arg)[0]
        s_fast = pfast.batched_race_step_fast(spec, track, s_fast, ids,
                                              arg)[0]
    assert race_window.race_window.launches == before + len(seq)
    assert float((s_ref.phys.pos - s_fast.phys.pos).abs().max()) < 0.05
    assert torch.equal(s_ref.current_gate, s_fast.current_gate)
    z = s_fast.phys.pos[:, 0, 2]
    assert bool(((0.12 < z) & (z < 0.8)).all())
    before = race_window.race_window.launches
    res = train_race.train(config="twogates", n_envs=1024, n_steps=64,
                           iters=2, fast=True, device=dev, log_every=0)
    assert race_window.race_window.launches == before + 2 * 64
    assert all(torch.isfinite(torch.tensor(m["loss"]))
               for m in res["metrics"])


@pytest.mark.parametrize("cfg,n_drones,n_envs", [
    ("level1", 1, 256), ("getting_started", 2, 256),
    ("getting_started", 1, 128), ("twogates", 4, 384), ("level2", 8, 128),
    ("level3", 4, 128)])
def test_race_step_kernel_matches_plain(dev, cfg, n_drones, n_envs):
    """K4 without the policy equals its plain version bit for bit, every
    output, over twelve consecutive steps: 1 to 8 COMPETE drones (8: more
    window units than a block has warps), 128 to 384 envs (fewer tiles
    than SMs; a count that is not a multiple of 256); level3 at 4 drones
    is V1's env and, at another width, the league trainer's."""
    env = eval_race.make_eval_env(cfg, n_envs, dev, seed=2,
                                  n_drones=n_drones)
    st = env.reset()
    gen = torch.Generator(device=dev).manual_seed(1)
    before = race_step.race_step_fused.launches
    for i in range(12):
        shape = (n_envs, n_drones, 4) if n_drones > 1 else (n_envs, 4)
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
        assert len(got) == len(ref) == 9
        for j, (g, r) in enumerate(zip(got, ref)):
            assert torch.isfinite(g).all(), j
            assert torch.equal(g, r), j
        st = st._replace(S=ref[0], R=ref[1], GG=ref[2], OO=ref[3],
                         EP=ref[4])
    assert race_step.race_step_fused.launches == before + 12


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
    """A random ActorCritic's pack, with random biases (the init zeroes
    them) so that every tensor of the pack is read at its offset."""
    gen = torch.Generator().manual_seed(3)
    net = ActorCritic(env.obs_size, 4, hidden, generator=gen)
    with torch.no_grad():
        net.log_std.fill_(-1.0)
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1, generator=gen)
    return pack_policy_params(net.to(env.device))


# the in-kernel policy's widths: the trainer's, a wide pair (float4 weight
# rows and dynamic shared memory above 48 KB) and an odd pair (masked
# output chunks, unaligned rows)
POLICY_CASES = [(cfg, n, hidden)
                for cfg, n in (("getting_started", 1), ("twogates", 2))
                for hidden in ((64, 64), (256, 128), (37, 5))]


@pytest.mark.parametrize("cfg,n_drones,hidden",
                         POLICY_CASES + [("level1", 1, (256, 128)),
                                         ("getting_started", 2, (64, 64)),
                                         ("twogates", 4, (64, 64))])
def test_policy_option_matches_plain(dev, cfg, n_drones, hidden):
    """K4 with the policy equals its plain version to the bit, every
    output, over six consecutive steps."""
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
        assert len(got) == len(ref) == 12
        for j, (g, r) in enumerate(zip(got, ref)):
            assert torch.equal(g, r), j
        st, obs = RowRaceState(*ref[:5]), ref[5]
    assert race_step.race_step_fused.policy_launches == before + 6


@pytest.mark.parametrize("mode,cfg,n_drones,hidden", [
    ("actions", "level2", 1, None), ("actions", "getting_started", 2, None),
    ("actions", "level2", 4, None)]
    + [("policy",) + case for case in POLICY_CASES]
    + [("policy", "level2", 4, (64, 64))])
def test_rollout_kernel_equals_step_launches(dev, mode, cfg, n_drones,
                                             hidden):
    """One race_rollout launch of K=8 steps == 8 race_step launches, bit
    for bit (level2: randomized draws and disturbances; 1, 2 and 4 COMPETE
    drones in both modes; policy mode: the in-kernel policy's widths)."""
    K = 8
    env = eval_race.make_eval_env(cfg, 256, dev, seed=6, n_drones=n_drones)
    st = env.reset()
    obs = env.initial_obs_rows(st)
    gen = torch.Generator(device=dev).manual_seed(5)
    seq = torch.randn((K, 4, env.T, 128), generator=gen, device=dev)
    pack = _policy(env, hidden) if mode == "policy" else None
    d = env.stacked_draws(K)
    kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
              telemetry=True)
    pol = ({} if pack is None else
           dict(policy_pack=pack, obs_rows=obs, actn_seq=seq,
                policy_hidden=hidden))
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
              dict(policy_pack=pack, obs_rows=obs, actn=seq[k],
                   policy_hidden=hidden))
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


@pytest.mark.parametrize("hidden", [(64, 64), (256, 256)])
def test_policy_launch_geometry(dev, hidden):
    """The policy launches a 512-thread block per 32-env tile with its
    activations, and the pack where it fits, in dynamic shared memory
    (above 48 KB at 8 drones, which the launch allows); without it, a
    block per 32-env tile too and a warp per window unit (a lane group of
    4 per agent: N x 4 units, at most 8 warps), no dynamic shared memory;
    both keep the tail's exchange in static shared memory; the MLP keeps
    no per-thread activation stack."""
    lay, _ = race_step.policy_layout(127, hidden)
    h1, h2 = hidden
    rows = (127 + 2 * (h1 + h2) + 5 + 3 * 8) * 32 * 4
    # the weights, rows padded to 4 floats, where they fit
    staged = (2 * (h1 * 128 + h2 * h1) + 5 * h2) * 4
    smem = rows + staged if rows + staged <= 232448 else rows
    assert (smem > rows) == (hidden == (64, 64))
    for kernel in ("race_step", "race_rollout"):
        g = race_step.launch_geometry(kernel, 8, 4, lay)
        assert (g["blocks"], g["threads"], g["smem_bytes"]) == (
            16, 512, smem)
        assert g["local_bytes"] < 1024, g
        assert 0 < g["static_smem_bytes"] <= 4096, g
        for n in (1, 2, 8):
            g = race_step.launch_geometry(kernel, n, 4)
            assert (g["blocks"], g["threads"], g["smem_bytes"]) == (
                16, 32 * min(n * 4, 8), 0), g
            assert 0 < g["static_smem_bytes"] <= 4096, g


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


# The hover rollout kernels run an env on a group of L lanes, L from the
# batch (hover_step.lane_count: 4 at 1024 and 4096 envs and 1 at 65536 on
# an H100's 132 SMs), and every rank computes the plain version's
# operations in its order: each kernel equals its plain version bit for
# bit at each of those batches, and a 65536-env launch (L = 1) gives its
# first 1024 envs the bits of a 1024-env launch of them (L = 4).

HOVER_KERNELS = ("k1", "k2_smallangle", "k2_exact", "k7", "k7_exact_sqrt",
                 "k8")


def _hover_case(dev, kernel, n_envs, n_steps, acts):
    """(kernel fn, plain fn, launch counter owner) of a hover kernel id,
    each a function of (state[, rpm]) that returns a tuple."""
    P = drone_params(device=dev)
    kw = dict(actions=acts, count_resets=True)
    if kernel == "k1":
        return (lambda st, rpm: (hs.ctrl_step_packed(P, st, rpm, 8, 1 / 240),),
                lambda st, rpm: (hs.ctrl_step_packed_plain(P, st, rpm, 8,
                                                           1 / 240),),
                hs.ctrl_step_packed)
    if kernel.startswith("k2"):
        small = kernel == "k2_smallangle"
        return (lambda st, rpm: hs.hover_rollout(
                    P, st, 21, n_steps, smallangle=small, **kw),
                lambda st, rpm: hs.hover_rollout_plain(
                    P, st, 21, n_steps, smallangle=small, **kw),
                hs.hover_rollout)
    if kernel == "k8":
        return (lambda st, rpm: hv.hover_rollout_v3(P, st, 21, n_steps, **kw),
                lambda st, rpm: hv.hover_rollout_v3_plain(P, st, 21, n_steps,
                                                          **kw),
                hv.hover_rollout_v3)
    sq = kernel == "k7_exact_sqrt"
    return (lambda st, rpm: hv.hover_rollout_v2(P, st, 21, n_steps,
                                                exact_sqrt=sq, **kw),
            lambda st, rpm: hv.hover_rollout_v2_plain(P, st, 21, n_steps,
                                                      exact_sqrt=sq, **kw),
            hv.hover_rollout_v2)


# K1 takes its rpm as input: it has no draw mode
KERNEL_MODES = [(k, m) for k in HOVER_KERNELS for m in ("injected", "random")
                if not (k == "k1" and m == "random")]


@pytest.mark.parametrize("n_envs", [1024, 4096, 65536])
@pytest.mark.parametrize("kernel,mode", KERNEL_MODES)
def test_hover_kernel_bit_for_bit_at_each_lane_count(dev, kernel, mode,
                                                     n_envs):
    """Random attitudes and rates, 128 envs in ground contact, 37 steps
    (13 at 65536 envs): not a multiple of L, so the last run of steps is
    short; episodes end and reset inside the launch."""
    _, st, rpm, gen = _hover_state(dev, n_envs)
    n_steps = 13 if n_envs == 65536 else 37
    acts = ((torch.rand((n_steps, 4, n_envs // 128, 128), generator=gen,
                        device=dev) - 0.5) * 0.1
            if mode == "injected" else None)
    fn, plain_fn, owner = _hover_case(dev, kernel, n_envs, n_steps, acts)
    before = owner.launches
    got = fn(st, rpm)
    assert owner.launches == before + 1
    ref = plain_fn(st, rpm)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if kernel != "k1":
        assert float(got[2].sum()) > 0       # episodes ended in the launch


def test_hover_lane_counts_on_this_card(dev):
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = {B: hs.lane_count(B, n_sm) for B in (1024, 65536)}
    assert lanes[65536] == 1 and lanes[1024] > 1


@pytest.mark.parametrize("kernel,mode", [
    km for km in KERNEL_MODES if km[0] in ("k1", "k2_smallangle", "k2_exact")])
def test_hover_kernels_batch_independent(dev, kernel, mode):
    """The first 1024 envs of a 65536-env launch (one lane per env) equal a
    1024-env launch of the same states, draws and seed (a lane group per
    env), bit for bit."""
    _, st, rpm, gen = _hover_state(dev, 65536, seed=4)
    n_steps = 21
    acts = ((torch.rand((n_steps, 4, 512, 128), generator=gen, device=dev)
             - 0.5) * 0.1 if mode == "injected" else None)
    big = _hover_case(dev, kernel, 65536, n_steps, acts)[0](st, rpm)
    small_acts = None if acts is None else acts[:, :, :8].contiguous()
    small = _hover_case(dev, kernel, 1024, n_steps, small_acts)[0](
        st[:, :8].contiguous(), rpm[:, :8].contiguous())
    torch.cuda.synchronize()
    for a, b in zip(big, small):
        assert torch.equal(a[..., :8, :], b)


# ---- the public surfaces, the league and checkpoints on the card ---------


def test_race_vector_env_equals_row_env(dev, monkeypatch):
    """TorchRaceVectorEnv's fused backend: one race_step launch and one
    download a step, and its outputs equal (torch.equal) to the direct
    row env's with telemetry, from the same seed."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import make_row_env
    from gym_pybullet_adrp_tpu_torch.envs.race_vector import (
        TorchRaceVectorEnv,
    )
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

    B, steps = 512, 24
    gen = torch.Generator(device=dev).manual_seed(1)
    acts = torch.rand((steps, B, 2, 4), generator=gen, device=dev) * 2 - 1
    venv = TorchRaceVectorEnv(B, "twogates", num_drones=2, device=dev)
    assert venv.fused_backend
    venv.reset(seed=4)
    acts_np = acts.cpu().numpy()
    cpu, downloads, out = torch.Tensor.cpu, [], []
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: downloads.append(1) or cpu(t))
    before = race_step.race_step_fused.launches
    for i in range(steps):
        out.append(venv.step(acts_np[i]))
    assert race_step.race_step_fused.launches - before == steps
    assert len(downloads) == steps
    monkeypatch.undo()
    cfg = load_config("twogates")
    spec = prace.RaceSpec.from_config(cfg, 2, RaceMode.COMPETE)
    env = make_row_env(spec, prace.track_from_config(cfg, 2), B, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4),
                       telemetry=True, per_drone_reward=True)
    st = env.reset()
    for i in range(steps):
        st, obs, rew, done, info = env.step(st, acts[i])
        o, r, te, tr, inf = out[i]
        for got, ref in ((o, obs), (r, rew), (te | tr, done),
                         (te, info["terminated"]),
                         (inf["current_gate"], info["current_gate"]),
                         (inf["eliminated"], info["eliminated"] > 0.5),
                         (inf["finished"], info["finished"] > 0.5),
                         (inf["ep_steps"], info["ep_steps"])):
            g = torch.from_numpy(np.ascontiguousarray(got)).to(dev)
            assert torch.equal(g, ref.to(g.dtype)), i


def test_checkpoint_resume_on_the_card(dev, tmp_path):
    """Row trainer at 512 x 16 on the card: 1 iteration, save, 1 more
    (unbroken) against a fresh state restored and stepped once: equal by
    torch.equal, the env's and the learner's generators (CUDA) included."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.rl import checkpoint as ckpt

    kw = dict(config="getting_started", n_envs=512, n_steps=16, device=dev,
              log_every=0)
    first = train_race.train(iters=1, **kw)
    ckpt.save_checkpoint(tmp_path, first["ts"], 1)
    whole, m_whole = first["train_step"](first["ts"])
    fresh = train_race.train(iters=0, **kw)
    ts, _ = ckpt.restore_checkpoint(tmp_path, fresh["ts"], device=dev)
    assert ts.rng.device.type == "cuda" and ts.env_rng.device.type == "cuda"
    ts, m = fresh["train_step"](ts)
    assert float(m["loss"]) == float(m_whole["loss"])
    for a, b in zip(ckpt._flatten(whole, []), ckpt._flatten(ts, [])):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)


def test_league_iteration_launches(dev):
    """A league iteration (level3, 4 drones COMPETE, 256 envs x 64 steps,
    two pool members, refresh 1): 64 race_step launches, slot 0 the
    learner after the refresh."""
    from gym_pybullet_adrp_tpu_torch import train_race

    pool = ",".join(str(REPO / f"results/{p}.msgpack")
                    for p in ("level3_mastery", "level3_selfplay"))
    before = race_step.race_step_fused.launches
    res = train_race.train(config="level3", n_envs=256, n_steps=64, iters=1,
                           n_drones=4, compete=True, end_after_gate=0,
                           league=pool, league_refresh=1, prox_penalty=0.1,
                           device=dev, log_every=0)
    assert race_step.race_step_fused.launches - before == 64
    ts = res["ts"]
    w = ts.env_state.pool.weight[0][0]
    assert torch.equal(w, ts.params.pi[0].weight.T)


@pytest.mark.slow
def test_flagship_artifact_on_the_card(dev):
    """V1: results/level3_mastery.msgpack on level3, 128 envs x 4 drones
    COMPETE, at the reference's cross-platform floors
    (tests/test_learned_racing.py:139-164)."""
    out = eval_race.evaluate(str(REPO / "results/level3_mastery.msgpack"),
                             "level3", 128, device=dev, n_drones=4)
    assert out["per_drone_completion_rate"] >= 0.15, out
    assert out["mean_gates"] >= 1.2, out


# ---- the pixels path (no kernel of the port: plain PyTorch on the card) ----

def _race_scene_and_poses(n, seed=0):
    """A getting_started reset's scene (CPU) and ``n`` seeded camera
    poses looking at its gates."""
    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs import race_rl
    from gym_pybullet_adrp_tpu_torch.ops import render
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg = load_config("getting_started")
    spec = prace.RaceSpec.from_config(cfg, 1, RaceMode.COMPARE, Physics.PYB)
    track = prace.track_tensors(prace.track_from_config(cfg, 1), "cpu")
    gen = torch.Generator().manual_seed(seed)
    rs = race_rl.rl_race_reset(spec, track, 1, generator=gen,
                               device="cpu").race
    scene = render.scene_from_race_state(rs.gates_actual[0],
                                         rs.obstacles_actual[0],
                                         rs.phys.pos[0])
    lo, hi = torch.tensor([-1.5, -2.0, 0.1]), torch.tensor([1.5, 2.0, 1.5])
    eye = lo + (hi - lo) * torch.rand((n, 3), generator=gen)
    pick = torch.randint(0, rs.gates_actual.shape[1], (n,), generator=gen)
    tgt = rs.gates_actual[0, pick, :3] + 0.5 * torch.randn((n, 3),
                                                           generator=gen)
    return scene, eye, tgt


def test_render_card_equals_cpu(dev):
    """The renderer on the card against itself on the CPU, 64 poses of
    the getting_started scene at 64x48 and 110 degrees: seg equal in
    every pixel, depth within 1e-5 relative (every operation is rounded
    alike on both; square roots correctly rounded on both)."""
    from gym_pybullet_adrp_tpu_torch.ops import render

    scene, eye, tgt = _race_scene_and_poses(64)
    ref = render.render(scene, eye, tgt, 64, 48, 110.0)
    on_card = render.Scene(*(x.to(dev) for x in scene))
    got = [x.cpu() for x in render.render(on_card, eye.to(dev), tgt.to(dev),
                                          64, 48, 110.0)]
    assert torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name,h,w", [
    ("agents/example_pixels_policy.msgpack", 24, 32),
    ("results/px5/full.msgpack", 48, 64)], ids=["32x24", "64x48"])
def test_cnn_card_matches_cpu(dev, name, h, w):
    """A shipped pixel policy's heads on the card (cuDNN with TF32 off, as
    train_race.train sets it) within 1e-5 of the CPU's on 512 frames:
    float32 both, only the summation order differs."""
    from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = pck.load_policy(REPO / name, device="cpu", img=(h, w))
        obs = torch.rand((512, h * w * 3),
                         generator=torch.Generator().manual_seed(h))
        with torch.no_grad():
            ref = [x.clone() for x in net(obs)]
            got = net.to(dev)(obs.to(dev))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# the firmware-in-the-loop and Betaflight envs, and autograd, on the card


def test_cf_takeoff_on_the_card(dev):
    """CFAviary's firmware window on the card (eager, no kernel): the
    takeoff of tests/test_cf_beta.py:14 reaches 0.2-0.5 m in 100 steps."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.envs.cf import CFAviary

    env = CFAviary(device=dev)
    env.reset()
    env.sendTakeoffCmd(0.3, 1.5)
    for i in range(100):
        obs, *_ = env.step(i)
    assert 0.2 < obs[0][2] < 0.5 and np.isfinite(obs).all()


def test_beta_hover_on_the_card(dev):
    """BetaAviary with CTBRControl on the card: both drones within 0.05 m
    of their targets after 100 steps (tests/test_cf_beta.py:357)."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.control import CTBRControl
    from gym_pybullet_adrp_tpu_torch.envs.beta import BetaAviary

    env = BetaAviary(num_drones=2, device=dev)
    obs, _ = env.reset()
    ctrl = CTBRControl(env.DRONE_MODEL, device=dev)
    target = np.array([[0.0, 0.0, 1.0], [0.3, 0.0, 1.0]])
    act = np.zeros((2, 4))
    for i in range(100):
        obs, *_ = env.step(act, i)
        for j in range(2):
            act[j] = ctrl.computeControlFromState(1 / 25, obs[j], target[j])
    np.testing.assert_allclose(obs[:, :3], target, atol=0.05)


def _final_z_grad(device, acts):
    from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
    from gym_pybullet_adrp_tpu_torch.examples import apg

    params = drone_params(device=device)
    a = acts.to(device).requires_grad_(True)
    st = rlenv.rl_reset(apg.RL_CFG, apg.INIT_XYZS, apg.INIT_RPYS,
                        acts.shape[0], device=device)
    for _ in range(5):
        st, *_ = rlenv.rl_step(apg.RL_CFG, params, st, a)
    g, = torch.autograd.grad(st.core.phys.pos[:, 0, 2].sum(), a)
    return g.cpu()


def test_gradient_card_matches_cpu(dev):
    """d(final z)/d(action) through 5 rl_steps on the card against the
    CPU at rtol 1e-4 (tests/test_torch_diff.py's tolerance against
    jax.grad), all positive at the zero action."""
    gen = torch.Generator().manual_seed(0)
    acts = torch.cat([torch.zeros(1, 1, 4),
                      torch.rand((63, 1, 4), generator=gen) * 1.6 - 0.8])
    got, ref = _final_z_grad(dev, acts), _final_z_grad("cpu", acts)
    assert (got[0] > 0).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=0)


def test_kernel_routes_refuse_autograd_on_the_card(dev):
    """Each kernel route refuses a CUDA input that requires grad before it
    launches anything; without grad it launches as before."""
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover

    P = drone_params(device=dev)
    st = fast_hover.reset_packed([0.0, 0.0, 0.1125], 128, device=dev)
    rpm = torch.full((4, 1, 128), 14000.0, device=dev)
    S = torch.zeros(58, 1, 128, device=dev, requires_grad=True)
    W = torch.zeros(57, 1, 128, device=dev)
    tail = dict(n_ticks=20, dt=0.002, spec_tail=None)
    step = fast_hover.make_step(P, 128, device=dev)
    grad_state = st.packed.clone().requires_grad_(True)
    calls = [
        lambda: step(st, torch.zeros(4, 1, 128, device=dev,
                                     requires_grad=True)),
        lambda: hs.ctrl_step_packed(P, grad_state, rpm, 8, 1 / 240),
        lambda: hs.hover_rollout(P, grad_state, 3, 2),
        lambda: hv.hover_rollout_v2(P, grad_state, 3, 2),
        lambda: hv.hover_rollout_v3(P, grad_state, 3, 2),
        lambda: race_window.race_window(3.16e-10, 7.94e-12, 0.0397, 0.0125,
                                        S, W),
        lambda: race_step.race_step_fused(0, 0, 0, 0, S, None, None, None,
                                          None, None, None, None, None,
                                          **tail),
        lambda: race_rollout.race_rollout(0, 0, 0, 0, S, None, None, None,
                                          None, None, None, None, None,
                                          **tail),
    ]
    n = hs.ctrl_step_packed.launches
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    with torch.no_grad():
        out = hs.ctrl_step_packed(P, grad_state, rpm, 8, 1 / 240)
    assert out.shape == (13, 1, 128) and not out.requires_grad
    assert hs.ctrl_step_packed.launches == n + 1


# ---- distributed training (phase 30 of chip_smoke.py, small) -------------


def _world_of_one(backend):
    from gym_pybullet_adrp_tpu_torch.parallel import hosts
    from gym_pybullet_adrp_tpu_torch.scaling import free_port

    assert hosts.ensure_initialized(f"127.0.0.1:{free_port()}", 1, 0,
                                    backend=backend)


@pytest.mark.parametrize("k", [0, 4], ids=["race_step", "race_rollout"])
def test_sharded_race_rollout_on_the_card(dev, k):
    """race_rollout_throughput_fn under a process group (gloo, CUDA
    tensors): K4 every step or K5 every k steps, the local sum equal to
    the same seed alone, and the reduced sum the local one."""
    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg = load_config("getting_started")
    spec = race_mod.RaceSpec.from_config(cfg, 2, RaceMode.COMPETE,
                                         Physics.PYB)
    track = race_mod.track_from_config(cfg, 2)
    _world_of_one("gloo")
    try:
        mesh = distributed.make_mesh()
        fn = distributed.race_rollout_throughput_fn(
            mesh, spec, track, 256, 8, rollout_k=k, device=dev)
        race_step.race_step_fused.launches = 0
        race_rollout.race_rollout.launches = 0
        total, local = fn(5)
        launched = (race_step.race_step_fused.launches,
                    race_rollout.race_rollout.launches)
        _, alone = distributed.race_rollout_throughput_fn(
            None, spec, track, 256, 8, rollout_k=k, device=dev)(5)
    finally:
        torch.distributed.destroy_process_group()
    assert launched == ((8, 0) if k == 0 else (0, 8 // k))
    assert torch.equal(local, alone) and torch.equal(total, local)
    assert total.is_cuda and torch.isfinite(total)


def test_world_of_one_nccl_step_equals_make_ppo(dev):
    """make_distributed_ppo on one NCCL rank: make_ppo's step bit for
    bit (2 iterations, grad_accum 2)."""
    from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
    from gym_pybullet_adrp_tpu_torch.envs.rl import RLConfig
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo
    from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType

    rl_cfg = RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                      act_type=ActionType.RPM)
    P = drone_params(device=dev)
    xyz, rpy = [[0.0, 0.0, 0.1125]], [[0.0, 0.0, 0.0]]
    cfg = ppo.PPOConfig(n_envs=64, n_steps=16, n_minibatches=4,
                        grad_accum=2, n_epochs=2)
    _world_of_one("nccl")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = distributed.make_mesh()
        gi, step = distributed.make_distributed_ppo(mesh, cfg, rl_cfg, P,
                                                    xyz, rpy, device=dev)
        ts = distributed.host_to_global(mesh, gi(0))
        rinit, rstep, _ = ppo.make_ppo(cfg, rl_cfg, P, xyz, rpy, device=dev)
        rts = rinit(distributed.rank_seeds(0, 1)[0])
        for _ in range(2):
            ts, m = step(ts)
            rts, rm = rstep(rts)
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(ts.params.parameters(), rts.params.parameters()):
        assert torch.equal(a, b)
    assert float(m["loss"]) == float(rm["loss"])


# ---- the last tools: wrappers, reports, video, live flight, roofline ------

def test_wrapped_race_on_the_card(dev):
    """RewardWrapper(DroneObservationWrapper(MultiRaceAviary)) on the card:
    the learned twogates racer reaches gate 2, where the wrappers end the
    episode; every reward finite, their sum above one gate's bonus."""
    import math

    import numpy as np

    from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
    from gym_pybullet_adrp_tpu_torch.utils.utils import load_controller
    from gym_pybullet_adrp_tpu_torch.utils.wrapper import (
        DroneObservationWrapper, RewardWrapper,
    )

    env = RewardWrapper(DroneObservationWrapper(
        MultiRaceAviary("twogates", num_drones=1, device=dev)))
    obs, info = env.reset()
    agent = load_controller("rl_twogates")(0, obs[0],
                                           dict(info, device=str(dev)))
    rewards = []
    for i in range(250):
        obs, r, te, tr, _ = env.step([agent.predict(obs[0],
                                                    ep_time=i / 25)])
        rewards.append(r)
        if te or tr:
            break
    assert te and int(env.unwrapped.current_gate[0]) >= 2
    assert all(map(math.isfinite, rewards)) and sum(rewards) > 5.0
    assert np.isfinite(obs).all()


def test_chase_frame_card_equals_cpu(dev):
    """race_video's chase frame of one race state rendered on the card and
    on the CPU: seg equal in every pixel, depth within 1e-4 relative. The
    frame builds its scene on each device, and the gate beams' endpoints
    come from the gates' yaw through that device's sin/cos, which may
    differ in the last bit: on an H100 21 of the 19,200 pixels' depth
    differed, by at most 4.4e-5 relative (the render of one scene on both
    devices holds 1e-5, test_render_card_equals_cpu)."""
    from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
    from gym_pybullet_adrp_tpu_torch.examples import race_video

    envs = [MultiRaceAviary("getting_started", num_drones=2, device=d)
            for d in ("cpu", dev)]
    envs[0].reset()
    envs[1].reset()

    def to(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        return type(tree)(*(to(x) for x in tree))

    envs[1]._state = to(envs[0]._state)
    ref = race_video.chase_frame(envs[0], 160, 120)
    got = [x.cpu() for x in race_video.chase_frame(envs[1], 160, 120)]
    assert torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=0)


def test_live_fly_on_the_card(dev):
    """live_fly.serve(port=0) over a CtrlAviary on the card: 21000 RPM
    climbs, the frame is a PNG."""
    import base64
    import json
    import threading
    import time
    import urllib.request

    from gym_pybullet_adrp_tpu_torch import live_fly

    httpd = live_fly.serve(port=0, device=str(dev))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        urllib.request.urlopen(urllib.request.Request(
            base + "/rpm", data=b"[21000,21000,21000,21000]", method="POST"))
        s0 = json.loads(urllib.request.urlopen(base + "/state").read())
        time.sleep(0.5)
        s1 = json.loads(urllib.request.urlopen(base + "/state").read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert httpd.sim.env.device.type == "cuda"
    assert s1["pos"][2] > s0["pos"][2] + 0.05
    assert base64.b64decode(s1["png"])[:8] == b"\x89PNG\r\n\x1a\n"


def test_roofline_census_on_the_card(dev):
    """The kernels' plain versions counted on the card give the CPU's
    counts, and the stored constants."""
    from gym_pybullet_adrp_tpu_torch.utils import roofline as rf

    got = rf.measure_ops_per_env_step(dev)
    ref = rf.measure_ops_per_env_step("cpu")
    assert got["ops"] == ref["ops"] and got["by_op"] == ref["by_op"]
    for k, v in got["ops"].items():
        assert abs(v - rf.OPS_PER_ENV_STEP[k]) <= 0.02 * v


def test_rollout_spans_on_the_trace_clock(dev, tmp_path):
    """Two policy rollouts (level3, 2 drones COMPETE, 1024 envs, 64 steps,
    K5 16 steps a launch) under ``profiling.trace()``: every
    race_rollout_kernel launch's CUDA API call falls inside a
    ``race_rollout.launch`` span on the trace's clock, within 50 us; 4
    launch spans and 576 host copies a rollout."""
    import json

    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        make_policy_rollout, make_row_env,
    )
    from gym_pybullet_adrp_tpu_torch.rl.ppo import (
        EnvAdapter, PPOConfig, make_ppo_core,
    )
    from gym_pybullet_adrp_tpu_torch.utils import profiling
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg, B, N = load_config("level3"), 1024, 2
    spec = race_mod.RaceSpec.from_config(cfg, N, RaceMode.COMPETE,
                                         Physics.PYB)
    gen = torch.Generator(device=dev).manual_seed(5)
    env = make_row_env(spec, race_mod.track_from_config(cfg, N), B,
                       device=dev, generator=gen, end_after_gate=2,
                       per_drone_reward=True)
    b_reset, override, step = make_policy_rollout(env, 64, 16)
    adapter = EnvAdapter(batched_reset=b_reset, step=step,
                         obs_dim=env.obs_size, act_dim=4, generator=gen)
    init_fn, _, _ = make_ppo_core(
        PPOConfig(n_envs=B * N, n_steps=64, shuffle_block=512), adapter,
        rollout_override=override, device=dev)
    ts = init_fn(0)
    with torch.no_grad():
        ts = override(ts)[0]                        # warm-up: the build
        torch.cuda.synchronize()
        profiling.take()
        with profiling.trace(str(tmp_path)):
            for _ in range(2):
                ts = override(ts)[0]
            torch.cuda.synchronize()
    recs = profiling.take()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == profiling.SPAN_CAT
             and e["name"] == "race_rollout.launch"]
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and "race_rollout_kernel" in e["name"]}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") in corr]
    assert len(spans) == len(corr) == len(calls) == 8
    for c in calls:
        assert any(s - 50 <= c["ts"] and c["ts"] + c["dur"] <= t + 50
                   for s, t in spans), c
    roots = [r for r in recs if r.name == "rollout" and r.parent is None]
    assert len(roots) == 2
    for root in roots:
        under = [r for r in recs if r.root == root.id]
        assert sum(r.name == "race_rollout.launch" for r in under) == 4
        assert sum((r.counts or {}).get("host_copies", 0)
                   for r in under) == 9 * 64

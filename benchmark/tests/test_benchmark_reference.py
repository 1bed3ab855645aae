"""CPU tests of the benchmark's reference and counts: the frozen plain
step equals the port's plain step to the bit, the frozen operation counts
equal a fresh count from the reference, the byte count of a K5 launch,
and the weights' layout against the port's ``ActorCritic``."""

import json

import pytest
import torch

from benchmark import counts, harness
from benchmark.reference.race_env import STATE_KEYS, RaceReference
from benchmark.weights import layout, make_weights

CONFIGS = ("race-gs-1d", "race-level3-2d")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    b = harness.load_benchmark()
    return harness.load_config({c["name"]: c for c in b["configs"]}[name])


@pytest.mark.parametrize("kind", counts.KINDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_counts_recount(name, kind):
    frozen = counts.load(name)[kind]["ops_per_env_step"]
    assert counts.count_ops(_config(name), kind) == frozen


@pytest.mark.parametrize("policy", [True, False], ids=["policy", "actions"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_step_equals_port(name, policy):
    """Three steps of the frozen plain step and of the port's fused plain
    step from the same state, draws and inputs: equal to the bit."""
    from gym_pybullet_adrp_tpu_torch.ops import race_step as rs
    from benchmark.kinds.policy_rollout import port_spec_track
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        make_row_env, pack_policy_params,
    )
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    cfg = _config(name)
    spec, track = port_spec_track(cfg)
    N = spec.num_drones
    env = make_row_env(spec, track, 128, device="cpu",
                       generator=torch.Generator().manual_seed(3),
                       end_after_gate=2, per_drone_reward=N > 1)
    w = make_weights(env.obs_size, (64, 64), 4, "cpu")
    net = ActorCritic(env.obs_size)
    net.load_state_dict(w)
    pack = pack_policy_params(net)
    ref = RaceReference(cfg, 128, "cpu", end_after_gate=2, weights=w)
    st = env.reset()
    obs = env.initial_obs_rows(st)
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        d = env.step_draws()
        actn = torch.randn((4, env.T, 128), generator=g)
        A = env.action_rows(torch.rand((128, N, 4) if N > 1 else (128, 4),
                                       generator=g) * 2 - 1)
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows=d.noise_rows)
        if policy:
            kw.update(policy_pack=pack, obs_rows=obs, actn=actn)
        got = rs.race_step_fused_plain(
            env.kf, env.km, env.arm, env.ground_z, st.S,
            None if policy else A, st.R, st.GG, st.OO, st.EP, d.RST,
            d.RSTG, d.RSTO, **kw)
        inp = {k: getattr(st, k) for k in STATE_KEYS}
        inp.update(RST=d.RST, RSTG=d.RSTG, RSTO=d.RSTO)
        if d.noise_rows is not None:
            inp["noise"] = d.noise_rows
        if policy:
            inp.update(obs=obs, actn=actn)
        else:
            inp["A"] = A
        want = ref.step(inp, policy=policy)
        keys = rs._OUT_ORDER + (rs._POLICY_OUT if policy else ())
        for k, x in zip(keys, got):
            assert torch.equal(x, want[k]), k
        st = type(st)(*got[:5])
        obs = got[5]


def test_k5_bytes_per_launch():
    d = dict(N=2, Tb=4, G=4, O=4, C=55, n_ticks=20, noise=True,
             static=False)
    T, rows = 8, 512
    K = 16
    read = (T * 72 + 4 * 21 + K * (T * 10 + 4 * 20) + K * 20 * 7 * T
            + T * 55 + K * 4 * T)
    written = T * 72 + 4 * 21 + K * (T + 4) + K * 61 * T
    pack = 2 * 55 * 64 + 2 * 64 * 64 + 4 * 64 + 64 + 2 * 128 + 9
    assert counts.k5_bytes_per_launch(d, "policy_rollout", K, (64, 64)) == (
        (read + written) * rows + 4 * pack)
    d.update(noise=False, static=True)
    read = T * 72 + 4 * 21 + (T * 10 + 4 * 20) + K * 4 * T
    written = T * 72 + 4 * 21 + K * (T + 4)
    assert counts.k5_bytes_per_launch(d, "action_rollout", K, (64, 64)) == (
        (read + written) * rows)


def test_weights_layout_matches_the_port():
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    net = ActorCritic(49)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {n: s for n, s, _ in layout(49, (64, 64))} == shapes
    w = make_weights(49, (64, 64), 2 ** 40, "cpu")
    assert torch.equal(w["pi.0.weight"],
                       make_weights(49, (64, 64), 2 ** 40, "cpu")[
                           "pi.0.weight"])
    assert float(w["log_std"].abs().max()) == 0.0


def test_counts_files_hold_both_kinds():
    for name in CONFIGS:
        c = json.loads((counts.ROOT / "counts" / f"{name}.json").read_text())
        assert set(c) >= set(counts.KINDS)

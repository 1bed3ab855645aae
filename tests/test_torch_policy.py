"""Port: the flax-msgpack reader and ActorCritic against flax, on CPU.

The reader must give flax.serialization.msgpack_restore's tree bit for
bit on every shipped artifact. The converted ActorCritic must give the
flax module's mean and value to 1e-5 of the output's scale (its largest
magnitude, at least 1) and the same log-std. The matmuls are float32
sums in another order (XLA's CPU dot also fuses multiply-adds); on N(0,
1) observations the largest differences are 3.8e-6 on means of scale
2.6 and 9.2e-5 on values of scale 295, about ten float32 ulps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.serialization import msgpack_restore as flax_restore

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu_torch.convert import actor_critic_from_flax
from gym_pybullet_adrp_tpu_torch.models.policy import (
    ActorCritic, gaussian_logp, sample_action,
)
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck

from _torch_port import REPO

ARTIFACTS = sorted(
    str(p.relative_to(REPO))
    for d in ("agents", "results") for p in (REPO / d).glob("*.msgpack")
)
ACTOR_CRITICS = [a for a in ARTIFACTS if "pixels" not in a]


def _same_tree(a, b, path="params"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def test_artifacts_found():
    assert len(ARTIFACTS) >= 10 and len(ACTOR_CRITICS) >= 9


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_msgpack_reader_matches_flax(artifact):
    data = (REPO / artifact).read_bytes()
    _same_tree(pck.msgpack_restore(data), flax_restore(data))


@pytest.mark.parametrize("artifact", ACTOR_CRITICS)
def test_actor_critic_matches_flax(artifact):
    params = pck.load_params(REPO / artifact)
    net = actor_critic_from_flax(params)
    p = params["params"]
    obs_dim = p["Dense_0"]["kernel"].shape[0]
    assert net.obs_dim == obs_dim and net.act_dim == 4
    fnet = FlaxAC(act_dim=4, hidden=net.hidden)
    obs = np.random.default_rng(0).normal(
        0.0, 1.0, (256, obs_dim)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    fmean, flog_std, fvalue = fnet.apply(jparams, jnp.asarray(obs))
    with torch.no_grad():
        mean, log_std, value = net(torch.from_numpy(obs))
    log_std = log_std.detach()
    for got, ref in ((mean, fmean), (value, fvalue)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= 1e-5 * scale, (artifact, err, scale)
    np.testing.assert_array_equal(log_std.numpy(), np.asarray(flog_std))


def test_load_policy_and_sampling():
    net = pck.load_policy(REPO / "results/level1_robust.msgpack",
                          device="cpu")
    assert isinstance(net, ActorCritic) and net.hidden == (64, 64)
    obs = torch.zeros((8, net.obs_dim))
    mean, log_std, _ = net(obs)
    gen = torch.Generator().manual_seed(0)
    act, logp = sample_action(mean, log_std, gen)
    assert act.shape == (8, 4) and logp.shape == (8,)
    torch.testing.assert_close(logp, gaussian_logp(act, mean, log_std))
    # reference formula (models/policy.gaussian_logp)
    std = np.exp(log_std.detach().numpy())
    z = (act - mean).detach().numpy() / std
    ref = (-0.5 * (z ** 2 + 2 * np.log(std) + np.log(2 * np.pi))).sum(-1)
    np.testing.assert_allclose(logp.detach().numpy(), ref, rtol=1e-5)


def test_reader_rejects_truncated_data():
    data = (REPO / ACTOR_CRITICS[0]).read_bytes()
    with pytest.raises(ValueError):
        pck.msgpack_restore(data[:-10])

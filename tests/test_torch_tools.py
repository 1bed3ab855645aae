"""Port: the training tools (utils/profiling.py, profile_ppo.py,
examples/learn.py, scaling.py) against the JAX package, on the CPU.

  profiling: the port's tests/test_utils.py:128 (steps/s > 0 in both
    timing modes, a positive real-time factor), a trace written, and
    ``census`` on functions whose counts are known exactly.
  profile_ppo.main at --envs 128 --n_steps 8, with and without
    --fuse_policy: all four phases printed, finite and positive.
  examples.learn.run(local=False, n_envs=16) (tests/test_examples.py:44):
    both artifacts written; best_model.msgpack read by flax's
    serialization into the JAX ActorCritic gives the port's mean action
    within 1e-5.
  scaling: dcn_model equal to the JAX function's numbers for the
    production rows; a 1- and 2-process --device cpu run writes the JAX
    script's JSON keys.
"""

import importlib.util
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.models.policy import ActorCritic as FlaxAC
from gym_pybullet_adrp_tpu_torch import profile_ppo, scaling
from gym_pybullet_adrp_tpu_torch.examples import learn
from gym_pybullet_adrp_tpu_torch.rl import checkpoint as pck
from gym_pybullet_adrp_tpu_torch.utils import profiling

from _torch_port import REPO
from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_profiling_measure_steps_per_sec():
    x = torch.ones(8)
    for pipelined in (True, False):
        sps, sec = profiling.measure_steps_per_sec(
            lambda v: v * 2.0, x, n_repeats=2, steps_per_call=16,
            pipelined=pipelined)
        assert sps > 0 and sec > 0
    assert profiling.RealTimeFactor().factor(1.0) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    assert json.loads((tmp_path / "tr/trace.json").read_text())


def test_count_ops_known_functions():
    """(a * b + c).sum() over 10 x 20: 200 + 200 elementwise and 200
    reduced; bytes op by op: 3 x 800 + 3 x 800 + 800 + 4. A (8, 16) x
    (16, 4) product: 2 m n k = 1024 with matmul counting, 0 without."""
    a, b, c = (torch.rand(10, 20) for _ in range(3))
    with profiling.OpCount() as oc:
        (a * b + c).sum()
    assert oc.ops == 600 and oc.bytes == 3 * 800 + 3 * 800 + 804
    m, n = torch.rand(8, 16), torch.rand(16, 4)
    oc = profiling.census(lambda: m @ n)
    assert (oc.ops, oc.flops) == (0, 1024)
    assert profiling.census(lambda: m @ n, matmul=False).flops == 0
    bias = torch.rand(4)
    oc = profiling.census(lambda: torch.addmm(bias, m, n))
    assert (oc.ops, oc.flops) == (0, 1024)
    bd = profiling.bound((a, b), (c,), 600)
    assert bd["bytes"] == 2400 and bd["bound_by"] == "bytes"
    assert bd["bound_ms"] == pytest.approx(2400 / profiling.PEAK_BYTES * 1e3)


@pytest.mark.parametrize("fuse", [False, True], ids=["step", "fuse_policy"])
def test_profile_ppo_prints_its_phases(capsys, fuse):
    argv = ["--device", "cpu", "--envs", "128", "--n_steps", "8",
            "--repeats", "1", "--rounds", "1"]
    if fuse:
        argv += ["--fuse_policy", "--kernel_chunk", "4"]
    out = profile_ppo.main(argv)
    text = capsys.readouterr().out
    for phase in ("env steps only", "rollout (env+policy)",
                  "update (train - rollout)", "full train iteration"):
        assert phase in text
        assert out["phases"][phase] > 0
    assert "operations" in text and "not measured" in text
    assert out["update_counts"]["ops"] > 0
    uc = out["update_counts"]
    assert uc["bytes"] > 0
    # the bound's bytes are each tensor's once, fewer than op by op
    assert 0 < uc["floor_bytes"] < uc["bytes"]
    assert uc["bound_ms"] >= uc["floor_bytes"] / profiling.PEAK_BYTES * 1e3


def test_learn_smoke(tmp_path):
    """The reference's CI size on the port; its policy artifact through
    flax's own reader."""
    from flax import serialization

    learn.run(multiagent=False, output_folder=str(tmp_path), gui=False,
              plot=False, local=False, n_envs=16, device="cpu")
    (save,) = tmp_path.glob("save-*")
    assert (save / "final_model.msgpack").is_file()
    best = save / "best_model.msgpack"
    net = pck.load_policy(best, device="cpu")
    assert (net.obs_dim, net.act_dim) == (27, 1)
    fnet = FlaxAC(act_dim=1)
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 27)))
    params = serialization.from_bytes(template, best.read_bytes())
    obs = np.random.default_rng(0).normal(0, 1, (16, 27)).astype(np.float32)
    jmean, _, _ = fnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, _, _ = net(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5)


def _jax_scaling():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling", REPO / "scripts/scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dcn_model_matches_jax():
    jsc = _jax_scaling()
    for _, compute_ms, syncs in scaling.PRODUCTION:
        for kw in ({}, dict(dcn_gbps=12.5, latency_us=60.0),
                   dict(dcn_gbps=12.5, latency_us=60.0, overlap_ms=2.5)):
            assert scaling.dcn_model(17993, syncs, compute_ms, **kw) == \
                jsc.dcn_model(17993, syncs, compute_ms, **kw)


def test_scaling_one_and_two_processes(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # one thread a rank
    out = tmp_path / "scaling.json"
    res = scaling.main(["--device", "cpu", "--nprocs", "1,2",
                        "--envs_per_dev", "8", "--total_dev", "2",
                        "--n_steps", "4", "--iters", "1", "--out", str(out)])
    data = json.loads(out.read_text())
    assert set(data) == {"measured_ppo", "measured_ppo_grad_accum",
                         "measured_allreduce", "dcn_model", "n_params",
                         "syncs_per_iter_measured"}
    jax_keys = {"nproc", "sec_per_iter", "global_devices", "global_batch",
                "n_params", "grad_accum", "grad_syncs_per_iter"}
    assert [r["nproc"] for r in data["measured_ppo"]] == [1, 2]
    for r in data["measured_ppo"] + data["measured_ppo_grad_accum"]:
        assert jax_keys <= set(r) and r["global_batch"] == 2 * 8 * 4
        assert math.isfinite(r["sec_per_iter"]) and r["sec_per_iter"] > 0
    assert "process_boundary_efficiency" in data["measured_ppo"][1]
    assert [r["grad_syncs_per_iter"]
            for r in data["measured_ppo_grad_accum"]] == [2, 2]
    (ar,) = data["measured_allreduce"]
    assert {"nproc", "sec_per_sync", "bytes", "global_devices"} <= set(ar)
    assert ar["bytes"] == scaling.N_ELEMS * 4 and ar["sec_per_sync"] > 0
    assert res["n_params"] == data["n_params"] == 17993
    assert set(data["dcn_model"]) == {n for n, _, _ in scaling.PRODUCTION}


@pytest.mark.slow
def test_learn_rgb_smoke(tmp_path):
    """obs="rgb": the conv actor-critic on drone 0's frames, its artifact
    and the RGB replay (~40 s here)."""
    best = learn.run(output_folder=str(tmp_path), plot=False, local=False,
                     n_envs=16, obs="rgb", device="cpu")
    (save,) = tmp_path.glob("save-*")
    net = pck.load_policy(save / "best_model.msgpack", device="cpu",
                          img=(learn.IMG_H, learn.IMG_W))
    assert net.act_dim == 1 and math.isfinite(best)

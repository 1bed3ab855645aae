"""Port: utils/roofline.py and its CLI (the counterpart of
utils/roofline.py and scripts/roofline.py, tests/test_roofline.py), and
the operation bound of utils/profiling.py, in the card's own currency.

* The stored ``OPS_PER_ENV_STEP`` and ``CAL_OPS_PER_ENV_STEP`` within 2%
  of a fresh ``OpCount`` census of the kernels' plain versions at B = 128
  (as tests/test_roofline.py:18-48 pins the JAX constants); the
  calibrated count never below the plain one.
* ``fp32_pct`` in (0, 100] at each case's speed of light and at half of
  it; ``roofline_pct``'s arithmetic.
* Each bytes formula equal to the bytes of the tensors the port's
  wrappers take and return (K2 ``hover_rollout``, K4
  ``race_step_fused``, K5 ``race_rollout`` in action mode) at B = 128 and
  256, 1 and 2 drones.
* ``bound`` adds pointwise operations and matrix-product flops / 2 over
  the FP32 issue rate; ``OpCount`` keeps the two apart; the op-chain
  count (K6) takes the chains' start and sum once, not once an
  iteration.
"""

import pytest
import torch

from gym_pybullet_adrp_tpu_torch import eval_race, op_calibrate
from gym_pybullet_adrp_tpu_torch import roofline as cli
from gym_pybullet_adrp_tpu_torch.envs.fast_hover import reset_packed
from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
from gym_pybullet_adrp_tpu_torch.ops import hover_step, race_rollout
from gym_pybullet_adrp_tpu_torch.ops import race_step
from gym_pybullet_adrp_tpu_torch.utils import profiling
from gym_pybullet_adrp_tpu_torch.utils import roofline as rf

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def cli_run():
    """The CLI's census and table (CPU), rates at half of each speed of
    light."""
    sol = {k: 0.5 * profiling.PEAK_FP32_OPS / v
           for k, v in rf.OPS_PER_ENV_STEP.items()}
    return cli.main(["--hover", str(sol["hover"]), "--race1",
                     str(sol["race1"]), "--race2", str(sol["race2"]),
                     "--device", "cpu"])


def test_constants_match_fresh_census(cli_run):
    drift, table = cli_run
    assert drift == 0
    for row in table:
        k = row["case"]
        for got, stored in ((row["ops"], rf.OPS_PER_ENV_STEP[k]),
                            (row["cal_ops"], rf.CAL_OPS_PER_ENV_STEP[k])):
            assert abs(got - stored) / stored < 0.02, (k, got, stored)
        # every calibrated weight is at least one issue
        assert row["cal_ops"] >= row["ops"]
        assert row["fp32_pct"] == pytest.approx(50.0)
        assert 0 < row["hbm_pct"] < 100 and 0 < row["fp32_cal_pct"] <= 100


def test_fp32_pct_is_a_share():
    for k, ops in rf.OPS_PER_ENV_STEP.items():
        sol = rf.H100["fp32_issues_per_s"] / ops
        by = rf.hover_rollout_bytes_per_step(4096) if k == "hover" else \
            rf.race_rollout_bytes_per_step(4096, int(k[-1]))
        pct = rf.roofline_pct(sol, ops, by)
        assert 0.0 < pct["fp32_pct"] <= 100.0 + 1e-9
        assert 0.0 < rf.roofline_pct(0.5 * sol, ops, by)["fp32_pct"] <= 50.0
        assert "fp32_cal_pct" not in pct
    pct = rf.roofline_pct(1e8, 900.0, 2.0, cal_ops=1300.0)
    assert pct["fp32_pct"] == 100 * 1e8 * 900 / profiling.PEAK_FP32_OPS
    assert pct["fp32_cal_pct"] == 100 * 1e8 * 1300 / profiling.PEAK_FP32_OPS
    assert pct["hbm_pct"] == 100 * 1e8 * 2.0 / profiling.PEAK_BYTES
    assert rf.H100["fp32_fma_flops_per_s"] == 2 * rf.H100[
        "fp32_issues_per_s"] == pytest.approx(6.69e13, rel=1e-3)


def test_calibrated_weights():
    w = rf.CAL_WEIGHTS
    assert rf.op_issues("aten.sin.default") == 2 * w["sin"]
    assert rf.op_issues("aten.clamp.default") == 4 * w["max"]
    assert rf.op_issues("aten.where.self") == 1.0
    assert rf.cal_ops({"aten.mul.Tensor": 10, "aten.eq.Scalar": 3}) == \
        pytest.approx(10 * 2 * w["mul"] + 3)


def _nbytes(inputs, outputs):
    return profiling.nbytes(*inputs) + profiling.nbytes(*outputs)


@pytest.mark.parametrize("B", [128, 256])
def test_hover_bytes_formula(B):
    P = drone_params(device="cpu")
    st = reset_packed([0.0, 0.0, 0.1125], B, device="cpu").packed
    out = hover_step.hover_rollout(P, st, 3, 4)
    assert rf.hover_rollout_bytes_per_step(B, 4) * 4 * B == \
        _nbytes((st,), out)


@pytest.mark.parametrize("B", [128, 256])
@pytest.mark.parametrize("nd", [1, 2])
def test_race_bytes_formulas(B, nd):
    env = eval_race.make_eval_env("getting_started", B, "cpu", seed=0,
                                  n_drones=nd)
    st, d = env.reset(), env.step_draws()
    A = env.action_rows(torch.zeros((B, nd, 4) if nd > 1 else (B, 4)))
    kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail)
    ins = (st.S, A, st.R, st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO)
    out = race_step.race_step_fused(env.kf, env.km, env.arm, env.ground_z,
                                    *ins, telemetry=False, **kw)
    assert rf.race_fused_bytes_per_step(B, nd) * B == _nbytes(ins, out)
    out = race_step.race_step_fused(env.kf, env.km, env.arm, env.ground_z,
                                    *ins, telemetry=True, **kw)
    assert rf.race_fused_bytes_per_step(B, nd, telemetry=True) * B == \
        _nbytes(ins, out)
    K = 2
    ds = env.stacked_draws(K)
    assert ds.RST.shape[0] == 1            # getting_started: static draws
    A_seq = torch.stack([A] * K)
    ins = (st.S, A_seq, st.R, st.GG, st.OO, st.EP, ds.RST, ds.RSTG, ds.RSTO)
    out = race_rollout.race_rollout(env.kf, env.km, env.arm, env.ground_z,
                                    *ins, emit_obs=False, telemetry=False,
                                    **kw)
    assert rf.race_rollout_bytes_per_step(B, nd, k_steps=K) * K * B == \
        _nbytes(ins, out)
    rst = tuple(torch.cat([x] * K) for x in (ds.RST, ds.RSTG, ds.RSTO))
    out = race_rollout.race_rollout(env.kf, env.km, env.arm, env.ground_z,
                                    *ins[:6], *rst, emit_obs=False,
                                    telemetry=False, **kw)
    assert rf.race_rollout_bytes_per_step(
        B, nd, k_steps=K, static_draws=False) * K * B == \
        _nbytes(ins[:6] + rst, out)


def test_bound_splits_pointwise_ops_from_matmul_flops():
    m, n, bias = torch.rand(8, 16), torch.rand(16, 4), torch.rand(4)
    c = profiling.census(lambda: torch.relu(torch.addmm(bias, m, n)))
    assert c.flops == 2 * 8 * 16 * 4 and c.ops == 32
    assert c.by_op["aten.addmm.default"] == c.flops
    bd = profiling.bound((m,), (n,), 1e9, flops=4e9)
    assert bd["bound_by"] == "operations" and bd["flops"] == 4e9
    assert bd["bound_ms"] == pytest.approx(3e9 / profiling.PEAK_FP32_OPS * 1e3)
    assert profiling.PEAK_FP32_OPS == pytest.approx(3.345e13, rel=1e-3)


def test_op_chain_count_takes_start_and_sum_once():
    """K6's fma chain: 16 x 8 links of a multiply and an add each
    iteration, the chains' start (8 x 2) and sum (7) once a launch."""
    x = torch.full((2, 128), 0.62)

    def count(n):
        return profiling.census(
            lambda: op_calibrate.op_chain_plain("fma", x, n)).ops

    one, two = count(1), count(2)
    per_elem = 16 * 8 * 2
    assert two - one == per_elem * x.numel()
    assert 2 * one - two == (8 * 2 + 7) * x.numel()
    iters = 256
    # counting one iteration's ops x iters repeats the start and the sum
    assert one * iters / ((2 * one - two) + (two - one) * iters) == \
        pytest.approx(279 * iters / (256 * iters + 23))

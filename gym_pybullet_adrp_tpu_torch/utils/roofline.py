"""Roofline accounting of the port's kernels on the card.

Counterpart of gym_pybullet_adrp_tpu/utils/roofline.py (the byte
formulas :154, :165, :193, ``roofline_pct`` :224, the census of the
benched kernels' math :416), in the card's own currency. A measured rate
in env-steps/s becomes a share of the card's peaks:

* **bytes per env-step**: what a launch must move, each operand the
  port's wrapper passes read once and each result written once (the
  ``(C, T, 128)`` row blocks the wrappers keep), over the launch's env
  steps; ``hbm_pct`` is that traffic's rate over HBM3's.
* **operations per env-step**: the plain version a kernel is held
  against, counted at B = 128 by ``utils/profiling.OpCount`` (one per
  output element of each pointwise op, one per input element of a
  reduction). The kernels are built with ``-fmad=false``, so each counted
  operation is at least one FP32 issue, and ``fp32_pct`` is the counted
  issues' rate over the card's issue rate (utils/profiling.py). A kernel
  running at the speed of light of its count reads 100; the count gives
  transcendentals one issue, so the share is a lower bound on the issue
  slots the kernel fills.
* **calibrated operations**: the same census with each op weighted by
  the issues the card spends on it, measured by the op-cost chains (K6,
  op_calibrate.py) relative to an unfused multiply-add pair (2 issues):
  ``fp32_cal_pct``, the best estimate of the share of issue slots used.

``OPS_PER_ENV_STEP`` and ``CAL_OPS_PER_ENV_STEP`` are stored constants;
``measure_ops_per_env_step`` recounts them (a few seconds), and a
test holds the stored values within 2% of a fresh count, so a change to a
kernel's math cannot leave them stale. The CLI:

    python -m gym_pybullet_adrp_tpu_torch.roofline [--hover RATE]
        [--race1 RATE] [--race2 RATE] [--envs 4096] [--device cuda]
"""

import torch

from ..ops.hover_step import ACT_CHANNELS, LANE, N_CHANNELS
from ..ops.race_step import (
    ACT_DIM, INFO_CHANNELS, R_CHANNELS, RST_CHANNELS, obs_channels,
)
from ..ops.race_window import S_CHANNELS
from .profiling import PEAK_BYTES, PEAK_FMA_FLOPS, PEAK_FP32_OPS, census

F32 = 4
CENSUS_ENVS = 128

H100 = {
    "card": "NVIDIA H100 80GB HBM3 (SXM5), 700 W",
    "hbm_bytes_per_s": PEAK_BYTES,
    "fp32_issues_per_s": PEAK_FP32_OPS,
    "fp32_fma_flops_per_s": PEAK_FMA_FLOPS,
    "sources": {
        "hbm_bytes_per_s": "H100 SXM5 data sheet, HBM3",
        "fp32_issues_per_s": "132 SMs x 128 FP32 lanes (Hopper "
                             "whitepaper) x 1.98 GHz boost: one pointwise "
                             "op an issue under -fmad=false",
        "fp32_fma_flops_per_s": "the data sheet's 67 TFLOP/s FP32: a fused "
                                "multiply-add as 2 flops (matrix products "
                                "only)",
    },
}

# Operations per env-step at B = 128 (``measure_ops_per_env_step``):
#   hover: one step of K2's plain step (ops/hover_step.rollout_step_plain,
#          the small-angle integrator and the e^2 < 1e-8 target test: the
#          headline's instantiation), the action injected (the in-kernel
#          Philox draw's integer work is not counted);
#   race1: K4's plain version (ops/race_step.race_step_fused_plain),
#          getting_started, 1 drone COMPARE, no telemetry;
#   race2: the same at 2 drones COMPETE (a step of both drones).
OPS_PER_ENV_STEP = {
    "hover": 1250.0,
    "race1": 15803.0,
    "race2": 31613.0,
}

# K6's per-op costs relative to the unfused multiply-add pair, as
# op_calibrate.calibrate() prints them, measured by chip_smoke.py phase 15
# on an NVIDIA H100 80GB HBM3 at a 700.00 W limit (the chains' fma pair
# ran at 1.665e13 pairs/s, 3.33e13 issues/s: the issue rate)
CAL_SOURCE = ("chip_smoke.py phase 15, op_calibrate.calibrate(), of the "
              "whole smoke run whose K6 weights PERF.md section 6 lists "
              "for the roofline (fma pair 1.665e13 pairs/s), NVIDIA H100 "
              "80GB HBM3, 700.00 W")
CAL_WEIGHTS = {
    "fma": 1.0, "mul": 0.5059, "add": 0.5057, "max": 0.9972, "div": 8.8019,
    "sqrt": 6.6084, "rsqrt": 3.9704, "sin": 19.0, "cos": 19.4314,
    "exp": 5.0299, "log": 14.8414, "tanh": 9.0508, "logistic": 13.5926,
}
# aten op -> (calibrated op, how many of it an element); every other
# pointwise op counts one issue, the floor
_CAL_OP = {
    "mul": ("mul", 1), "add": ("add", 1), "sub": ("add", 1),
    "rsub": ("add", 1), "div": ("div", 1), "sqrt": ("sqrt", 1),
    "rsqrt": ("rsqrt", 1), "sin": ("sin", 1), "cos": ("cos", 1),
    "exp": ("exp", 1), "log": ("log", 1), "tanh": ("tanh", 1),
    "sigmoid": ("logistic", 1), "maximum": ("max", 1),
    "minimum": ("max", 1), "clamp_min": ("max", 1),
    "clamp_max": ("max", 1), "clamp": ("max", 2),
}

# the census weighted by CAL_WEIGHTS (``cal_ops``)
CAL_OPS_PER_ENV_STEP = {
    "hover": 1272.3,
    "race1": 21894.4,
    "race2": 43795.9,
}


def op_issues(name: str, weights=CAL_WEIGHTS) -> float:
    """FP32 issues an element of aten op ``name`` (``OpCount.by_op``'s
    key, "aten.sin.default") costs by the calibration ``weights``: twice
    the op's weight against the multiply-add pair, or 1 where the
    calibration has no chain for the op."""
    op = name.split(".")[1] if name.startswith("aten.") else name
    if op not in _CAL_OP:
        return 1.0
    cal, n = _CAL_OP[op]
    return 2.0 * weights[cal] / weights["fma"] * n


def cal_ops(by_op, weights=CAL_WEIGHTS) -> float:
    """The calibrated issues of a census's ``by_op`` counts."""
    return sum(n * op_issues(name, weights) for name, n in by_op.items())


# ---------------------------------------------------------------------------
# bytes per env-step, from the operands the wrappers pass


def _rows(n, n_envs):
    return n * n_envs * F32     # n rows of (n_envs / 128, 128) float32


def hover_rollout_bytes_per_step(n_envs: int, n_steps: int = 64) -> float:
    """Bytes per env-step of ops/hover_step.hover_rollout (K2) with its
    in-kernel draws: the packed state (13, T, 128) in, the state and the
    summed reward (T, 128) out, over ``n_steps`` steps of ``n_envs`` envs
    (the seed is a kernel argument, not memory)."""
    return _rows(2 * N_CHANNELS + 1, n_envs) / (n_steps * n_envs)


def _race_dims(n_envs, n_drones, n_gates, n_obstacles, compete):
    if compete is None:
        compete = n_drones > 1
    C = obs_channels(n_drones, n_gates, n_obstacles, compete)
    state_agent = S_CHANNELS + R_CHANNELS          # (., T, 128) rows
    state_env = 3 * n_gates + 2 * n_obstacles + 1  # GG, OO, EP: (., Tb, 128)
    reset_env = 3 * n_gates + 2 * n_obstacles      # RSTG, RSTO
    return C, state_agent, state_env, reset_env


def race_fused_bytes_per_step(n_envs: int, n_drones: int = 1,
                              n_gates: int = 4, n_obstacles: int = 4,
                              compete: bool = None,
                              telemetry: bool = False) -> float:
    """Bytes per env-step of ops/race_step.race_step_fused (K4), one
    launch a step, no policy, no disturbances. Agent rows (T = N * n_envs
    / 128 of 128): in S 58, A 4, R 14, RST 10; out S, R, OBS C, REW 1
    (and INFO 5). Env rows (n_envs / 128 of 128): in GG 3G, OO 2O, EP 1,
    RSTG 3G, RSTO 2O; out GG, OO, EP, DONE 1."""
    N = n_drones
    C, sa, se, re = _race_dims(n_envs, N, n_gates, n_obstacles, compete)
    agent_in = sa + ACT_DIM + RST_CHANNELS
    agent_out = sa + C + 1 + (INFO_CHANNELS if telemetry else 0)
    env_rows = se + re + se + 1
    return (_rows(N * (agent_in + agent_out), n_envs)
            + _rows(env_rows, n_envs)) / n_envs


def race_rollout_bytes_per_step(n_envs: int, n_drones: int = 1,
                                n_gates: int = 4, n_obstacles: int = 4,
                                k_steps: int = 32, compete: bool = None,
                                static_draws: bool = True) -> float:
    """Bytes per env-step of ops/race_rollout.race_rollout (K5) in action
    mode without obs (the benchmark's): the state (S, R; GG, OO, EP) in
    once and out once a launch, the actions (K, 4, T, 128) in, REW (K, T,
    128) and DONE (K, n_envs / 128, 128) out, the reset rows (RST; RSTG,
    RSTO) once a launch for a deterministic config (``static_draws``, a
    (1, ...) block) or once a step."""
    N, K = n_drones, k_steps
    _, sa, se, re = _race_dims(n_envs, N, n_gates, n_obstacles, compete)
    n_rst = 1 if static_draws else K
    agent = 2 * sa + K * ACT_DIM + n_rst * RST_CHANNELS + K
    env_rows = 2 * se + n_rst * re + K
    return (_rows(N * agent, n_envs) + _rows(env_rows, n_envs)) / (
        K * n_envs)


# ---------------------------------------------------------------------------
# shares of the peaks


def roofline_pct(env_steps_per_s: float, ops: float, bytes_per_step: float,
                 cal_ops: float = None) -> dict:
    """Shares of the card's peaks (%) at a measured rate: ``fp32_pct``,
    the counted operations' issues a second over the FP32 issue rate (100
    at the count's speed of light); ``hbm_pct``, the bytes a second over
    HBM3's rate; with ``cal_ops``, ``fp32_cal_pct``, the calibrated
    issues a second over the issue rate."""
    out = {
        "fp32_pct": 100.0 * env_steps_per_s * ops / PEAK_FP32_OPS,
        "hbm_pct": 100.0 * env_steps_per_s * bytes_per_step / PEAK_BYTES,
    }
    if cal_ops is not None:
        out["fp32_cal_pct"] = (100.0 * env_steps_per_s * cal_ops
                               / PEAK_FP32_OPS)
    return out


# ---------------------------------------------------------------------------
# the census


def census_cases(device="cuda"):
    """(name, fn) of the counted cases at B = 128 on ``device``, each
    ``fn()`` one env-step of the plain version for the whole batch."""
    from .. import eval_race
    from ..envs.fast_hover import reset_packed
    from ..models.drone import drone_params
    from ..ops import hover_step as hs
    from ..ops import race_step as rs
    from .enums import DroneModel

    B, T = CENSUS_ENVS, CENSUS_ENVS // LANE
    c = hs.hover_consts(drone_params(DroneModel.CF2X, device=device))
    ch = list(reset_packed([0.0, 0.0, 0.1125], B, device=device).packed)
    a = torch.zeros((ACT_CHANNELS, T, LANE), device=device)
    steps = torch.zeros((T, LANE), dtype=torch.int32, device=device)
    acc = torch.zeros((T, LANE), device=device)
    yield "hover", lambda: hs.rollout_step_plain(c, ch, a, steps, acc,
                                                 True, False)
    for n, name in ((1, "race1"), (2, "race2")):
        env = eval_race.make_eval_env("getting_started", B, device, seed=0,
                                      n_drones=n)
        st, d = env.reset(), env.step_draws()
        A = env.action_rows(torch.zeros((B, n, 4) if n > 1 else (B, 4),
                                        device=device))
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows=d.noise_rows, telemetry=False)
        yield name, (lambda env=env, st=st, d=d, A=A, kw=kw:
                     rs.race_step_fused_plain(
                         env.kf, env.km, env.arm, env.ground_z, st.S, A,
                         st.R, st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO,
                         **kw))


@torch.no_grad()
def measure_ops_per_env_step(device="cuda", weights=CAL_WEIGHTS,
                             verbose=False):
    """Recount ``OPS_PER_ENV_STEP`` and ``CAL_OPS_PER_ENV_STEP`` (by
    ``weights``). Returns {"ops": {case: ops}, "cal_ops": {case: issues},
    "by_op": {case: {aten op: count}}}, all per env-step."""
    out = {"ops": {}, "cal_ops": {}, "by_op": {}}
    for name, fn in census_cases(device):
        c = census(fn)
        by_op = {k: v / CENSUS_ENVS for k, v in c.by_op.items()}
        out["ops"][name] = (c.ops + c.flops / 2) / CENSUS_ENVS
        out["cal_ops"][name] = cal_ops(by_op, weights) + (
            c.flops / 2 / CENSUS_ENVS)
        out["by_op"][name] = by_op
        if verbose:
            top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
            print(f"[census] {name}: {out['ops'][name]:.0f} ops, "
                  f"{out['cal_ops'][name]:.0f} calibrated issues a step; "
                  + "  ".join(f"{k.split('.')[1]}={v:.0f}" for k, v in top))
    return out

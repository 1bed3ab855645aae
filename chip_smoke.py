"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the race env and
trainer, then the hover env family.

Builds the port's kernels from gym_pybullet_adrp_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, evaluates the shipped
level1 policy through the port's serving path (the fused race step
kernel, and the window kernel + plain tail), times the fused step; then
holds the step kernel's policy option against its plain version, the
K-step rollout kernel against K launches of the step kernel, and the
card's PPO update against the CPU's, trains a race policy at full width
through the policy-in-kernel rollout (and, briefly, through the other
two rollout paths), saves, reloads and evaluates it, and times the
rollout kernel. Then the hover kernels (12-15): the control-step kernel
against its plain version and through fast_hover.make_step at bench.py's
``--impl pallas`` workload; the rollout kernel against its plain version
(injected and random draws, both integrators), its random draws' law, and
bench.py's headline workload; the A/B variants against the rollout
kernel's instantiations; the op-cost chains and the card's per-op
calibration. Phase 16 trains hover PPO through the control-step kernel
and through the RL hover env. Every phase prints its lines; any failed
phase exits non-zero without the final result line.

Usage (needs one CUDA device and nvcc; no JAX):
  python3 chip_smoke.py [--out DIR]

``--out`` also writes the nvcc/ptxas report and the metrics there.
"""

import argparse
import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent

# tolerances of kernel vs plain version on the same card and inputs. Both
# round every + - * / and sqrt alike (the kernels are built -fmad=false);
# only sinf/cosf may differ in the last bit, which the firmware's
# D-term amplifies over the 20-tick window.
TOL = {
    "pos/quat/vel": 1e-4,      # abs
    "omega/rpy": 1e-3,         # abs
    "rpm/lpf/int/ctl": 1e-4,   # rel to max(|x|, 1)
    "obs": 1e-3,               # abs
    "reward": 1e-3,            # abs
}
# the policy's outputs (tanhf/expf, libm on both sides)
POLICY_TOL = 1e-5            # abs, ACT/LOGP/VAL
# the card's PPO epoch against the CPU's, per tensor: max |diff| over
# max(1, max |param|); stated before the first run
PPO_TOL = 1e-5
# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
S_GROUPS = {
    "pos/quat/vel": [*range(0, 10), 24, 25, 26],
    "omega/rpy": [10, 11, 12, 21, 22, 23],
    "rpm/lpf/int/ctl": [*range(13, 21), *range(27, 53)],
    "tick/gating": [53, 54, 55, 56, 57],
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def compare_s(name, got, ref):
    """Per channel group errors of an S block; raises past tolerance."""
    errs = {}
    for grp, chans in S_GROUPS.items():
        g, r = got[chans], ref[chans]
        check(torch.isfinite(g).all().item(), f"{name}: non-finite {grp}")
        d = (g - r).abs()
        if grp == "tick/gating":
            errs[grp] = float(d.max())
            check(errs[grp] == 0.0, f"{name}: {grp} differs ({errs[grp]})")
        elif grp == "rpm/lpf/int/ctl":
            rel = d / torch.clamp_min(r.abs(), 1.0)
            errs[grp] = float(rel.max())
            check(errs[grp] <= TOL[grp],
                  f"{name}: {grp} rel err {errs[grp]} > {TOL[grp]}")
        else:
            errs[grp] = float(d.max())
            check(errs[grp] <= TOL[grp],
                  f"{name}: {grp} abs err {errs[grp]} > {TOL[grp]}")
    return errs


class OpCount(TorchDispatchMode):
    """Counts the operations a plain version performs: one per output
    element of every elementwise aten op (tagged pointwise), one per
    input element of a reduction."""

    REDUCTIONS = ("aten.amin", "aten.amax", "aten.sum", "aten.mean")

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise in func.tags:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.ops += sum(o.numel() for o in outs
                            if isinstance(o, torch.Tensor))
        elif str(func).startswith(self.REDUCTIONS):
            self.ops += args[0].numel()
        return out


def count_ops(fn):
    with OpCount() as c:
        fn()
    return c.ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(inputs, outputs, ops):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM's rate and
    the operations over the float32 peak."""
    b = nbytes(*inputs) + nbytes(*outputs)
    t_b, t_o = b / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": b, "ops": ops}


STEP_OUT = ("S", "R", "GG", "OO", "EP", "OBS", "REW", "DONE", "INFO",
            "ACT", "LOGP", "VAL")
ROLL_OUT = ("S", "R", "GG", "OO", "EP", "REW", "DONE", "OBS", "INFO", "ACT",
            "LOGP", "VAL")


def check_step(name, got, ref):
    """Hold a kernel's outputs (dicts by output name; sequences may carry
    a leading K axis) against its plain version's with ``TOL``; returns
    the errors and the largest absolute difference of any block."""
    compare_s(name + " S", got["S"], ref["S"])
    for k in got:
        check(got[k].shape == ref[k].shape, f"{name} {k} shape")
        check(torch.isfinite(got[k]).all().item(), f"{name} {k} non-finite")
    check(torch.equal(got["R"][:4], ref["R"][:4]),
          f"{name}: discrete R rows differ")
    errs = {"R": float((got["R"][4:] - ref["R"][4:]).abs().max())}
    check(errs["R"] <= TOL["pos/quat/vel"], f"{name}: R rows err {errs['R']}")
    for k, tol in (("OBS", TOL["obs"]), ("REW", TOL["reward"]),
                   ("ACT", POLICY_TOL), ("LOGP", POLICY_TOL),
                   ("VAL", POLICY_TOL)):
        if k in got:
            errs[k] = float((got[k] - ref[k]).abs().max())
            check(errs[k] <= tol, f"{name}: {k} err {errs[k]} > {tol}")
    for k in ("GG", "OO", "EP", "DONE", "INFO"):
        if k in got:
            check(torch.equal(got[k], ref[k]), f"{name}: {k} differs")
    errs["max"] = max(float((got[k] - ref[k]).abs().max()) for k in got)
    return errs


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def traced(fn):
    """Run ``fn`` under torch.profiler; returns (host wall ms, [(event,
    count, device us)]) for device-side events only (kernels, copies,
    memsets): a host op's device total repeats the time of the kernels it
    launched. One name may appear in several rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(ev.key, ev.count, ev.device_time_total)
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA
                  and ev.device_time_total]


def kernel_time(events, kernel):
    """(launches, device ms) of ``kernel`` in ``traced``'s events."""
    hits = [(c, us) for k, c, us in events if kernel in k]
    return sum(c for c, _ in hits), sum(us for _, us in hits) / 1e3


def kernel_ms(fn, kernel, n=20):
    """Mean device time of one launch of ``kernel`` over ``n`` calls of
    ``fn`` (the host's cost excluded), or None when the trace has no device
    time for it."""
    fn()

    def loop():
        for _ in range(n):
            fn()

    _, events = traced(loop)
    count, ms = kernel_time(events, kernel)
    return ms / count if count else None


def device_ms(fn, n=20, sleep_cycles=20_000_000):
    """Device time per call of ``fn``: ``n`` calls queued behind a spin
    kernel (``torch.cuda._sleep``), so that the host has queued every
    launch before the card reaches the first and the events time the
    launches back to back, without the host's gaps. The spin is doubled
    until it outlasts the host's queueing (at most 4 times)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(sleep_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n
        sleep_cycles *= 2
    raise PhaseError(f"device_ms: the host queued {n} calls in {host_ms} ms, "
                     "longer than the spin")


def profile_steps(env, rows, draws, kw, step_fn, n=64):
    """Host wall time, the kernel's traced launches and their device time,
    and the device's idle share over ``n`` steps ("not measured" when the
    trace has no device time). The trace may miss launches, so the busy
    time is ``n`` times the mean traced launch: the loop runs nothing else
    on the device."""
    st = env.reset()

    def loop():
        nonlocal st
        for i in range(n):
            out = step_fn(env.kf, env.km, env.arm, env.ground_z, st.S,
                          rows[i], st.R, st.GG, st.OO, st.EP, draws.RST,
                          draws.RSTG, draws.RSTO, **kw)
            st = st._replace(S=out[0], R=out[1], GG=out[2], OO=out[3],
                             EP=out[4])

    wall, events = traced(loop)
    count, kern = kernel_time(events, "race_step_kernel")
    if not count:
        return {"wall_ms": wall, "launches": 0, "kernel_ms": "not measured",
                "idle_share": "not measured"}
    return {"wall_ms": wall, "launches": count, "kernel_ms": kern,
            "idle_share": max(0.0, 1.0 - n * kern / count / wall)}


class PlainCalls:
    """Counts calls of the plain versions while it is entered: a path on
    the card must make none."""

    NAMES = (("race_step", "race_step_fused_plain"),
             ("race_step", "policy_forward_plain"),
             ("race_window", "race_window_plain"),
             ("race_rollout", "race_rollout_plain"),
             ("race_rollout", "step_core_plain"),
             ("hover_step", "ctrl_step_packed_plain"),
             ("hover_step", "rollout_plain"),
             ("hover_variants", "rollout_plain"),
             ("op_calibrate", "op_chain_plain"))

    def __init__(self, **mods):
        self.mods = mods
        self.calls = {}

    def __enter__(self):
        self.orig = {}
        for mod, name in self.NAMES:
            fn = getattr(self.mods[mod], name)
            self.orig[(mod, name)] = fn
            self.calls[f"{mod}.{name}"] = 0

            def wrapped(*a, _fn=fn, _key=f"{mod}.{name}", **k):
                self.calls[_key] += 1
                return _fn(*a, **k)

            setattr(self.mods[mod], name, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.orig.items():
            setattr(self.mods[mod], name, fn)


class LaunchCount(dict):
    """Sets every kernel's launch count to 0 on entry; on exit holds the
    launches made inside, by kernel (the step kernel with and without its
    policy option apart), and adds them to ``totals``. ``kernels`` maps
    each kernel's name to its wrapper."""

    def __init__(self, kernels, totals):
        super().__init__()
        self.fns = kernels
        self.totals = totals

    def __enter__(self):
        for fn in self.fns.values():
            fn.launches = 0
        self.fns["race_step_fused"].policy_launches = 0
        return self

    def __exit__(self, *exc):
        for name, fn in self.fns.items():
            self[name] = fn.launches
        step = self.fns["race_step_fused"]
        self["race_step_fused"] -= step.policy_launches
        self["race_step_fused[policy]"] = step.policy_launches
        for k, v in self.items():
            self.totals[k] += v


def policy_pack(env, hidden, seed=3):
    """The pack of a random ActorCritic (log_std -1: calm flights)."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        pack_policy_params,
    )
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    net = ActorCritic(env.obs_size, 4, hidden,
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.log_std.fill_(-1.0)
    return pack_policy_params(net.to(env.device))


def k_steps(race_step, env, st, d, K, A=None, pack=None, obs=None,
            actn=None, hidden=(64, 64), telemetry=True):
    """K race_step launches with a rollout's inputs; returns the outputs
    stacked as race_rollout returns them (dict by ``ROLL_OUT`` name)."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    def at(x, k):
        return None if x is None else x[k if x.shape[0] > 1 else 0]

    outs = []
    for k in range(K):
        pol = ({} if pack is None else
               dict(policy_pack=pack, obs_rows=obs, actn=actn[k],
                    policy_hidden=hidden))
        o = race_step.race_step_fused(
            env.kf, env.km, env.arm, env.ground_z, st.S,
            None if A is None else A[k], st.R, st.GG, st.OO, st.EP,
            at(d.RST, k), at(d.RSTG, k), at(d.RSTO, k),
            n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
            noise_rows=at(d.noise_rows, k), telemetry=telemetry, **pol)
        st, obs = RowRaceState(*o[:5]), o[5]
        outs.append(dict(zip(STEP_OUT, o)))
    res = dict(zip(("S", "R", "GG", "OO", "EP"), st))
    for name in outs[0]:
        if name not in res:
            res[name] = torch.stack([o[name] for o in outs])
    return res


def phase7(dev, gen, eval_race, race_step, n_envs):
    """race_step with its policy option against the plain version: three
    consecutive steps of getting_started 1-drone and twogates 2-drone
    COMPETE at 64-64, one step at 256-128, each from the same inputs."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    res = {"max_abs_err": 0.0}
    for cfg, nd, hidden, n_cmp in (("getting_started", 1, (64, 64), 3),
                                   ("twogates", 2, (64, 64), 3),
                                   ("getting_started", 1, (256, 128), 1)):
        env = eval_race.make_eval_env(cfg, n_envs, dev, seed=8, n_drones=nd)
        pack = policy_pack(env, hidden)
        st = env.reset()
        obs = env.initial_obs_rows(st)
        for i in range(10 + n_cmp):
            actn = torch.randn((4, env.T, 128), generator=gen, device=dev)
            d = env.step_draws()
            args = (env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R,
                    st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO)
            kw = dict(n_ticks=env.n_ticks, dt=env.dt,
                      spec_tail=env.spec_tail, noise_rows=d.noise_rows,
                      telemetry=True, policy_pack=pack, obs_rows=obs,
                      actn=actn, policy_hidden=hidden)
            out = race_step.race_step_fused(*args, **kw)
            if i >= 10:
                ref = race_step.race_step_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                name = (f"race_step[policy {hidden[0]}-{hidden[1]}, {cfg} "
                        f"N={nd} step {i}]")
                errs = check_step(name, dict(zip(STEP_OUT, out)),
                                  dict(zip(STEP_OUT, ref)))
                res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
                print(f"[7] {name}: ACT err {errs['ACT']:.3g}, LOGP err "
                      f"{errs['LOGP']:.3g}, VAL err {errs['VAL']:.3g}, OBS "
                      f"err {errs['OBS']:.3g}, REW err {errs['REW']:.3g} "
                      f"(tol {POLICY_TOL} on ACT/LOGP/VAL, phase 4's on the "
                      f"rest)", flush=True)
                out = ref
            st, obs = RowRaceState(*out[:5]), out[5]
        if (cfg, hidden) == ("getting_started", (64, 64)):
            # the shape of the trainer's one-launch-per-step path
            kw_t = dict(kw, telemetry=False)
            inputs = args + (pack, obs, actn)

            def kern():
                return race_step.race_step_fused(*args, **kw_t)

            def plain():
                return race_step.race_step_fused_plain(*args, **kw_t)

            res["ms"] = (kernel_ms(kern, "race_step_kernel")
                         or cuda_ms(kern, 20))
            res["plain_ms"] = cuda_ms(plain, 2, warmup=1)
            res.update(bound(inputs, plain(), count_ops(plain)))
            print(f"[7] race_step with the policy, getting_started 1 drone, "
                  f"{n_envs} envs, 64-64: {res['ms']} ms on the device, "
                  f"plain {res['plain_ms']:.4g} ms, bound "
                  f"{res['bound_ms']:.4g} ms ({res['bound_by']}: "
                  f"{res['ops']:.4g} ops, {res['bytes']:.4g} B)", flush=True)
    return res


def phase8(dev, gen, eval_race, race_step, race_rollout, n_envs):
    """race_rollout against K race_step launches (bit for bit) in action
    mode (K=3) and policy mode (K=16), and against its plain version
    (K=3); times the trainer's K=16 policy launch."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    res = {"max_abs_err": 0.0}
    cases = [("getting_started", 1, 3, False),
             ("getting_started", 2, 3, False), ("level2", 1, 3, False),
             ("getting_started", 1, 16, True)]
    for cfg, nd, K, policy in cases:
        env = eval_race.make_eval_env(cfg, n_envs, dev, seed=9, n_drones=nd)
        st = env.reset()
        for _ in range(5):
            a = torch.rand((n_envs, nd, 4) if nd > 1 else (n_envs, 4),
                           generator=gen, device=dev) * 2 - 1
            st = env.step(st, a)[0]
        obs = env.initial_obs_rows(st)
        seq = torch.rand((K, 4, env.T, 128), generator=gen,
                         device=dev) * 2 - 1
        d = env.stacked_draws(K)
        pack = policy_pack(env, (64, 64)) if policy else None
        pol = ({} if pack is None else
               dict(policy_pack=pack, obs_rows=obs, actn_seq=seq))
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  noise_rows_seq=d.noise_rows, telemetry=True)
        A = None if policy else seq
        args = (env.kf, env.km, env.arm, env.ground_z, st.S, A, st.R, st.GG,
                st.OO, st.EP, d.RST, d.RSTG, d.RSTO)
        got = dict(zip(ROLL_OUT, race_rollout.race_rollout(*args, **pol,
                                                           **kw)))
        ref = k_steps(race_step, env, st, d, K, A=A, pack=pack, obs=obs,
                      actn=seq)
        torch.cuda.synchronize()
        name = (f"race_rollout[{'policy' if policy else 'actions'}, {cfg} "
                f"N={nd}, K={K}]")
        check(got.keys() == ref.keys(), f"{name}: outputs {list(got)}")
        for k in got:
            check(torch.equal(got[k], ref[k]), f"{name}: {k} differs from "
                  f"{K} race_step launches")
        print(f"[8] {name}: equal to {K} race_step launches, bit for bit "
              f"({sorted(got)})", flush=True)
        if cfg == "level2":
            plain = dict(zip(ROLL_OUT, race_rollout.race_rollout_plain(
                *args, **pol, **kw)))
            errs = check_step(name + " vs plain", got, plain)
            res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
            print(f"[8] {name} vs its plain version: OBS err "
                  f"{errs['OBS']:.3g}, REW err {errs['REW']:.3g}, max abs "
                  f"err {errs['max']:.3g}", flush=True)
        if policy:
            # vs plain on the first 3 steps, then the trainer's launch
            k3 = dict(pol, actn_seq=seq[:3])
            d3 = type(d)(None, d.RST[:3], d.RSTG[:3], d.RSTO[:3])
            args3 = args[:10] + (d3.RST, d3.RSTG, d3.RSTO)
            kw3 = dict(kw, noise_rows_seq=None)
            got3 = dict(zip(ROLL_OUT, race_rollout.race_rollout(
                *args3, **k3, **kw3)))
            plain3 = dict(zip(ROLL_OUT, race_rollout.race_rollout_plain(
                *args3, **k3, **kw3)))
            errs = check_step(name + " K=3 vs plain", got3, plain3)
            res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
            print(f"[8] race_rollout[policy, K=3] vs its plain version: ACT "
                  f"err {errs['ACT']:.3g}, VAL err {errs['VAL']:.3g}, OBS "
                  f"err {errs['OBS']:.3g}, max abs err {errs['max']:.3g}",
                  flush=True)
            kw_t = dict(kw, telemetry=False)

            def kern():
                return race_rollout.race_rollout(*args, **pol, **kw_t)

            def plain_fn():
                return race_rollout.race_rollout_plain(*args, **pol, **kw_t)

            res["ms"] = (kernel_ms(kern, "race_rollout_kernel", n=5)
                         or cuda_ms(kern, 5))
            res["plain_ms"] = cuda_ms(plain_fn, 1, warmup=0)
            # the plain rollout is K identical plain steps: count one
            step_ops = count_ops(lambda: race_rollout.race_rollout_plain(
                *args3[:5], None, *args3[6:10], d.RST[:1], d.RSTG[:1],
                d.RSTO[:1], **dict(pol, actn_seq=seq[:1]), **kw_t))
            res.update(bound(args + (pack, obs, seq), kern(),
                             K * step_ops))
            print(f"[8] race_rollout[policy, getting_started 1 drone, "
                  f"{n_envs} envs, K={K}]: {res['ms']} ms on the device per "
                  f"launch, plain {res['plain_ms']:.4g} ms, bound "
                  f"{res['bound_ms']:.4g} ms ({res['bound_by']}: "
                  f"{res['ops']:.4g} ops, {res['bytes']:.4g} B)", flush=True)
    return res


def phase9(dev, n_envs):
    """One PPO epoch (8 minibatches) on the card and on the CPU from the
    same params, trajectory (a 4096 x 64 policy rollout on the card) and
    block permutation."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        make_policy_rollout,
    )
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    r = train_race.train(config="getting_started", n_envs=n_envs, n_steps=64,
                         iters=0, fuse_policy=True, device=dev, log_every=0)
    cfg, ts = r["cfg"], r["ts"]
    _, override, _ = make_policy_rollout(r["env"], cfg.n_steps, 16)
    ts, traj, _ = override(ts)
    take = torch.randperm(cfg.batch_size // cfg.shuffle_block,
                          generator=torch.Generator().manual_seed(0))
    out = {}
    for name, net in (("cpu", copy.deepcopy(ts.params).cpu()),
                      ("cuda", ts.params)):
        dv = next(net.parameters()).device
        tr = type(traj)(*[x.to(dv) for x in traj])
        t0 = time.perf_counter()
        with torch.no_grad():
            adv, ret = ppo.compute_gae(cfg, tr, net(ts.last_obs.to(dv))[2])
        tx = ppo.ClipAdam(cfg.lr, cfg.max_grad_norm)
        opt, losses = ppo.minibatch_epoch(
            cfg, tx, net, tx.init(list(net.parameters())), tr, adv, ret,
            take.to(dv))
        if dv.type == "cuda":
            torch.cuda.synchronize()
        out[name] = ([p.detach().cpu() for p in net.parameters()],
                     torch.stack(losses).cpu(), adv.cpu(),
                     time.perf_counter() - t0)
    errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for a, b in zip(out["cuda"][0], out["cpu"][0])]
    adv_err = float((out["cuda"][2] - out["cpu"][2]).abs().max()
                    / out["cpu"][2].abs().max())
    loss_err = float(((out["cuda"][1] - out["cpu"][1]).abs()
                      / out["cpu"][1].abs()).max())
    print(f"[9] one PPO epoch (GAE + 8 minibatches of {cfg.batch_size // 8}, "
          f"same params, trajectory and permutation): params on the card "
          f"vs on the CPU max |diff| / max(1, |p|) = {max(errs):.3g} (tol "
          f"{PPO_TOL}); advantages rel err {adv_err:.3g}; losses rel err "
          f"{loss_err:.3g}; card {out['cuda'][3]:.3f} s, CPU "
          f"{out['cpu'][3]:.3f} s", flush=True)
    check(max(errs) <= PPO_TOL, f"PPO epoch: card vs CPU {max(errs)}")
    return {"params_rel_err": max(errs), "adv_rel_err": adv_err,
            "loss_rel_err": loss_err}


def phase10(dev, gpu, eval_race, kernels, plain, totals, n_envs=4096,
            iters=40):
    """Train getting_started at 4096 envs through race_rollout with the
    policy inside (40 iterations), then briefly through race_step with
    and without the policy; save, reload and evaluate the policy."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.rl import checkpoint as ckpt

    mods = (kernels, totals)
    kw = dict(config="getting_started", n_envs=n_envs, n_steps=64,
              hidden=(64, 64), shuffle_block=512, device=dev, log_every=10)
    t0 = time.perf_counter()
    with plain, LaunchCount(*mods) as la:
        res = train_race.train(kernel_chunk=16, fuse_policy=True,
                               iters=iters, **kw)
    wall = time.perf_counter() - t0
    m, times, cfg = res["metrics"], res["times"], res["cfg"]
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_rollout"] == 4 * iters and la["race_step_fused"] == 0
          and la["race_step_fused[policy]"] == 0,
          f"training launches {dict(la)}")
    check(all(math.isfinite(x["loss"]) for x in m), "a non-finite loss")
    first = sum(x["mean_reward"] for x in m[:5]) / 5
    last = sum(x["mean_reward"] for x in m[-5:]) / 5
    steady = times[1:]
    phase_ms = {k: 1e3 * sum(t[k] for t in steady) / len(steady)
                for k in steady[0]}
    rate = cfg.batch_size / (phase_ms["iteration"] / 1e3)
    print(f"[10] train(getting_started, {n_envs} envs, 64 steps, 64-64, "
          f"kernel_chunk=16, fuse_policy, {iters} iters) in {wall:.1f} s: "
          f"launches {dict(la)}; mean reward first 5 iters {first:.5g}, "
          f"last 5 {last:.5g}; ms per iteration (iterations 2-{iters}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in phase_ms.items())
          + f"; {rate:.6g} env-steps/s on {gpu}", flush=True)
    check(last > first, f"mean reward did not rise ({first} -> {last})")
    # the device's idle share over one traced iteration
    t_wall, events = traced(lambda: res["train_step"](res["ts"]))
    busy = sum(us for _, _, us in events) / 1e3
    top = sorted(events, key=lambda e: -e[2])[:5]
    idle = max(0.0, 1.0 - busy / t_wall)
    print(f"[10] one traced iteration: wall {t_wall:.4g} ms, device busy "
          f"{busy:.4g} ms (idle share {idle:.3f}); top device time: "
          + "; ".join(f"{k[:40]} x{c} {us / 1e3:.4g} ms" for k, c, us in top),
          flush=True)

    with plain, LaunchCount(*mods) as la0:
        res0 = train_race.train(kernel_chunk=0, fuse_policy=True, iters=2,
                                **kw)
    check(la0["race_step_fused[policy]"] == 2 * 64
          and la0["race_rollout"] == 0, f"kernel_chunk=0: {dict(la0)}")
    with plain, LaunchCount(*mods) as la1:
        res1 = train_race.train(fuse_policy=False, iters=5, **kw)
    check(la1["race_step_fused"] == 5 * 64
          and la1["race_step_fused[policy]"] == 0,
          f"policy outside: {dict(la1)}")
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    alt_ms = {}
    for label, r in (("kernel_chunk=0", res0), ("fuse_policy=False", res1)):
        st = r["times"][1:]
        alt_ms[label] = {k: 1e3 * sum(t[k] for t in st) / len(st)
                         for k in st[0]}
        print(f"[10] {label}: launches "
              f"{dict(la0 if r is res0 else la1)}; ms per iteration "
              + ", ".join(f"{k} {v:.4g}" for k, v in alt_ms[label].items()),
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt.save_policy(Path(tmp) / "getting_started.msgpack",
                                res["ts"].params)
        net = ckpt.load_policy(path, dev)
    for a, b in zip(net.parameters(), res["ts"].params.parameters()):
        check(torch.equal(a, b), "the reloaded policy differs")
    with plain, LaunchCount(*mods) as la2:
        m_eval = eval_race.evaluate(net, "getting_started", 128, device=dev)
    check(la2["race_step_fused"] > 0, f"evaluation launches {dict(la2)}")
    check(math.isfinite(m_eval["mean_gates"]), f"evaluation {m_eval}")
    print(f"[10] saved, reloaded, evaluate(128 envs) through race_step "
          f"({la2['race_step_fused']} launches): {json.dumps(m_eval)}",
          flush=True)
    return {"metrics": m, "phase_ms": phase_ms, "env_steps_per_sec": rate,
            "idle_share": idle, "busy_ms": busy, "wall_ms": t_wall,
            "alt_phase_ms": alt_ms, "eval": m_eval}


def phase11(dev, gen, gpu, eval_race, race_step, race_rollout, n_envs=4096):
    """race_rollout in action mode at the workload of ``bench.py --impl
    race --rollout_k 32``: 4096 envs, K=32, getting_started, 1 drone
    COMPARE and 2 drones COMPETE; beside 32 race_step launches and the
    plain version."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    K, out = 32, {}
    for nd in (1, 2):
        env = eval_race.make_eval_env("getting_started", n_envs, dev, seed=7,
                                      n_drones=nd)
        st = env.reset()
        A = torch.rand((K, 4, env.T, 128), generator=gen, device=dev) * 2 - 1
        d = env.stacked_draws(K)
        kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                  telemetry=False)
        args = (env.kf, env.km, env.arm, env.ground_z, st.S, A, st.R, st.GG,
                st.OO, st.EP, d.RST, d.RSTG, d.RSTO)

        def k5():
            return race_rollout.race_rollout(*args, emit_obs=False, **kw)

        def k4x32():
            s = st
            for k in range(K):
                o = race_step.race_step_fused(
                    env.kf, env.km, env.arm, env.ground_z, s.S, A[k], s.R,
                    s.GG, s.OO, s.EP, d.RST[0], d.RSTG[0], d.RSTO[0], **kw)
                s = RowRaceState(*o[:5])

        r = {"k5_ms": kernel_ms(k5, "race_rollout_kernel", n=10),
             "k5_loop_ms": cuda_ms(k5, 5)}
        per = kernel_ms(k4x32, "race_step_kernel", n=2)
        r["k4x32_ms"] = None if per is None else K * per
        r["k4x32_loop_ms"] = cuda_ms(k4x32, 3)
        r["plain_ms"] = cuda_ms(lambda: race_rollout.race_rollout_plain(
            *args, emit_obs=False, **kw), 1, warmup=0)
        # a launch of over a millisecond hides the host's enqueue, so the
        # host loop's time stands in where the trace has no device time
        dev_ms = r["k5_ms"] or r["k5_loop_ms"]
        r["env_steps_per_sec"] = n_envs * K / dev_ms * 1e3

        def shown(ms):
            return "not measured" if ms is None else f"{ms:.4g} ms"

        out[nd] = r
        print(f"[11] race_rollout, getting_started {nd} drone(s) "
              f"{'COMPETE' if nd > 1 else 'COMPARE'}, {n_envs} envs, K={K}, "
              f"actions: {shown(r['k5_ms'])} on the device per launch, "
              f"{r['k5_loop_ms']:.4g} ms per launch in a host loop "
              f"({r['env_steps_per_sec']:.6g} env-steps/s from the "
              f"{'device' if r['k5_ms'] else 'host-loop'} time); 32 "
              f"race_step launches {shown(r['k4x32_ms'])} on the device, "
              f"{r['k4x32_loop_ms']:.4g} ms in a host loop; plain "
              f"{r['plain_ms']:.4g} ms; on {gpu}", flush=True)
    return out


# the hover kernels against their plain versions: both round every + - *
# / and sqrt alike (-fmad=false); K1 and the exact integrator also call
# sinf/cosf, which may differ from PyTorch's CUDA sin/cos in the last bit.
# Stated before the first run; the measured errors are printed.
HOVER_TOL = {"pos/quat/vel": 1e-6, "omega": 1e-5, "acc": 1e-4}
# op chains: exact for the correctly rounded ops, relative for libm ones
EXACT_OPS = ("fma", "mul", "add", "max", "div", "sqrt")
CHAIN_RTOL = 1e-5
HOVER_GROUPS = {"pos/quat/vel": list(range(10)), "omega": [10, 11, 12]}


def hover_errs(name, got, ref, acc=None, ref_acc=None):
    """Max abs error per channel group of a hover state (and of acc);
    raises past ``HOVER_TOL``."""
    errs = {}
    for grp, chans in HOVER_GROUPS.items():
        check(torch.isfinite(got[chans]).all().item(), f"{name}: {grp}")
        errs[grp] = float((got[chans] - ref[chans]).abs().max())
    if acc is not None:
        errs["acc"] = float((acc - ref_acc).abs().max())
    for k, v in errs.items():
        check(v <= HOVER_TOL[k], f"{name}: {k} err {v} > {HOVER_TOL[k]}")
    errs["max"] = max(errs.values())
    return errs


def hover_inputs(dev, gen, n_envs, hs, quat_ops, params):
    """tests/test_pallas.py:31's distribution (pos +-1 + z 1.5, rpy +-0.3,
    vel +-1, omega +-2, rpm 0.9-1.1 x hover), the first 128 envs in ground
    contact (z 0.02, falling, motors off); packed."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    pos = u(-1, 1, n_envs, 3) + torch.tensor([0.0, 0.0, 1.5], device=dev)
    quat = quat_ops.from_euler_xyz(u(-0.3, 0.3, n_envs, 3))
    vel, om = u(-1, 1, n_envs, 3), u(-2, 2, n_envs, 3)
    rpm = u(0.9, 1.1, n_envs, 4) * params.hover_rpm
    pos[:128] = torch.tensor([0.0, 0.0, 0.02], device=dev)
    quat[:128] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    vel[:128] = torch.tensor([0.0, 0.0, -1.0], device=dev)
    om[:128] = 0.0
    rpm[:128] = 0.0
    return (hs.pack_state(pos, quat, vel, om),
            rpm.T.reshape(4, n_envs // 128, 128).contiguous())


def phase12(dev, gen, gpu, kernels, plain, totals, n_envs=4096, steps=256):
    """K1 (ctrl_step_packed) against its plain version, then the workload
    of ``bench.py --impl pallas`` through fast_hover.make_step."""
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs
    from gym_pybullet_adrp_tpu_torch.ops import quat as quat_ops

    P = drone_params(device=dev)
    c = hs.hover_consts(P, 8, 1 / 240)
    packed, rpm = hover_inputs(dev, gen, n_envs, hs, quat_ops, P)
    got = hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240)
    ref = hs.ctrl_step_packed_plain(P, packed, rpm, 8, 1 / 240)
    torch.cuda.synchronize()
    errs = hover_errs("ctrl_step_packed", got, ref)
    per_ch = [float(x) for x in (got - ref).abs().amax(dim=(1, 2))]
    check(bool((got[2, 0] == 0.0125).all()), "ground contact height")
    res = {"max_abs_err": errs["max"], "per_channel_err": per_ch}

    # the constants folded once, as make_step folds them: folding reads
    # the params back from the card
    def kern():
        return hs.ctrl_step_packed(P, packed, rpm, 8, 1 / 240, consts=c)

    def plain_fn():
        return hs.ctrl_step_packed_plain(P, packed, rpm, 8, 1 / 240,
                                         consts=c)

    res["loop_ms"] = cuda_ms(kern, 50)
    res["ms"] = device_ms(kern, 50)
    res["plain_ms"] = cuda_ms(plain_fn, 5)
    res.update(bound((packed, rpm), (got,), count_ops(plain_fn)))
    print(f"[12] ctrl_step_packed vs plain, {n_envs} envs (128 in ground "
          f"contact): max abs err per channel {per_ch} (tol {HOVER_TOL}); "
          f"{res['ms']:.4g} ms on the device, {res['loop_ms']:.4g} ms per "
          f"launch in a host loop, plain {res['plain_ms']:.4g} ms, bound "
          f"{res['bound_ms']:.4g} ms ({res['bound_by']}: {res['ops']:.4g} "
          f"ops, {res['bytes']:.4g} B)", flush=True)

    # bench.py --impl pallas: 4096 envs, 256 steps, actions in +-0.05 drawn
    # on the card every step, the reward summed
    step = fast_hover.make_step(P, n_envs, device=dev)
    T = n_envs // 128

    def run(n):
        st = fast_hover.reset_packed([0.0, 0.0, 0.1125], n_envs, device=dev)
        total = torch.zeros((), device=dev)
        for _ in range(n):
            a = (torch.rand((4, T, 128), generator=gen, device=dev) - 0.5) * 0.1
            st, (obs, rew, done) = step(st, a)
            total = total + rew.sum()
        return st, total

    run(8)
    torch.cuda.synchronize()
    with plain, LaunchCount(kernels, totals) as la:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        st, total = run(steps)
        stop.record()
        torch.cuda.synchronize()
    secs = start.elapsed_time(stop) / 1e3
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["ctrl_step_packed"] == steps, f"step path launches {dict(la)}")
    check(torch.isfinite(st.packed).all().item()
          and math.isfinite(float(total)), "step path: non-finite")
    res["step_env_steps_per_sec"] = n_envs * steps / secs
    res["step_ms"] = secs / steps * 1e3
    print(f"[12] fast_hover.make_step, {n_envs} envs x {steps} steps "
          f"(bench.py --impl pallas): {la['ctrl_step_packed']} "
          f"ctrl_step_packed launches, no plain call; "
          f"{res['step_env_steps_per_sec']:.6g} env-steps/s "
          f"({res['step_ms']:.4g} ms per step), reward sum {float(total):.6g}"
          f" on {gpu}", flush=True)
    return res


def mean_se(x):
    x = x.double().reshape(-1)
    return float(x.mean()), float(x.std() / math.sqrt(x.numel()))


def phase13(dev, gen, gpu, kernels, plain, totals, n_envs=4096,
            n_steps=64, launches=60):
    """K2 (hover_rollout) against its plain version in injected and random
    mode, both integrators; the random mode's law against injected
    torch.rand draws; the bench headline workload (60 launches of 64 steps
    at 4096 envs) and the 65536-env point."""
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs

    P = drone_params(device=dev)
    T = n_envs // 128
    st0 = fast_hover.reset_packed([0.0, 0.0, 0.1125], n_envs,
                                  device=dev).packed
    acts = ((torch.rand((n_steps, 4, T, 128), generator=gen, device=dev)
             - 0.5) * 0.1).contiguous()
    res = {"max_abs_err": 0.0}
    for small in (True, False):
        for mode, kw in (("injected", {"actions": acts}), ("random", {})):
            got = hs.hover_rollout(P, st0, 11, n_steps, smallangle=small,
                                   count_resets=True, **kw)
            ref = hs.hover_rollout_plain(P, st0, 11, n_steps,
                                         smallangle=small,
                                         count_resets=True, **kw)
            torch.cuda.synchronize()
            name = (f"hover_rollout[{'smallangle' if small else 'exact'}, "
                    f"{mode}]")
            errs = hover_errs(name, got[0], ref[0], got[1], ref[1])
            check(torch.equal(got[2], ref[2]), f"{name}: resets differ")
            bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
            if mode == "injected":
                res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
            print(f"[13] {name} vs plain, {n_envs} envs x {n_steps} steps: "
                  f"state err {errs['pos/quat/vel']:.3g} / omega "
                  f"{errs['omega']:.3g}, acc err {errs['acc']:.3g}, resets "
                  f"equal ({float(got[2].sum()):.0f}); bit for bit: "
                  f"{bitwise}", flush=True)
    a1 = hs.hover_rollout(P, st0, 5, n_steps)
    a2 = hs.hover_rollout(P, st0, 5, n_steps)
    a3 = hs.hover_rollout(P, st0, 6, n_steps)
    check(all(torch.equal(x, y) for x, y in zip(a1, a2)),
          "random mode: one seed gave two results")
    check(not torch.equal(a1[0], a3[0]), "random mode: two seeds agree")
    # the random mode's law against injected torch.rand draws: means of
    # acc, resets and each state channel within 4 standard errors
    rnd = hs.hover_rollout(P, st0, 12345, n_steps, count_resets=True)
    inj = hs.hover_rollout(P, st0, 0, n_steps, actions=acts,
                           count_resets=True)
    law = {}
    for name, x, y in ([("acc", rnd[1], inj[1]),
                        ("resets", rnd[2], inj[2])]
                       + [(f"ch{c}", rnd[0][c], inj[0][c])
                          for c in range(13)]):
        (m1, s1), (m2, s2) = mean_se(x), mean_se(y)
        se = math.hypot(s1, s2)
        law[name] = (m1, m2, se)
        check(abs(m1 - m2) <= 4 * se + 1e-12,
              f"random vs injected law: {name} {m1} vs {m2} (se {se})")
    print("[13] random mode (seed 12345) vs injected torch.rand draws, "
          f"{n_envs} envs x {n_steps} steps: " + ", ".join(
              f"{k} {v[0]:.5g} vs {v[1]:.5g} (se {v[2]:.2g})"
              for k, v in law.items() if not k.startswith("ch"))
          + "; all 13 state channels within 4 se; share of envs reset "
          f"{float((rnd[2] > 0).float().mean()):.4g} vs "
          f"{float((inj[2] > 0).float().mean()):.4g}", flush=True)
    res["law"] = law
    # the constants folded once for the timed loops: folding reads the
    # params back from the card
    c = hs.hover_consts(P)

    def headline(fn, n_envs_, n_launch):
        st = fast_hover.reset_packed([0.0, 0.0, 0.1125], n_envs_,
                                     device=dev).packed
        total = torch.zeros((), device=dev)
        for i in range(n_launch):
            st, acc = fn(P, st, 7 + i, n_steps, consts=c)
            total = total + acc.sum()
        return st, total

    def timed(fn, label):
        headline(fn, n_envs, 2)
        torch.cuda.synchronize()
        with plain, LaunchCount(kernels, totals) as la:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            st, total = headline(fn, n_envs, launches)
            stop.record()
            torch.cuda.synchronize()
        check(not any(plain.calls.values()), f"plain calls {plain.calls}")
        check(torch.isfinite(st).all().item() and math.isfinite(float(total)),
              f"{label}: non-finite")
        secs = start.elapsed_time(stop) / 1e3
        rate = n_envs * n_steps * launches / secs
        return la, rate, secs / launches * 1e3, float(total)

    la, rate, loop_ms, total = timed(hs.hover_rollout, "hover_rollout")
    check(la["hover_rollout"] == launches, f"headline launches {dict(la)}")
    dev_ms = device_ms(lambda: hs.hover_rollout(P, st0, 3, n_steps,
                                                consts=c))
    res.update(env_steps_per_sec=rate, loop_ms=loop_ms, ms=dev_ms,
               headline_reward=total)
    print(f"[13] bench headline (bench.py --impl pallas-rollout): "
          f"{n_envs} envs, {launches} hover_rollout launches x {n_steps} "
          f"steps, seeds 7+i: {rate:.6g} env-steps/s, {loop_ms:.4g} ms per "
          f"launch in the loop, {dev_ms:.4g} ms per launch on the device "
          f"(launches back to back); reward sum {total:.6g}; on {gpu}",
          flush=True)
    # the batch that fills the card: 65536 envs
    big = fast_hover.reset_packed([0.0, 0.0, 0.1125], 65536,
                                  device=dev).packed
    res["ms_65536"] = device_ms(
        lambda: hs.hover_rollout(P, big, 3, n_steps, consts=c), n=10)
    res["env_steps_per_sec_65536"] = 65536 * n_steps / res["ms_65536"] * 1e3
    print(f"[13] hover_rollout per launch of {n_steps} steps on the device "
          f"({hs.THREADS}-thread blocks): {n_envs} envs {dev_ms:.4g} ms, 65536 "
          f"envs {res['ms_65536']:.4g} ms "
          f"({res['env_steps_per_sec_65536']:.6g} env-steps/s)", flush=True)
    del big

    def plain_fn():
        return hs.hover_rollout_plain(P, st0, 0, n_steps, actions=acts,
                                      consts=c)

    res["plain_ms"] = cuda_ms(plain_fn, 1, warmup=0)
    # the function's float work (the physics; the in-kernel draw's integer
    # ops are not counted): ops of 2 plain steps x n_steps / 2
    step_ops = count_ops(lambda: hs.hover_rollout_plain(
        P, st0, 0, 2, actions=acts[:2], consts=c))
    res.update(bound((st0,), (st0, st0[0]), step_ops * n_steps // 2))
    print(f"[13] hover_rollout plain (injected, {n_steps} steps) "
          f"{res['plain_ms']:.4g} ms; bound {res['bound_ms']:.4g} ms "
          f"({res['bound_by']}: {res['ops']:.4g} ops, {res['bytes']:.4g} B)",
          flush=True)
    return res


def phase14(dev, gen, gpu, kernels, plain, totals, n_envs=4096,
            n_steps=64, launches=60):
    """K7 (hover_rollout_v2) and K8 (hover_rollout_v3) against their plain
    versions and against the K2 instantiations they equal, bit for bit,
    and their own times."""
    from gym_pybullet_adrp_tpu_torch.envs import fast_hover
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs
    from gym_pybullet_adrp_tpu_torch.ops import hover_variants as hv

    P = drone_params(device=dev)
    c = hs.hover_consts(P)
    T = n_envs // 128
    st0 = fast_hover.reset_packed([0.0, 0.0, 0.1125], n_envs,
                                  device=dev).packed
    acts = ((torch.rand((n_steps, 4, T, 128), generator=gen, device=dev)
             - 0.5) * 0.1).contiguous()
    out = {}
    for mode, kw in (("random", {}), ("injected", {"actions": acts})):
        pairs = (
            ("hover_rollout_v2(exact_sqrt=True) == hover_rollout("
             "smallangle=False)",
             hv.hover_rollout_v2(P, st0, 9, n_steps, exact_sqrt=True, **kw),
             hs.hover_rollout(P, st0, 9, n_steps, smallangle=False, **kw)),
            ("hover_rollout_v3 == hover_rollout()",
             hv.hover_rollout_v3(P, st0, 9, n_steps, **kw),
             hs.hover_rollout(P, st0, 9, n_steps, **kw)))
        for name, a, b in pairs:
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{name} ({mode}): not bit for bit")
            print(f"[14] {name}, {mode} mode: equal bit for bit", flush=True)

    def vs_plain(label, got, ref):
        """hover_errs of (state, acc[, resets]) against the plain run;
        returns the largest error."""
        torch.cuda.synchronize()
        errs = hover_errs(label, got[0], ref[0], got[1], ref[1])
        if len(got) > 2:
            check(torch.equal(got[2], ref[2]), f"{label}: resets differ")
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"[14] {label} vs plain, {n_envs} envs x {n_steps} steps: "
              f"state err {errs['pos/quat/vel']:.3g} / omega "
              f"{errs['omega']:.3g}, acc err {errs['acc']:.3g}; bit for "
              f"bit: {bitwise}", flush=True)
        return errs["max"]

    # each variant against its plain version in random mode (the same
    # Philox draws); the injected mode is held below, on the timed run
    variants = (("hover_rollout_v2", hv.hover_rollout_v2,
                 hv.hover_rollout_v2_plain),
                ("hover_rollout_v3", hv.hover_rollout_v3,
                 hv.hover_rollout_v3_plain))
    max_err = {}
    for name, fn, pfn in variants:
        flags = ({}, {"exact_sqrt": True}) if name.endswith("v2") else ({},)
        for kw in flags:
            label = name + ("(exact_sqrt=True)" if kw else "") + ", random"
            max_err[name] = max(max_err.get(name, 0.0), vs_plain(
                label, fn(P, st0, 13, n_steps, count_resets=True, **kw),
                pfn(P, st0, 13, n_steps, count_resets=True, consts=c, **kw)))
    # v2's sqrt-free test differs from exact_sqrt only where e2 < 1e-8
    v2 = hv.hover_rollout_v2(P, st0, 0, n_steps, actions=acts)
    v2s = hv.hover_rollout_v2(P, st0, 0, n_steps, actions=acts,
                              exact_sqrt=True)
    differ = ((v2[0] != v2s[0]).any(dim=0) | (v2[1] != v2s[1]))
    ch, steps = list(st0), torch.zeros((T, 128), dtype=torch.int32,
                                       device=dev)
    acc = torch.zeros((T, 128), device=dev)
    near = torch.zeros((T, 128), dtype=torch.bool, device=dev)
    for k in range(n_steps):
        ch, steps, acc, reward, _ = hs.rollout_step_plain(
            c, ch, acts[k], steps, acc, False, True)
        # reward 2.0 exactly <=> e2^2 below half an ulp of 2: e2 < 3.4e-4,
        # which takes in every lane with e2 < 1e-8
        near |= reward == 2.0
    check(not bool((differ & ~near).any()),
          "hover_rollout_v2 differs from exact_sqrt off the near lanes")
    print(f"[14] hover_rollout_v2 vs exact_sqrt=True (injected): "
          f"{int(differ.sum())} lanes differ; {int(near.sum())} lanes came "
          f"within e2 < 3.4e-4 of the target (where e2 < 1e-8 can differ "
          f"from sqrt(e2) < 1e-4)", flush=True)
    for name, fn, pfn in variants:
        def run(n, fn=fn):
            st = st0
            total = torch.zeros((), device=dev)
            for i in range(n):
                st, acc_ = fn(P, st, 7 + i, n_steps, consts=c)
                total = total + acc_.sum()
            return st, total

        run(2)
        torch.cuda.synchronize()
        with plain, LaunchCount(kernels, totals) as la:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            st, total = run(launches)
            stop.record()
            torch.cuda.synchronize()
        check(not any(plain.calls.values()), f"plain calls {plain.calls}")
        check(la[name] == launches, f"{name} launches {dict(la)}")
        check(torch.isfinite(st).all().item(), f"{name}: non-finite")
        secs = start.elapsed_time(stop) / 1e3
        r = {"env_steps_per_sec": n_envs * n_steps * launches / secs,
             "loop_ms": secs / launches * 1e3}
        r["ms"] = device_ms(lambda fn=fn: fn(P, st0, 3, n_steps, consts=c))

        def plain_fn(pfn=pfn):
            return pfn(P, st0, 0, n_steps, actions=acts, consts=c)

        # the plain version, timed once; its result holds the kernel's
        # injected mode
        torch.cuda.synchronize()
        start.record()
        ref = plain_fn()
        stop.record()
        torch.cuda.synchronize()
        r["plain_ms"] = start.elapsed_time(stop)
        r["max_abs_err"] = max(max_err[name], vs_plain(
            name + ", injected",
            fn(P, st0, 0, n_steps, actions=acts, consts=c), ref))
        step_ops = count_ops(lambda pfn=pfn: pfn(
            P, st0, 0, 2, actions=acts[:2], consts=c))
        r.update(bound((st0,), (st0, st0[0]), step_ops * n_steps // 2))
        out[name] = r
        print(f"[14] {name}, {n_envs} envs, {launches} launches x "
              f"{n_steps} steps: {r['env_steps_per_sec']:.6g} env-steps/s, "
              f"{r['loop_ms']:.4g} ms per launch in the loop, "
              f"{r['ms']:.4g} ms on the device, plain "
              f"{r['plain_ms']:.4g} ms, bound {r['bound_ms']:.4g} ms "
              f"({r['bound_by']}); max abs err vs plain "
              f"{r['max_abs_err']:.3g}; on {gpu}", flush=True)
    return out


def phase15(dev, gpu, op_calibrate, kernels, plain, totals):
    """K6 (op_chain) against its plain version at the calibration's rows:
    all 13 ops at iters 2, and the fma chain at 256 iters; then the
    calibration of the card's per-op costs."""
    rows = op_calibrate.ROWS
    res = {"max_abs_err": 0.0}
    x = (0.3 + 0.9 * torch.rand((rows, 128), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(0)))

    def chain_err(op, got, ref):
        """Max abs error of a chain against the plain one, held to
        EXACT_OPS / CHAIN_RTOL; NaNs must agree."""
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        check(torch.equal(torch.isnan(got), nan), f"op_chain[{op}]: NaNs")
        d = (got - ref).abs()[~nan]
        err = float(d.max()) if d.numel() else 0.0
        rel = float((d / ref.abs()[~nan]).max()) if d.numel() else 0.0
        if op in EXACT_OPS:
            check(err == 0.0, f"op_chain[{op}]: not bit for bit ({err})")
        else:
            check(rel <= CHAIN_RTOL, f"op_chain[{op}]: rel err {rel}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        return err

    errs = {op: chain_err(op, op_calibrate.op_chain(op, x, 2),
                          op_calibrate.op_chain_plain(op, x, 2))
            for op in op_calibrate.OPS}
    print(f"[15] op_chain vs plain (iters 2, {rows} x 128): max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (exact for {EXACT_OPS}, rel tol {CHAIN_RTOL} for the rest; "
          "log's chain is NaN on both sides)", flush=True)
    iters = 256
    xr = torch.full((rows, 128), 0.62, device=dev)

    def kern():
        return op_calibrate.op_chain("fma", xr, iters)

    res["ms"] = device_ms(kern, 5)
    # the plain chain, timed once; its result holds the kernel's
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = op_calibrate.op_chain_plain("fma", xr, iters)
    stop.record()
    torch.cuda.synchronize()
    res["plain_ms"] = start.elapsed_time(stop)
    err = chain_err("fma", kern(), ref)
    res.update(bound((xr,), (xr,), count_ops(
        lambda: op_calibrate.op_chain_plain("fma", xr, 1)) * iters))
    print(f"[15] op_chain[fma], {rows} x 128, iters {iters}: max abs err vs "
          f"plain {err:.3g} (bit for bit); {res['ms']:.4g} ms on the device, "
          f"plain {res['plain_ms']:.4g} ms, bound {res['bound_ms']:.4g} ms "
          f"({res['bound_by']}: {res['ops']:.4g} ops)", flush=True)
    t0 = time.perf_counter()
    with plain, LaunchCount(kernels, totals) as la:
        weights, rates, used = op_calibrate.calibrate(verbose=False)
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["op_chain"] > 0, f"calibration launches {dict(la)}")
    check(all(math.isfinite(w) and w > 0 for w in weights.values()),
          f"weights {weights}")
    print(f"[15] calibrate() ({la['op_chain']} op_chain launches, "
          f"{time.perf_counter() - t0:.1f} s), {rows} x 128 elements, "
          f"~10 ms chains, on {gpu}:", flush=True)
    for op in op_calibrate.OPS:
        print(f"    {op:9s} iters {used[op]:7d}  {rates[op] / 1e12:9.5f}T "
              f"op-elements/s  weight vs fma {weights[op]:8.4f}")
    res.update(weights=weights, rates=rates, iters=used)
    return res


def phase16(dev, gpu, kernels, plain, totals, iters=10):
    """Hover PPO: make_ppo_core over fast_hover.ppo_adapter at 8192 envs
    (VALIDATION.md:272), make_ppo over the hover env at test_rl.py:96's
    settings (its learning floor), and one iteration of make_ppo at 4096
    envs."""
    from gym_pybullet_adrp_tpu_torch.envs import core, fast_hover, rl as rlenv
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.rl import ppo
    from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType

    P = drone_params(device=dev)
    cfg = ppo.PPOConfig(n_envs=8192, n_steps=64)
    init, train_step, _ = ppo.make_ppo_core(
        cfg, fast_hover.ppo_adapter(P, 8192, device=dev), device=dev)
    ts = init(0)
    ms, losses, rewards = [], [], []
    t0 = time.perf_counter()
    with plain, LaunchCount(kernels, totals) as la:
        for _ in range(iters):
            times = {}
            t1 = time.perf_counter()
            ts, m = train_step(ts, times=times)
            times["iteration"] = time.perf_counter() - t1
            ms.append(times)
            losses.append(float(m["loss"]))
            rewards.append(float(m["mean_reward"]))
    wall = time.perf_counter() - t0
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["ctrl_step_packed"] == 64 * iters, f"ppo launches {dict(la)}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    steady = ms[1:]
    phase_ms = {k: 1e3 * sum(t[k] for t in steady) / len(steady)
                for k in steady[0]}
    rate = cfg.batch_size / (phase_ms["iteration"] / 1e3)
    print(f"[16] make_ppo_core(8192 envs x 64 steps, fast_hover.ppo_adapter"
          f"), {iters} iterations in {wall:.1f} s: {la['ctrl_step_packed']} "
          f"ctrl_step_packed launches, no plain call; losses finite; mean "
          f"reward {rewards[0]:.5g} -> {rewards[-1]:.5g}; ms per iteration "
          f"(2-{iters}): " + ", ".join(f"{k} {v:.4g}"
                                       for k, v in phase_ms.items())
          + f"; {rate:.6g} env-steps/s on {gpu}", flush=True)
    res = {"phase_ms": phase_ms, "env_steps_per_sec": rate,
           "losses": losses, "rewards": rewards}

    rl_cfg = rlenv.RLConfig(aviary=core.AviaryConfig(ctrl_freq=30),
                            act_type=ActionType.ONE_D_RPM)
    init_xyz, init_rpy = [[0.0, 0.0, 0.1125]], [[0.0, 0.0, 0.0]]
    small = ppo.PPOConfig(n_envs=64, n_steps=32, n_minibatches=4, n_epochs=4)
    init, train_step, eval_rollout = ppo.make_ppo(small, rl_cfg, P, init_xyz,
                                                  init_rpy, device=dev)
    ts = init(0)
    t0 = time.perf_counter()
    curve = []
    for _ in range(16):
        ts, m = train_step(ts)
        curve.append(float(m["mean_reward"]))
    ret = float(eval_rollout(ts.params, 240)[0])
    print(f"[16] make_ppo(ONE_D_RPM hover, 64 envs x 32 steps, 4 x 4), 16 "
          f"iterations in {time.perf_counter() - t0:.1f} s: mean reward "
          f"{curve[0]:.5g} -> {curve[-1]:.5g} (floor: +0.05); deterministic "
          f"eval return (240 steps) {ret:.5g}", flush=True)
    check(curve[-1] > curve[0] + 0.05,
          f"make_ppo: reward {curve[0]} -> {curve[-1]}")
    res.update(make_ppo_curve=curve, make_ppo_eval_return=ret)

    big = ppo.PPOConfig(n_envs=4096, n_steps=64)
    init, train_step, _ = ppo.make_ppo(big, rl_cfg, P, init_xyz, init_rpy,
                                       device=dev)
    ts = init(0)
    ts, _ = train_step(ts)
    times = {}
    t0 = time.perf_counter()
    ts, m = train_step(ts, times=times)
    it = time.perf_counter() - t0
    check(math.isfinite(float(m["loss"])), "make_ppo 4096: loss")
    res["make_ppo_4096_ms"] = {k: v * 1e3 for k, v in times.items()}
    res["make_ppo_4096_env_steps_per_sec"] = big.batch_size / it
    print(f"[16] make_ppo(ONE_D_RPM hover, 4096 envs x 64 steps), one "
          f"iteration: {it * 1e3:.4g} ms ("
          + ", ".join(f"{k} {v * 1e3:.4g}" for k, v in times.items())
          + f"), {big.batch_size / it:.6g} env-steps/s", flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the build report and metrics")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gym_pybullet_adrp_tpu_torch.ops import (
        _build, hover_step, hover_variants, race_rollout, race_step,
        race_window,
    )
    from gym_pybullet_adrp_tpu_torch import eval_race, op_calibrate

    dev = torch.device("cuda:0")
    out_dir = Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = device_line()
    print(f"[1] device: {gpu}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library("race_window")
    info = _build.build_info
    print(f"[2] build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc, one process per source in parallel, "
          f"{info['seconds']:.1f} s; cached {info['cached']}) -> "
          f"{sorted(info['paths'].values())}", flush=True)
    if out_dir:
        (out_dir / "ptxas.txt").write_text(info["ptxas"])
    for line in info["ptxas"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"    {line.strip()}")

    results = {}

    # ---- 3. race_window kernel vs plain ---------------------------------------
    n_envs = 4096
    env = eval_race.make_eval_env("level1", n_envs, dev, seed=1, n_drones=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    st = env.reset()
    for _ in range(3):
        a = torch.rand((n_envs, 2, 4), generator=gen, device=dev) * 2 - 1
        out = race_step.race_step_fused_plain(
            env.kf, env.km, env.arm, env.ground_z, st.S, env.action_rows(a),
            st.R, st.GG, st.OO, st.EP, *env.step_draws()[1:],
            n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
            noise_rows=env.step_draws().noise_rows,
        )
        st = st._replace(S=out[0], R=out[1], GG=out[2], OO=out[3], EP=out[4])
    a = torch.rand((n_envs, 2, 4), generator=gen, device=dev) * 2 - 1
    W = env.build_W(st, env.action_rows(a)).clone()
    # planner branch on for every other agent: random poly7 setpoints
    T = env.T
    plan = (torch.arange(T * 128, device=dev).reshape(T, 128) % 2) == 0
    W[16] = plan.float()
    W[17] = st.S[53] * env.dt
    W[18] = 1.0 + torch.rand((T, 128), generator=gen, device=dev)
    W[20:52] = torch.randn((32, T, 128), generator=gen, device=dev) * 0.2
    W[20] += st.S[0]
    W[28] += st.S[1]
    W[36] += st.S[2]
    W = W.contiguous()
    noise = env.step_draws().noise_rows
    k3 = {"max_abs_err": 0.0}
    for label, nz in (("noise", noise), ("no-noise", None)):
        got = race_window.race_window(env.kf, env.km, env.arm, env.ground_z,
                                      st.S, W, env.n_ticks, env.dt, nz)
        ref = race_window.race_window_plain(env.kf, env.km, env.arm,
                                            env.ground_z, st.S, W,
                                            env.n_ticks, env.dt, nz)
        torch.cuda.synchronize()
        errs = compare_s(f"race_window[{label}]", got, ref)
        k3["max_abs_err"] = max(k3["max_abs_err"],
                                float((got - ref).abs().max()))
        print(f"[3] race_window vs plain ({label}, {n_envs} envs x 2 "
              f"drones, planner on half): "
              + ", ".join(f"{k}={v:.3g}" for k, v in errs.items())
              + f" (tol {TOL})", flush=True)
    def k3_launch():
        return race_window.race_window(env.kf, env.km, env.arm, env.ground_z,
                                       st.S, W, env.n_ticks, env.dt, noise)

    k3["loop_ms"] = cuda_ms(k3_launch, 20)
    k3_dev = kernel_ms(k3_launch, "race_window_kernel")
    k3["ms"] = k3["loop_ms"] if k3_dev is None else k3_dev
    k3["plain_ms"] = cuda_ms(lambda: race_window.race_window_plain(
        env.kf, env.km, env.arm, env.ground_z, st.S, W, env.n_ticks,
        env.dt, noise), 3, warmup=1)
    print(f"[3] race_window, {n_envs} envs x 2 drones with noise: kernel "
          f"{'not measured' if k3_dev is None else f'{k3_dev:.4g} ms'} on "
          f"the device, {k3['loop_ms']:.4g} ms per launch in a host loop; "
          f"plain {k3['plain_ms']:.4g} ms", flush=True)
    k3.update(bound((st.S, W, noise), (st.S,), count_ops(
        lambda: race_window.race_window_plain(
            env.kf, env.km, env.arm, env.ground_z, st.S, W, env.n_ticks,
            env.dt, noise))))
    results["race_window"] = k3

    # ---- 4. race_step kernel vs plain -----------------------------------------
    k4 = {"max_abs_err": 0.0}
    for cfg, nd in (("getting_started", 2), ("level1", 1)):
        env = eval_race.make_eval_env(cfg, n_envs, dev, seed=5, n_drones=nd)
        env.telemetry = True
        st = env.reset()
        for i in range(13):
            a = torch.rand((n_envs, nd, 4) if nd > 1 else (n_envs, 4),
                           generator=gen, device=dev) * 2 - 1
            draws = env.step_draws()
            args_ = (env.kf, env.km, env.arm, env.ground_z, st.S,
                     env.action_rows(a), st.R, st.GG, st.OO, st.EP,
                     draws.RST, draws.RSTG, draws.RSTO)
            kw = dict(n_ticks=env.n_ticks, dt=env.dt,
                      spec_tail=env.spec_tail, noise_rows=draws.noise_rows,
                      telemetry=True)
            ref = race_step.race_step_fused_plain(*args_, **kw)
            if i >= 10:  # compare 3 consecutive steps, from the same input
                got = race_step.race_step_fused(*args_, **kw)
                torch.cuda.synchronize()
                name = f"race_step[{cfg} N={nd} step {i}]"
                errs = check_step(name, dict(zip(STEP_OUT, got)),
                                  dict(zip(STEP_OUT, ref)))
                k4["max_abs_err"] = max(k4["max_abs_err"], errs["max"])
                print(f"[4] {name}: S ok, R err {errs['R']:.3g}, OBS err "
                      f"{errs['OBS']:.3g}, REW err {errs['REW']:.3g}, "
                      f"DONE/INFO/GG equal ({int(ref[7].sum())} envs done)",
                      flush=True)
            st = st._replace(S=ref[0], R=ref[1], GG=ref[2], OO=ref[3],
                             EP=ref[4])

    # ---- 5. the slice: evaluate the shipped level1 policy ---------------------
    kernels = {"race_window": race_window.race_window,
               "race_step_fused": race_step.race_step_fused,
               "race_rollout": race_rollout.race_rollout,
               "ctrl_step_packed": hover_step.ctrl_step_packed,
               "hover_rollout": hover_step.hover_rollout,
               "hover_rollout_v2": hover_variants.hover_rollout_v2,
               "hover_rollout_v3": hover_variants.hover_rollout_v3,
               "op_chain": op_calibrate.op_chain}
    main_launches = dict.fromkeys(list(kernels) + ["race_step_fused[policy]"],
                                  0)
    plain = PlainCalls(race_step=race_step, race_window=race_window,
                       race_rollout=race_rollout, hover_step=hover_step,
                       hover_variants=hover_variants,
                       op_calibrate=op_calibrate)
    policy = str(REPO / "results/level1_robust.msgpack")
    with plain, LaunchCount(kernels, main_launches) as launches:
        t0 = time.perf_counter()
        m_fused = eval_race.evaluate(policy, "level1", 128, device=dev)
        t_fused = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_unfused = eval_race.evaluate(policy, "level1", 128, device=dev,
                                       fused=False)
        t_unfused = time.perf_counter() - t0
        torch.cuda.synchronize()
    print(f"[5] evaluate(level1_robust, level1, 128 envs) through "
          f"race_step ({t_fused:.1f} s): {json.dumps(m_fused)}", flush=True)
    print(f"[5] evaluate(..., fused=False) through race_window + plain tail "
          f"({t_unfused:.1f} s): {json.dumps(m_unfused)}", flush=True)
    print(f"[5] launches in the serving path: {launches}; plain versions "
          f"called: {plain.calls}", flush=True)
    check(launches["race_step_fused"] == 825, "race_step launch count")
    check(launches["race_window"] == 825, "race_window launch count")
    check(not any(plain.calls.values()), "a plain version ran on the path")
    for label, m in (("fused", m_fused), ("unfused", m_unfused)):
        check(m["mean_gates"] >= 1.0,
              f"{label}: mean_gates {m['mean_gates']} < 1.0")
        check(m["completion_rate"] >= 0.2,
              f"{label}: completion {m['completion_rate']} < 0.2")

    # ---- 6. times: fused step, getting_started 2-drone COMPETE ---------------
    env = eval_race.make_eval_env("getting_started", n_envs, dev, seed=7,
                                  n_drones=2)
    env.telemetry = False
    steps, plain_steps = 256, 32
    acts = torch.rand((steps, n_envs, 2, 4), generator=gen, device=dev) * 2 - 1
    rows = [env.action_rows(acts[i]) for i in range(steps)]
    draws = env.step_draws()
    kw = dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
              noise_rows=None, telemetry=False)

    def run(step_fn, n):
        st = env.reset()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            out = step_fn(env.kf, env.km, env.arm, env.ground_z, st.S,
                          rows[i], st.R, st.GG, st.OO, st.EP, draws.RST,
                          draws.RSTG, draws.RSTO, **kw)
            st = st._replace(S=out[0], R=out[1], GG=out[2], OO=out[3],
                             EP=out[4])
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3

    run(race_step.race_step_fused, 4)
    run(race_step.race_step_fused_plain, 2)
    t_plain = [run(race_step.race_step_fused_plain, plain_steps)]
    t_kern = [run(race_step.race_step_fused, steps),
              run(race_step.race_step_fused, steps)]
    t_plain.append(run(race_step.race_step_fused_plain, plain_steps))
    kern_rate = n_envs * steps / (sum(t_kern) / 2)
    plain_rate = n_envs * plain_steps / (sum(t_plain) / 2)
    k4["loop_ms"] = sum(t_kern) / 2 / steps * 1e3
    k4["plain_ms"] = sum(t_plain) / 2 / plain_steps * 1e3
    print(f"[6] step_fused, getting_started 2-drone COMPETE, {n_envs} envs "
          f"(plain {plain_steps} steps, kernel {steps}, kernel {steps}, plain "
          f"{plain_steps}): kernel {kern_rate:.6g} env-steps/s "
          f"({k4['loop_ms']:.4g} ms/step), plain {plain_rate:.6g} "
          f"env-steps/s ({k4['plain_ms']:.4g} ms/step) on {gpu}", flush=True)

    # where a kernel step's time goes: device time of the kernel launches
    # against the host clock over a short traced window
    n_prof = 64
    prof = profile_steps(env, rows, draws, kw, race_step.race_step_fused,
                         n_prof)
    print(f"[6] profile, {n_prof} kernel steps: wall {prof['wall_ms']:.4g} "
          f"ms, {prof['launches']} race_step launches traced, "
          f"{prof['kernel_ms']} ms on the device (device idle share "
          f"{prof['idle_share']})", flush=True)
    k4["ms"] = (prof["kernel_ms"] / prof["launches"] if prof["launches"]
                else k4["loop_ms"])
    st = env.reset()
    k4_in = (st.S, rows[0], st.R, st.GG, st.OO, st.EP, draws.RST,
             draws.RSTG, draws.RSTO)

    def k4_plain():
        return race_step.race_step_fused_plain(env.kf, env.km, env.arm,
                                               env.ground_z, *k4_in, **kw)

    k4.update(bound(k4_in, k4_plain(), count_ops(k4_plain)))
    results["race_step_fused"] = k4
    scaling = {}
    for envs in (16384, 65536):
        env_s = eval_race.make_eval_env("getting_started", envs, dev,
                                        seed=7, n_drones=2)
        st = env_s.reset()
        a = torch.rand((envs, 2, 4), generator=gen, device=dev) * 2 - 1
        A = env_s.action_rows(a)
        d = env_s.step_draws()
        ms = kernel_ms(lambda: race_step.race_step_fused(
            env_s.kf, env_s.km, env_s.arm, env_s.ground_z, st.S, A, st.R,
            st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO, n_ticks=20,
            dt=env_s.dt, spec_tail=env_s.spec_tail), "race_step_kernel")
        if ms is not None:
            scaling[envs] = (ms, envs / ms * 1e3)
    print("[6] race_step kernel on the device vs batch (2-drone COMPETE, "
          "same state each launch): " + ", ".join(
              f"{k} envs {v[0]:.4g} ms = {v[1]:.6g} env-steps/s"
              for k, v in scaling.items()), flush=True)
    del env_s, st, A, d, rows, acts

    # ---- 7. race_step's policy option vs plain -------------------------------
    results["race_step_fused[policy]"] = phase7(dev, gen, eval_race,
                                                race_step, n_envs)

    # ---- 8. race_rollout vs race_step launches, and vs plain ------------------
    results["race_rollout"] = phase8(dev, gen, eval_race, race_step,
                                     race_rollout, n_envs)

    # ---- 9. the PPO epoch on the card vs on the CPU ---------------------------
    ppo_err = phase9(dev, n_envs)

    # ---- 10. training at full width -------------------------------------------
    train_out = phase10(dev, gpu, eval_race, kernels, plain, main_launches)

    # ---- 11. times: race_rollout at the bench workload ------------------------
    times11 = phase11(dev, gen, gpu, eval_race, race_step, race_rollout)

    # ---- 12-16. the hover env family --------------------------------------
    results["ctrl_step_packed"] = phase12(dev, gen, gpu, kernels, plain,
                                          main_launches)
    results["hover_rollout"] = phase13(dev, gen, gpu, kernels, plain,
                                       main_launches)
    results.update(phase14(dev, gen, gpu, kernels, plain, main_launches))
    results["op_chain"] = phase15(dev, gpu, op_calibrate, kernels, plain,
                                  main_launches)
    hover_ppo = phase16(dev, gpu, kernels, plain, main_launches)

    src = "gym_pybullet_adrp_tpu_torch/csrc/"
    kernels = [
        {"name": "race_window", "route": "cuda",
         "source": src + "race_window.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race.py:664"},
        {"name": "race_step_fused", "route": "cuda",
         "source": src + "race_step.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race_step.py:897"},
        {"name": "race_step_fused[policy]", "route": "cuda",
         "source": src + "policy.cuh",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race_step.py:92"},
        {"name": "race_rollout", "route": "cuda",
         "source": src + "race_rollout.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race_step.py:750"},
        {"name": "ctrl_step_packed", "route": "cuda",
         "source": src + "hover_step.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_step.py:151"},
        {"name": "hover_rollout", "route": "cuda",
         "source": src + "hover_rollout.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_step.py:369"},
        {"name": "hover_rollout_v2", "route": "cuda",
         "source": src + "hover_rollout.cu",
         "replaces": "results/hover_vpu/ab_v2.py:163"},
        {"name": "hover_rollout_v3", "route": "cuda",
         "source": src + "hover_rollout.cu",
         "replaces": "results/hover_vpu/ab_v3.py:164"},
        {"name": "op_chain", "route": "cuda",
         "source": src + "op_chain.cu",
         "replaces": "scripts/vpu_calibrate.py:84"},
    ]
    for k in kernels:
        r = results[k["name"]]
        k.update(launches=main_launches[k["name"]],
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=None)
        check(k["launches"] > 0, f"{k['name']}: no launch on its path")
    if out_dir:
        (out_dir / "chip_smoke_metrics.json").write_text(json.dumps({
            "device": gpu, "kernels": kernels, "results": results,
            "eval_fused": m_fused, "eval_unfused": m_unfused,
            "env_steps_per_sec": {"kernel": kern_rate, "plain": plain_rate},
            "loop_ms": {"race_window": results["race_window"]["loop_ms"],
                        "race_step_fused": k4["loop_ms"]},
            "profile": prof, "scaling": scaling,
            "seconds": {"eval_fused": t_fused, "eval_unfused": t_unfused},
            "ppo_card_vs_cpu": ppo_err, "training": train_out,
            "rollout_times": times11, "hover_ppo": hover_ppo,
            "launches": main_launches,
        }, indent=1, default=str))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

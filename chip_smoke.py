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
and through the RL hover env. Phase 17 brings up the general race env:
the window kernel against its plain version at every lane count it
runs, its route (envs/race_fast.py) against the eager step in closed
loop, and the general trainer with and without ``--fast``. Phases 18-22
drive the surfaces users call: the league trainer (the league study's
command), a whole-state checkpoint resumed against an unbroken run,
``TorchRaceVectorEnv`` against the row env it runs on, ``sim.py`` with
the scripted and a learned agent, and the flagship level3_mastery
artifact at the reference's floors. Phases 23-26 drive the pixels path,
which launches none of the kernels: the ray-casting renderer on the card
against the CPU, the ``--obs rgb`` trainer at the camera-racing recipe's
512 envs x 64 steps at 64x48, the shipped results/px5/full.msgpack
through the pixels evaluator, the RGB gym classes, a conv actor-critic
over the RGB hover adapter and a URDF round trip. Phases 27-29 launch
none of the kernels either: CFAviary and CFPIDAviary flights, BetaAviary
with CTBRControl, the object MellingerControl, examples.pid and
examples.cf, and gradients through the eager envs (the card's against the
CPU's, apg and race_grad). Phase 30 trains on torch.distributed: the
script starts two ranks of itself on gloo sharing the card (the sharded
race rollout through the step and rollout kernels, data-parallel and
tensor-parallel PPO, the gradient all-reduce's cost) and one on NCCL;
their kernel launches count with the parent's. Phase 31 runs the training
tools: profile_ppo, examples.learn and scaling.py's cluster rows. Phase
32 runs the last tools, which launch no kernel (the race wrappers,
hover_ceiling, race_video, flight_report, replay_viewer, live_fly), and
the roofline accounting: the shares of the card's peaks at the rates of
phases 6, 11 and 13 and every kernel's operation bound in FP32 issues.
Every phase prints its lines; any failed phase exits non-zero without the
final result line.

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

import numpy as np
import torch

# device times of launches queued behind a spin kernel (the host's enqueue
# not timed), and the host's enqueue itself
from gym_pybullet_adrp_tpu_torch.race_kernel_times import (
    device_host_ms, device_ms,
)
# operation counts, bounds (in FP32 issues, utils/profiling.py says why)
# and traced device time (one copy, shared with profile_ppo)
from gym_pybullet_adrp_tpu_torch.utils.profiling import (
    PEAK_BYTES, PEAK_FP32_OPS, bound, census, kernel_time, ops_ms,
    traced,
)

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
# the device times PERF.md section 6 records for the earlier design of
# the race step, one thread per env running its drones' windows in turn
# (the tile MLP's final tree, H100 80GB HBM3, 700.00 W: race_kernel_times
# for K4 without the policy and K5 in action mode, chip_smoke.py for the
# rest), and of the hover kernels at one thread per env (K1, K2 at 4096
# and 65536 envs x 64 steps, K7, K8, and bench.py's headline loop per
# launch; chip_smoke.py, same card and limit), printed beside this run's
EARLIER_MS = {"race_step_fused": 0.0774, "race_step_fused[policy]": 0.06957,
              "race_rollout[policy]": 0.9326, "race_rollout[actions, 1]": 1.191,
              "race_rollout[actions, 2]": 2.299, "train rollout phase": 17.07,
              "ctrl_step_packed": 0.00502, "hover_rollout": 0.0635,
              "hover_rollout[65536]": 0.172, "hover_rollout_v2": 0.1294,
              "hover_rollout_v3": 0.0635, "headline loop": 0.0781}
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


def kernel_ms(fn, kernel, n=20):
    """Mean device time of one launch of ``kernel`` over ``n`` calls of
    ``fn`` (the host's cost excluded), or None when the trace has no device
    time for it."""
    fn()

    def loop():
        for _ in range(n):
            fn()

    count, ms = kernel_time(traced(loop).events, kernel)
    return ms / count if count else None


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

    tr = traced(loop)
    wall = tr.wall_ms
    count, kern = kernel_time(tr.events, "race_step_kernel")
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


def policy_net(env, hidden, seed=3):
    """A random ActorCritic on the env's device (log_std -1: calm
    flights; random biases, which the init zeroes, so that every tensor of
    the pack is read at its offset)."""
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    gen = torch.Generator().manual_seed(seed)
    net = ActorCritic(env.obs_size, 4, hidden, generator=gen)
    with torch.no_grad():
        net.log_std.fill_(-1.0)
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1, generator=gen)
    return net.to(env.device)


def policy_pack(env, hidden, seed=3):
    """The in-kernel pack of ``policy_net``."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        pack_policy_params,
    )

    return pack_policy_params(policy_net(env, hidden, seed))


def launch_lines(race_step, kernel, env, hidden):
    """How ``kernel`` launches with and without the policy at ``env``'s
    shape, and ptxas' registers, stack and spills of both instantiations;
    returns (text, dict)."""
    from gym_pybullet_adrp_tpu_torch.ops import _build
    from gym_pybullet_adrp_tpu_torch.race_kernel_times import ptxas_entries

    lay, _ = race_step.policy_layout(env.obs_size, hidden)
    geo = {mode: race_step.launch_geometry(kernel, env.N, env.Tb,
                                           lay if mode == "policy" else None)
           for mode in ("policy", "actions")}
    ptx = {k: v for k, v in ptxas_entries(_build.build_info["ptxas"]).items()
           if k.startswith(kernel + "_kernel")}
    text = "; ".join(
        f"{mode}: {g['blocks']} blocks x {g['threads']} threads, "
        f"{g['smem_bytes']} B dynamic and {g['static_smem_bytes']} B "
        f"static shared memory per block, "
        f"{g['registers']} registers, {g['local_bytes']} B local per thread"
        for mode, g in geo.items()) + "; ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, {v['stack']} B stack, "
        f"{v['spill_stores']}/{v['spill_loads']} B spill stores/loads"
        for k, v in ptx.items())
    return text, {"geometry": geo, "ptxas": ptx}


def hover_launch_line(hs, kernel, B, flags=""):
    """How the hover ``kernel`` ("hover_rollout" or "hover_step") launches
    for ``B`` envs: its lanes per env (the rollout's ``lane_count``; one
    for the step kernel), threads per block, and ptxas' registers, stack
    and spills of that instantiation (``flags``: the rollout's "1,0"
    small-angle, "0,1" exact, "0,0" exact with e2 < 1e-8); returns (text,
    dict)."""
    from gym_pybullet_adrp_tpu_torch.hover_kernel_times import HOVER_KERNELS
    from gym_pybullet_adrp_tpu_torch.ops import _build
    from gym_pybullet_adrp_tpu_torch.race_kernel_times import ptxas_entries

    if kernel == "hover_rollout":
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        L = hs.lane_count(B, n_sm)
        name = f"{kernel}_kernel<{flags},{L}>"
    else:
        L, name = 1, f"{kernel}_kernel"
    ptx = ptxas_entries(_build.build_info["ptxas"], HOVER_KERNELS).get(name)
    check(ptx is not None, f"{name}: not in the ptxas report")
    info = {"lanes": L, "threads": hs.THREADS, "blocks": B * L // hs.THREADS,
            **ptx}
    return (f"{name}: L = {L} lanes per env, {info['blocks']} blocks x "
            f"{hs.THREADS} threads, {ptx['registers']} registers, "
            f"{ptx['stack']} B stack, {ptx['spill_stores']}/"
            f"{ptx['spill_loads']} B spill stores/loads"), info


def eager_policy_ms(env, hidden, gen):
    """Device ms of the eager ActorCritic forward and Gaussian sample
    (``nn.Linear``s, cuBLAS; never used on the port's path) over the env's
    agents: the yardstick of the in-kernel MLP."""
    from gym_pybullet_adrp_tpu_torch.models.policy import sample_action

    net = policy_net(env, hidden)
    obs = torch.randn((env.n_envs * env.N, env.obs_size), generator=gen,
                      device=env.device)

    @torch.no_grad()
    def fwd():
        mean, log_std, value = net(obs)
        return sample_action(mean, log_std, gen), value

    return device_ms(fwd)


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
    """race_step with its policy option against the plain version, bit for
    bit: three consecutive steps of getting_started 1-drone and 2-drone
    COMPETE and twogates 2-drone COMPETE at 64-64, one step of
    getting_started 1 and twogates 2 at 256-128, each from the same
    inputs; then the trainer's launch timed beside the earlier design's
    time and the eager policy forward."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    res = {"max_abs_err": 0.0}
    for cfg, nd, hidden, n_cmp in (("getting_started", 1, (64, 64), 3),
                                   ("getting_started", 2, (64, 64), 3),
                                   ("twogates", 2, (64, 64), 3),
                                   ("getting_started", 1, (256, 128), 1),
                                   ("twogates", 2, (256, 128), 1)):
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
                check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                      f"{name}: not equal to the plain version bit for bit")
                res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
                print(f"[7] {name}: equal to the plain version bit for bit "
                      f"(all {len(out)} outputs; ACT err {errs['ACT']:.3g}, "
                      f"OBS err {errs['OBS']:.3g})", flush=True)
                out = ref
            st, obs = RowRaceState(*out[:5]), out[5]
        if (cfg, nd, hidden) == ("getting_started", 1, (64, 64)):
            # the shape of the trainer's one-launch-per-step path
            kw_t = dict(kw, telemetry=False)
            inputs = args + (pack, obs, actn)

            def kern():
                return race_step.race_step_fused(*args, **kw_t)

            def plain():
                return race_step.race_step_fused_plain(*args, **kw_t)

            res["ms"] = (kernel_ms(kern, "race_step_kernel")
                         or cuda_ms(kern, 20))
            res["queued_ms"] = device_ms(kern)
            res["eager_policy_ms"] = eager_policy_ms(env, hidden, gen)
            res["plain_ms"] = cuda_ms(plain, 2, warmup=1)
            c = census(plain)
            res.update(bound(inputs, plain(), c.ops, c.flops))
            text, res["launch"] = launch_lines(race_step, "race_step", env,
                                               hidden)
            print(f"[7] race_step with the policy, getting_started 1 drone, "
                  f"{n_envs} envs, 64-64: {res['ms']:.4g} ms on the device "
                  f"({res['queued_ms']:.4g} ms per launch queued back to "
                  f"back; one thread per env in the env step: "
                  f"{EARLIER_MS['race_step_fused[policy]']} ms), plain "
                  f"{res['plain_ms']:.4g} ms, bound {res['bound_ms']:.4g} ms "
                  f"({res['bound_by']}: {res['ops']:.4g} ops, "
                  f"{res['bytes']:.4g} B); yardstick: the eager ActorCritic "
                  f"forward + sample over the {n_envs} agents (cuBLAS, not "
                  f"on the port's path) {res['eager_policy_ms']:.4g} ms on "
                  f"the device", flush=True)
            print(f"[7] race_step launches: {text}", flush=True)
    return res


def phase8(dev, gen, eval_race, race_step, race_rollout, n_envs):
    """race_rollout against K race_step launches in action mode (K=3) and
    policy mode (K=16), and against its plain version (K=3), all bit for
    bit, at getting_started 1 and 2 COMPETE drones (and level2's
    disturbances in action mode); times the trainer's K=16 policy
    launch."""
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import RowRaceState

    res = {"max_abs_err": 0.0}
    cases = [("getting_started", 1, 3, False),
             ("getting_started", 2, 3, False), ("level2", 1, 3, False),
             ("getting_started", 1, 16, True),
             ("getting_started", 2, 16, True)]
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
        if not policy:
            plain = dict(zip(ROLL_OUT, race_rollout.race_rollout_plain(
                *args, **pol, **kw)))
            errs = check_step(name + " vs plain", got, plain)
            check(all(torch.equal(got[k], plain[k]) for k in got),
                  f"{name}: not equal to the plain version bit for bit")
            res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
            print(f"[8] {name} vs its plain version: equal bit for bit "
                  f"({sorted(got)})", flush=True)
        else:
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
            check(all(torch.equal(got3[k], plain3[k]) for k in got3),
                  f"{name} K=3: not equal to the plain version bit for bit")
            res["max_abs_err"] = max(res["max_abs_err"], errs["max"])
            print(f"[8] race_rollout[policy, {cfg} N={nd}, K=3] vs its "
                  f"plain version: equal bit for bit ({sorted(got3)}; max "
                  f"abs err {errs['max']:.3g})", flush=True)
            if nd != 1:
                continue
            kw_t = dict(kw, telemetry=False)

            def kern():
                return race_rollout.race_rollout(*args, **pol, **kw_t)

            def plain_fn():
                return race_rollout.race_rollout_plain(*args, **pol, **kw_t)

            res["ms"] = (kernel_ms(kern, "race_rollout_kernel", n=5)
                         or cuda_ms(kern, 5))
            res["queued_ms"] = device_ms(kern, n=5)
            res["plain_ms"] = cuda_ms(plain_fn, 1, warmup=0)
            # the plain rollout is K identical plain steps: count one
            c = census(lambda: race_rollout.race_rollout_plain(
                *args3[:5], None, *args3[6:10], d.RST[:1], d.RSTG[:1],
                d.RSTO[:1], **dict(pol, actn_seq=seq[:1]), **kw_t))
            res.update(bound(args + (pack, obs, seq), kern(), K * c.ops,
                             K * c.flops))
            text, res["launch"] = launch_lines(race_step, "race_rollout",
                                               env, (64, 64))
            print(f"[8] race_rollout[policy, getting_started 1 drone, "
                  f"{n_envs} envs, K={K}]: {res['ms']:.4g} ms on the device "
                  f"per launch ({res['queued_ms']:.4g} ms queued back to "
                  f"back; one thread per env in the env step: "
                  f"{EARLIER_MS['race_rollout[policy]']} ms), plain "
                  f"{res['plain_ms']:.4g} ms, bound {res['bound_ms']:.4g} ms "
                  f"({res['bound_by']}: {res['ops']:.4g} ops, "
                  f"{res['bytes']:.4g} B)", flush=True)
            print(f"[8] race_rollout launches: {text}", flush=True)
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
          + f"; {rate:.6g} env-steps/s on {gpu}; the rollout phase took "
          f"{EARLIER_MS['train rollout phase']} ms with one thread per env "
          f"in the env step",
          flush=True)
    check(last > first, f"mean reward did not rise ({first} -> {last})")
    # the device's idle share over one traced iteration
    tr = traced(lambda: res["train_step"](res["ts"]))
    t_wall, busy = tr.wall_ms, tr.busy_ms()
    top = sorted(tr.events, key=lambda e: -e[2])[:5]
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

        # the trace may drop the launches: then time them queued
        r = {"k5_ms": (kernel_ms(k5, "race_rollout_kernel", n=10)
                       or device_ms(k5, n=5)),
             "k5_loop_ms": cuda_ms(k5, 5)}
        per = kernel_ms(k4x32, "race_step_kernel", n=2)
        r["k4x32_ms"] = None if per is None else K * per
        r["k4x32_loop_ms"] = cuda_ms(k4x32, 3)
        r["plain_ms"] = cuda_ms(lambda: race_rollout.race_rollout_plain(
            *args, emit_obs=False, **kw), 1, warmup=0)
        r["env_steps_per_sec"] = n_envs * K / r["k5_ms"] * 1e3

        def shown(ms):
            return "not measured" if ms is None else f"{ms:.4g} ms"

        out[nd] = r
        print(f"[11] race_rollout, getting_started {nd} drone(s) "
              f"{'COMPETE' if nd > 1 else 'COMPARE'}, {n_envs} envs, K={K}, "
              f"actions: {r['k5_ms']:.4g} ms on the device per launch, "
              f"{r['k5_loop_ms']:.4g} ms per launch in a host loop "
              f"({r['env_steps_per_sec']:.6g} env-steps/s from the device "
              f"time); 32 "
              f"race_step launches {shown(r['k4x32_ms'])} on the device, "
              f"{r['k4x32_loop_ms']:.4g} ms in a host loop; plain "
              f"{r['plain_ms']:.4g} ms; on {gpu} (earlier "
              f"{EARLIER_MS[f'race_rollout[actions, {nd}]']} ms on the "
              f"device)", flush=True)
    text, out["launch"] = launch_lines(race_step, "race_rollout", env,
                                       (64, 64))
    print(f"[11] race_rollout launches at 2 drones: {text}", flush=True)
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
    check(torch.equal(got, ref), "ctrl_step_packed: not bit for bit")
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
    res["ms"], res["enqueue_ms"] = device_host_ms(kern, 50)
    res["plain_ms"] = cuda_ms(plain_fn, 5)
    oc = census(plain_fn)
    res.update(bound((packed, rpm), (got,), oc.ops, oc.flops))
    text, res["launch"] = hover_launch_line(hs, "hover_step", n_envs)
    print(f"[12] ctrl_step_packed vs plain, {n_envs} envs (128 in ground "
          f"contact): max abs err per channel {per_ch} (tol {HOVER_TOL}), "
          f"bit for bit: {torch.equal(got, ref)}; "
          f"{res['ms']:.4g} ms on the device (one thread per env: "
          f"{EARLIER_MS['ctrl_step_packed']} ms), {res['loop_ms']:.4g} ms "
          f"per launch in a host loop, enqueue {res['enqueue_ms']:.4g} ms "
          f"per call, plain {res['plain_ms']:.4g} ms, bound "
          f"{res['bound_ms']:.4g} ms ({res['bound_by']}: {res['ops']:.4g} "
          f"ops, {res['bytes']:.4g} B); {text}", flush=True)

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
            check(bitwise, f"{name}: not bit for bit")
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
    dev_ms, enq_ms = device_host_ms(
        lambda: hs.hover_rollout(P, st0, 3, n_steps, consts=c), n=50)
    res.update(env_steps_per_sec=rate, loop_ms=loop_ms, ms=dev_ms,
               enqueue_ms=enq_ms, headline_reward=total)
    print(f"[13] bench headline (bench.py --impl pallas-rollout): "
          f"{n_envs} envs, {launches} hover_rollout launches x {n_steps} "
          f"steps, seeds 7+i: {rate:.6g} env-steps/s, {loop_ms:.4g} ms per "
          f"launch in the loop (one thread per env: "
          f"{EARLIER_MS['headline loop']} ms), {dev_ms:.4g} ms per launch "
          f"on the device (launches back to back; one thread per env: "
          f"{EARLIER_MS['hover_rollout']} ms), enqueue {enq_ms:.4g} ms per "
          f"hover_rollout call (host clock while the calls queue); reward "
          f"sum {total:.6g}; on {gpu}", flush=True)
    for B, flags in ((n_envs, "1,0"), (n_envs, "0,1"), (65536, "1,0")):
        text, res[f"launch_{B}_{flags}"] = hover_launch_line(
            hs, "hover_rollout", B, flags)
        print(f"[13] {text}", flush=True)
    # the batch that fills the card: 65536 envs
    big = fast_hover.reset_packed([0.0, 0.0, 0.1125], 65536,
                                  device=dev).packed
    res["ms_65536"] = device_ms(
        lambda: hs.hover_rollout(P, big, 3, n_steps, consts=c), n=10)
    res["env_steps_per_sec_65536"] = 65536 * n_steps / res["ms_65536"] * 1e3
    print(f"[13] hover_rollout per launch of {n_steps} steps on the device "
          f"({hs.THREADS}-thread blocks): {n_envs} envs {dev_ms:.4g} ms, 65536 "
          f"envs {res['ms_65536']:.4g} ms "
          f"({res['env_steps_per_sec_65536']:.6g} env-steps/s; one thread "
          f"per env: {EARLIER_MS['hover_rollout[65536]']} ms)", flush=True)
    del big

    def plain_fn():
        return hs.hover_rollout_plain(P, st0, 0, n_steps, actions=acts,
                                      consts=c)

    res["plain_ms"] = cuda_ms(plain_fn, 1, warmup=0)
    # the function's float work (the physics; the in-kernel draw's integer
    # ops are not counted): ops of 2 plain steps x n_steps / 2
    two = census(lambda: hs.hover_rollout_plain(
        P, st0, 0, 2, actions=acts[:2], consts=c))
    res.update(bound((st0,), (st0, st0[0]), two.ops * n_steps // 2,
                     two.flops * n_steps // 2))
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
        check(bitwise, f"{label}: not bit for bit")
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
        two = census(lambda pfn=pfn: pfn(
            P, st0, 0, 2, actions=acts[:2], consts=c))
        r.update(bound((st0,), (st0, st0[0]), two.ops * n_steps // 2,
                       two.flops * n_steps // 2))
        text, r["launch"] = hover_launch_line(
            hs, "hover_rollout", n_envs,
            "0,0" if name.endswith("v2") else "1,0")
        out[name] = r
        print(f"[14] {name}, {n_envs} envs, {launches} launches x "
              f"{n_steps} steps: {r['env_steps_per_sec']:.6g} env-steps/s, "
              f"{r['loop_ms']:.4g} ms per launch in the loop, "
              f"{r['ms']:.4g} ms on the device (one thread per env: "
              f"{EARLIER_MS[name]} ms); {text}; plain "
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
    # the chains' start and final sum run once a launch, the 16 x 8
    # links once an iteration: count both from 1 and 2 iterations
    one, two = (census(lambda n=n: op_calibrate.op_chain_plain(
        "fma", xr, n)).ops for n in (1, 2))
    res.update(bound((xr,), (xr,), (2 * one - two) + (two - one) * iters))
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


def k3_inputs(dev, gen, eval_race, cfg, n_envs, nd, planner):
    """(env, S, W, noise) of a window launch over ``n_envs`` x ``nd``
    agents of config ``cfg`` after three random steps: the window statics
    of random FULLSTATE actions and, with ``planner``, the poly7 planner
    on every other agent with random coefficients around the agent (as
    phase 3). ``noise`` is the config's disturbance block, or a block
    drawn like it where the config has none."""
    from gym_pybullet_adrp_tpu_torch.race_kernel_times import k3_window

    env = eval_race.make_eval_env(cfg, n_envs, dev, seed=1, n_drones=nd)
    st = env.reset()
    for _ in range(3):
        a = torch.rand((n_envs, nd, 4), generator=gen, device=dev) * 2 - 1
        st = env.step(st, a)[0]
    W = k3_window(env, st, gen, planner)
    nz = env.step_draws().noise_rows
    if nz is None:
        shape = (env.n_ticks, 3, env.T, 128)
        nz = torch.cat([
            torch.rand(shape, generator=gen, device=dev) * 0.2 - 0.1,
            torch.randn((env.n_ticks, 4, env.T, 128), generator=gen,
                        device=dev) * 0.001], dim=1).contiguous()
    return env, st.S.contiguous(), W, nz


def phase17(dev, gen, gpu, eval_race, race_window, kernels, plain, totals,
            n_envs=4096, big=65536, iters=3, eager_envs=256):
    """The general race env and its trainer. (a) K3 against its
    plain version bit for bit at the --fast trainer's 4096 x 1 agents,
    level1's 4096 x 2 (noise) and 65536, with and without noise and the
    planner, at the lane count the wrapper picks and at L = 1 and L = 4
    forced; (b) the K3 route against the eager race_step in closed loop
    (tests/test_pallas_race.py:36-59); (c) train(general, fast, twogates,
    4096 envs x 64 steps): 64 K3 launches an iteration; (d) the eager
    general path at 256 envs."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.control import commander as pcmd
    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs import race_fast as pfast
    from gym_pybullet_adrp_tpu_torch.race_kernel_times import ptxas_entries
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Command, RaceMode

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    from gym_pybullet_adrp_tpu_torch.ops import _build

    ptx = ptxas_entries(_build.build_info["ptxas"], ("race_window_kernel",))
    print("[17] race_window instantiations: " + "; ".join(
        f"{k} {v['registers']} registers, {v['stack']} B stack, "
        f"{v['spill_stores']}/{v['spill_loads']} B spill stores/loads"
        for k, v in ptx.items()), flush=True)
    out = {"ptxas": ptx, "lanes": {}, "max_abs_err": 0.0}

    # ---- (a) K3 vs plain at every lane count ------------------------------
    orig = race_window.lane_count
    cases = (("twogates", n_envs, 1), ("level1", n_envs, 2),
             ("getting_started", big, 1))
    for cfg, envs, nd in cases:
        A = envs * nd
        out["lanes"][A] = orig(A, n_sm)
        for planner in (False, True):
            env, S, W, nz = k3_inputs(dev, gen, eval_race, cfg, envs, nd,
                                      planner)
            c = race_window.window_consts(env.kf, env.km, env.arm,
                                          env.ground_z, env.dt, env.n_ticks)
            for noise in (False, True):
                n_ = nz if noise else None
                ref = race_window.race_window_plain(
                    env.kf, env.km, env.arm, env.ground_z, S, W, env.n_ticks,
                    env.dt, n_)
                for L in (None, 1, 4):
                    if L is not None:
                        race_window.lane_count = (
                            lambda a, n_sm=132, _L=L: _L)
                    try:
                        got = race_window.race_window(
                            env.kf, env.km, env.arm, env.ground_z, S, W,
                            env.n_ticks, env.dt, n_, consts=c)
                        torch.cuda.synchronize()
                    finally:
                        race_window.lane_count = orig
                    tag = (f"race_window[{cfg} {A} agents, "
                           f"{'planner' if planner else 'hold'}, "
                           f"{'noise' if noise else 'calm'}, L = "
                           f"{L or orig(A, n_sm)}{'' if L else ' (picked)'}]")
                    err = float((got - ref).abs().max())
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    check(torch.isfinite(got).all().item(),
                          f"{tag}: non-finite")
                    check(torch.equal(got, ref),
                          f"{tag}: not bit for bit (max abs err {err})")
            print(f"[17] race_window vs plain, {cfg} {envs} x {nd} = {A} "
                  f"agents, {'planner on half' if planner else 'no planner'}"
                  f", with and without noise: equal bit for bit at L = {out['lanes'][A]} (picked), "
                  f"1 and 4", flush=True)

    # K3's numbers at the --fast trainer's shape (twogates 4096 x 1, the
    # FULLSTATE targets of its actions: no planner)
    env, S, W, _ = k3_inputs(dev, gen, eval_race, "twogates", n_envs, 1,
                             False)
    c = race_window.window_consts(env.kf, env.km, env.arm, env.ground_z,
                                  env.dt, env.n_ticks)

    def k3():
        return race_window.race_window(env.kf, env.km, env.arm,
                                       env.ground_z, S, W, env.n_ticks,
                                       env.dt, None, consts=c)

    def k3_plain():
        return race_window.race_window_plain(env.kf, env.km, env.arm,
                                             env.ground_z, S, W,
                                             env.n_ticks, env.dt, None)

    out["queued_ms"], out["host_ms"] = device_host_ms(k3)
    traced_ms = kernel_ms(k3, "race_window_kernel")
    out["ms"] = out["queued_ms"] if traced_ms is None else traced_ms
    out["plain_ms"] = cuda_ms(k3_plain, 3, warmup=1)
    oc = census(k3_plain)
    out.update(bound((S, W), (S,), oc.ops, oc.flops))
    print(f"[17] race_window at the --fast trainer's shape (twogates "
          f"{n_envs} x 1, FULLSTATE): {out['ms']:.4g} ms on the device "
          f"({'trace' if traced_ms is not None else 'queued'}; queued "
          f"{out['queued_ms']:.4g}), host enqueue {out['host_ms']:.4g} ms a "
          f"call, L = {out['lanes'][n_envs]}; plain {out['plain_ms']:.4g} ms; "
          f"bound {out['bound_ms']:.4g} ms ({out['bound_by']})", flush=True)

    # ---- (b) the K3 route against the eager race_step, closed loop --------
    cfg = load_config("getting_started")
    spec = prace.RaceSpec.from_config(cfg, 2, RaceMode.COMPARE)
    track = prace.track_tensors(prace.track_from_config(cfg, 2), dev)
    B = 128
    s_ref = prace.race_reset(spec, track, B, device=dev)
    s_fast = prace.race_reset(spec, track, B, device=dev)
    seq = ([(Command.TAKEOFF, (0.3, 1.0))] + [(Command.NONE, ())] * 12
           + [(Command.FULLSTATE, ([0.5, 0.5, 0.5], [0, 0, 0], [0, 0, 0],
                                   0.1, [0, 0, 0], 0.6))] * 5)
    consts = pfast.window_consts_of(spec)
    with plain, LaunchCount(kernels, totals) as la:
        for cmd, args in seq:
            cid, vec = pcmd.pack_command(cmd, args)
            ids = torch.full((B, 2), cid, dtype=torch.int32, device=dev)
            arg = torch.as_tensor(vec, device=dev).expand(B, 2, -1)
            s_ref = prace.race_step(spec, track, s_ref, ids, arg)[0]
            s_fast = pfast.batched_race_step_fast(spec, track, s_fast, ids,
                                                  arg, consts)[0]
        torch.cuda.synchronize()
    dpos = float((s_ref.phys.pos - s_fast.phys.pos).abs().max())
    z = s_fast.phys.pos[:, 0, 2]
    print(f"[17] batched_race_step_fast vs race_step, getting_started "
          f"{B} x 2, TAKEOFF + FULLSTATE ({len(seq)} steps, "
          f"{la['race_window']} race_window launches): max |dpos| {dpos:.3g}"
          f" (bound 0.05), drone 0 z {float(z.min()):.4g}-"
          f"{float(z.max()):.4g} (bound 0.12-0.8)", flush=True)
    check(la["race_window"] == len(seq), f"closed loop launches {dict(la)}")
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(dpos < 0.05, f"closed loop: dpos {dpos}")
    check(torch.equal(s_ref.eliminated, s_fast.eliminated)
          and torch.equal(s_ref.current_gate, s_fast.current_gate),
          "closed loop: gates or eliminations differ")
    check(bool(((0.12 < z) & (z < 0.8)).all()), "closed loop: altitude")
    out["closed_loop_dpos"] = dpos

    # ---- (c) the --fast trainer ----------------------------------------------
    kw = dict(config="twogates", n_envs=n_envs, n_steps=64, general=True,
              device=dev, log_every=1)
    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        res = train_race.train(fast=True, iters=iters, **kw)
        wall = time.perf_counter() - t0
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_window"] == 64 * iters,
          f"--fast trainer: {la['race_window']} race_window launches in "
          f"{iters} iterations, not 64 each")
    m = res["metrics"]
    check(all(math.isfinite(x["loss"]) for x in m), "a non-finite loss")
    steady = res["times"][1:]
    phase_ms = {k: 1e3 * sum(t[k] for t in steady) / len(steady)
                for k in steady[0]}
    rate = res["cfg"].batch_size / (phase_ms["iteration"] / 1e3)
    tr = traced(lambda: res["train_step"](res["ts"]))
    t_wall, busy = tr.wall_ms, tr.busy_ms()
    k3_n, k3_ms = kernel_time(tr.events, "race_window_kernel")
    idle = max(0.0, 1.0 - busy / t_wall)
    out["fast_trainer"] = {"launches_per_iteration": la["race_window"]
                           // iters, "phase_ms": phase_ms,
                           "env_steps_per_sec": rate, "idle_share": idle,
                           "busy_ms": busy, "wall_ms": t_wall,
                           "k3_traced": [k3_n, k3_ms],
                           "losses": [x["loss"] for x in m]}
    out["launches"] = la["race_window"]
    print(f"[17] train(twogates, general, fast, {n_envs} envs x 64 steps, "
          f"{iters} iterations) in {wall:.1f} s: {la['race_window']} "
          f"race_window launches ({la['race_window'] // iters} an "
          f"iteration), losses {[round(x['loss'], 5) for x in m]}; ms per "
          f"iteration (2-{iters}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in phase_ms.items())
          + f"; {rate:.6g} env-steps/s; one traced iteration: wall "
          f"{t_wall:.4g} ms, device busy {busy:.4g} ms (idle share "
          f"{idle:.3f}), {k3_n} race_window launches traced, {k3_ms:.4g} "
          f"ms; on {gpu}", flush=True)

    # ---- (d) the eager general path at the JAX script's 256 envs ---------
    with plain, LaunchCount(kernels, totals) as la:
        res = train_race.train(iters=2, **dict(kw, n_envs=eager_envs,
                                               log_every=0))
    check(all(math.isfinite(x["loss"]) for x in res["metrics"]),
          "eager general: a non-finite loss")
    check(la["race_window"] == 0 and not any(plain.calls.values()),
          f"eager general: launches {dict(la)}, plain calls {plain.calls}")
    t = res["times"][-1]
    step_ms = t["rollout"] / 64 * 1e3
    out["eager_general"] = {
        "phase_ms": {k: v * 1e3 for k, v in t.items()},
        "ms_per_env_step": step_ms,
        "env_steps_per_sec": eager_envs * 64 / t["iteration"]}
    print(f"[17] train(twogates, general, {eager_envs} envs x 64 steps, "
          f"eager 20-tick loop), iteration 2: "
          + ", ".join(f"{k} {v * 1e3:.4g} ms" for k, v in t.items())
          + f"; {step_ms:.4g} ms per env step (host-bound)", flush=True)
    return out


# ---------------------------------------------------------------------------
# 18-22: the league trainer, whole-state checkpoints, the race vector env,
# sim.py and the flagship artifact (V1)

def league_env(dev, n_envs, seed=0):
    """The row env train_race.train builds for phase 18's league command:
    level3, 4 drones COMPETE, end_after_gate 0, elim_penalty 3, per-drone
    reward, telemetry off, its generator seeded as ``seed``'s env seed."""
    import numpy as np
    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import make_row_env
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg = load_config("level3")
    spec = race_mod.RaceSpec.from_config(cfg, 4, RaceMode.COMPETE,
                                         Physics.PYB)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence(seed).generate_state(2)[0]))
    return make_row_env(spec, race_mod.track_from_config(cfg, 4), n_envs,
                        device=dev, generator=gen, end_after_gate=0,
                        per_drone_reward=True, elim_penalty=3.0)


LEAGUE_POOL = ("results/level3_mastery.msgpack",
               "results/seedsweep/best.msgpack",
               "results/captrain/w64_s4.msgpack",
               "results/level3_selfplay.msgpack")


def phase18(dev, gpu, kernels, plain, totals, n_envs=1024, iters=3):
    """The league study's command (results/league/run_league.sh: level3,
    4 drones COMPETE, 1024 envs x 64 steps, lr 1e-4 with decay,
    elim_penalty 3, the four-policy pool, warm start from level3_mastery)
    for ``iters`` iterations with league_refresh 1 and prox_penalty 0.1:
    a finite loss, 64 race_step launches an iteration (the opponents'
    forward between them), slot 0 equal to the learner after each
    refresh."""
    from gym_pybullet_adrp_tpu_torch import train_race

    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        res = train_race.train(
            config="level3", n_envs=n_envs, n_steps=64, iters=iters,
            end_after_gate=0, lr=1e-4, lr_decay=True, elim_penalty=3.0,
            n_drones=4, compete=True,
            league=",".join(str(REPO / p) for p in LEAGUE_POOL),
            league_refresh=1, prox_penalty=0.1,
            init=str(REPO / "results/level3_mastery.msgpack"), device=dev,
            log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    m = res["metrics"]
    check(all(math.isfinite(x["loss"]) for x in m), "league: a loss")
    check(la["race_step_fused"] == 64 * iters
          and la["race_step_fused[policy]"] == 0 and la["race_rollout"] == 0,
          f"league: launches {dict(la)}, not 64 race_step an iteration")
    ts = res["ts"]
    pool = ts.env_state.pool
    layers = list(ts.params.pi) + [ts.params.pi_out]
    check(all(torch.equal(pool.weight[i][0], lay.weight.T)
              and torch.equal(pool.bias[i][0, 0], lay.bias)
              for i, lay in enumerate(layers)),
          "league: slot 0 is not the learner after the refresh")
    steady = res["times"][1:]
    phase_ms = {k: 1e3 * sum(t[k] for t in steady) / len(steady)
                for k in steady[0]}
    rate = n_envs * 4 * 64 / (phase_ms["iteration"] / 1e3)
    print(f"[18] league (level3, 4 drones COMPETE, {n_envs} envs x 64 "
          f"steps, pool of {len(LEAGUE_POOL)}, refresh 1, prox 0.1, "
          f"{iters} iterations) in {wall:.1f} s: launches {dict(la)} "
          f"({la['race_step_fused'] // iters} race_step an iteration); "
          f"losses {[round(x['loss'], 5) for x in m]}; slot 0 == learner; "
          f"ms per iteration (2-{iters}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in phase_ms.items())
          + f"; {rate:.6g} env-steps/s (drone-steps, all 4 drones); "
          f"on {gpu}", flush=True)
    return {"phase_ms": phase_ms, "env_steps_per_sec": rate,
            "launches": dict(la), "losses": [x["loss"] for x in m]}


def _tree_eq(a, b):
    """(equal by torch.equal, max abs difference) of two train states'
    leaves: params, Adam moments, env state, bookkeeping."""
    from gym_pybullet_adrp_tpu_torch.rl import checkpoint as ckpt

    la, lb = ckpt._flatten(a, []), ckpt._flatten(b, [])
    worst, ok = 0.0, len(la) == len(lb)
    for x, y in zip(la, lb):
        pairs = ([(x[k], y[k]) for k in x] if isinstance(x, dict)
                 else [(x, y)] if isinstance(x, torch.Tensor) else [])
        for p, q in pairs:
            ok &= torch.equal(p, q)
            if p.is_floating_point() and p.numel():
                worst = max(worst, float((p - q).abs().max()))
    return ok, worst


def phase19(dev, gpu, kernels, plain, totals, n_envs=4096):
    """Whole-state checkpoint on the card: the row trainer (getting_started
    4096 x 64) for 2 iterations unbroken, twice, which must agree by
    torch.equal; then 1 iteration, save, restore into a fresh TrainState,
    1 more, equal to the unbroken run by torch.equal (parameters, Adam
    moments, env state, metrics)."""
    from gym_pybullet_adrp_tpu_torch import train_race
    from gym_pybullet_adrp_tpu_torch.rl import checkpoint as ckpt

    kw = dict(config="getting_started", n_envs=n_envs, n_steps=64,
              device=dev, log_every=0)
    with plain, LaunchCount(kernels, totals) as la:
        runs = [train_race.train(iters=2, **kw) for _ in range(2)]
        first = train_race.train(iters=1, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            path = ckpt.save_checkpoint(tmp, first["ts"], 1)
            t_save = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in path.iterdir())
            fresh = train_race.train(iters=0, **kw)
            t0 = time.perf_counter()
            ts, step = ckpt.restore_checkpoint(tmp, fresh["ts"], device=dev)
            t_restore = time.perf_counter() - t0
        ts, m = fresh["train_step"](ts)
        torch.cuda.synchronize()
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_step_fused"] == 64 * 6, f"checkpoint: launches {dict(la)}")
    def same_metrics(a, b):     # NaN where no episode ended
        return all(x == y or (math.isnan(x) and math.isnan(y))
                   for x, y in zip(a.values(), b.values()))

    same, d_unbroken = _tree_eq(runs[0]["ts"], runs[1]["ts"])
    same &= all(same_metrics(a, b) for a, b in zip(runs[0]["metrics"],
                                                    runs[1]["metrics"]))
    ok, d = _tree_eq(runs[0]["ts"], ts)
    m = {k: float(v) for k, v in m.items()}
    ok &= same_metrics(m, runs[0]["metrics"][-1])
    print(f"[19] checkpoint, getting_started {n_envs} x 64: two unbroken "
          f"2-iteration runs {'equal bit for bit' if same else 'differ'} "
          f"(max abs {d_unbroken:.3g}); 1 iteration, save ({size} B, "
          f"{t_save * 1e3:.4g} ms), restore into a fresh TrainState "
          f"({t_restore * 1e3:.4g} ms), 1 more: "
          f"{'equal' if ok else 'not equal'} to the unbroken run by "
          f"torch.equal (params, Adam moments, env state, metrics; max abs "
          f"{d:.3g}); launches {dict(la)}; on {gpu}", flush=True)
    check(same, f"two unbroken runs differ on the card ({d_unbroken})")
    check(ok, f"checkpoint resume differs from the unbroken run ({d})")
    return {"unbroken_equal": same, "resume_max_abs": d, "bytes": size,
            "save_ms": t_save * 1e3, "restore_ms": t_restore * 1e3}


def phase20(dev, gpu, kernels, plain, totals, n_envs=4096, steps=256):
    """TorchRaceVectorEnv, fused backend (getting_started, 4096 envs, 2
    drones COMPETE), 256 steps of actions drawn on the card from a seeded
    generator: one race_step launch a step, one download a step, and its
    obs, rewards, dones and telemetry equal (torch.equal, after the
    download) to a direct make_row_env(..., telemetry=True) run from the
    same seed."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import make_row_env
    from gym_pybullet_adrp_tpu_torch.envs.race_vector import (
        TorchRaceVectorEnv,
    )
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

    gen = torch.Generator(device=dev).manual_seed(11)
    acts = torch.rand((steps, n_envs, 2, 4), generator=gen, device=dev) * 2 - 1
    acts_np = acts.cpu().numpy()
    venv = TorchRaceVectorEnv(n_envs, "getting_started", num_drones=2,
                              device=dev)
    check(venv.fused_backend, "the vector env did not take the fused backend")
    venv.reset(seed=5)
    out, downloads = [], []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **k):
        downloads.append(1)
        return cpu(t, *a, **k)

    with plain, LaunchCount(kernels, totals) as la:
        torch.Tensor.cpu = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                out.append(venv.step(acts_np[i]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.Tensor.cpu = cpu
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_step_fused"] == steps and sum(la.values()) == steps,
          f"vector env: launches {dict(la)} in {steps} steps")
    check(len(downloads) == steps, f"{len(downloads)} downloads")
    # the direct row env from the same seed
    cfg = load_config("getting_started")
    spec = prace.RaceSpec.from_config(cfg, 2, RaceMode.COMPETE)
    g2 = torch.Generator(device=dev).manual_seed(5)
    env = make_row_env(spec, prace.track_from_config(cfg, 2), n_envs,
                       device=dev, generator=g2, telemetry=True,
                       per_drone_reward=True)
    st = env.reset()
    for i in range(steps):
        st, obs, rew, done, info = env.step(st, acts[i])
        o, r, te, tr, inf = out[i]
        ref = {"obs": obs, "reward": rew, "done": done,
               "terminated": info["terminated"],
               "current_gate": info["current_gate"].float(),
               "eliminated": info["eliminated"] > 0.5,
               "finished": info["finished"] > 0.5,
               "ep_steps": info["ep_steps"]}
        got = {"obs": o, "reward": r, "done": te | tr, "terminated": te,
               "current_gate": inf["current_gate"],
               "eliminated": inf["eliminated"], "finished": inf["finished"],
               "ep_steps": inf["ep_steps"]}
        for k, v in ref.items():
            g = torch.from_numpy(np.ascontiguousarray(got[k])).to(dev)
            check(torch.equal(g, v.to(g.dtype)),
                  f"vector env step {i}: {k} differs from the row env's")
    ms = wall / steps * 1e3
    rate = n_envs * steps / wall
    n_done = int(sum((o[2] | o[3]).sum() for o in out))
    print(f"[20] TorchRaceVectorEnv (fused, getting_started {n_envs} x 2 "
          f"drones COMPETE, {steps} steps of seeded actions): "
          f"{la['race_step_fused']} race_step launches, {len(downloads)} "
          f"downloads; obs, rewards, dones and telemetry equal to the row "
          f"env's (torch.equal; {n_done} env episodes ended); "
          f"{ms:.4g} ms a step, {rate:.6g} env-steps/s; on {gpu}",
          flush=True)
    return {"ms_per_step": ms, "env_steps_per_sec": rate,
            "launches": dict(la), "episodes_ended": n_done}


def phase21(dev, gpu, kernels, plain, totals):
    """sim.py on the card: simulate("getting_started", "hardcoded",
    n_runs=1, n_drones=2) (both drones through all 4 gates, finished: the
    flagship check), then the port's rl_twogates agent to gate 2 within
    250 steps. The eager general step: no kernel launches."""
    import contextlib
    import io

    from gym_pybullet_adrp_tpu_torch import sim
    from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
    from gym_pybullet_adrp_tpu_torch.utils.utils import load_controller

    buf = io.StringIO()
    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            times = sim.simulate("getting_started", "hardcoded", n_runs=1,
                                 n_drones=2, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("[run")][0]
    n_steps = round(times[0] * 25) + 1
    ms = wall / n_steps * 1e3
    print(f"[21] sim.simulate(getting_started, hardcoded, n_drones=2) on "
          f"the card: {line!r}; {wall:.1f} s for {n_steps} env steps = "
          f"{ms:.4g} ms an env step (eager 20-tick step, B = 1; launches "
          f"{dict(la)}); on {gpu}", flush=True)
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check("gates [4 4]" in line and "finished [ True  True]" in line,
          f"sim: not both drones through 4 gates: {line}")

    env = MultiRaceAviary("twogates", num_drones=1, device=dev)
    obs, info = env.reset()
    agent = load_controller("rl_twogates")(0, obs[0],
                                           dict(info, device=str(dev)))
    t0 = time.perf_counter()
    for i in range(250):
        a = agent.predict(obs[0], ep_time=i / env.CTRL_FREQ)
        obs, _, te, tr, _ = env.step([a])
        if int(env.current_gate[0]) >= 2 or te or tr:
            break
    t_tg = time.perf_counter() - t0
    gate = int(env.current_gate[0])
    print(f"[21] rl_twogates on twogates: gate {gate} after {i + 1} steps "
          f"({t_tg:.1f} s)", flush=True)
    check(gate >= 2, f"rl_twogates reached gate {gate}, not 2")
    return {"line": line, "episode_time": times[0], "wall_s": wall,
            "ms_per_env_step": ms, "twogates_steps": i + 1,
            "twogates_gate": gate}


# the flagship artifact's floors (tests/test_learned_racing.py): across
# float realizations (:139-164, asserted) and on its training platform
# (:167-216, printed)
V1_CROSS = {"per_drone_completion_rate": 0.15, "mean_gates": 1.2}
V1_PLATFORM = {"per_drone_completion_rate": 0.25, "completion_rate": 0.05,
               "mean_gates": 2.5}


def phase22(dev, gpu, eval_race, kernels, plain, totals):
    """V1: evaluate results/level3_mastery.msgpack on level3, 128 envs x 4
    drones COMPETE, through race_step; the cross-platform floors must
    hold; the platform floors are printed."""
    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        out = eval_race.evaluate(str(REPO / "results/level3_mastery.msgpack"),
                                 "level3", 128, device=dev, n_drones=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_step_fused"] == 825, f"V1: launches {dict(la)}")
    cross = {k: out[k] >= v for k, v in V1_CROSS.items()}
    platform = {k: out[k] >= v for k, v in V1_PLATFORM.items()}
    platform["mean_lap_time < 6"] = (out["mean_lap_time"] is not None
                                     and out["mean_lap_time"] < 6.0)
    print(f"[22] V1: evaluate(level3_mastery, level3, 128 envs x 4 drones) "
          f"through race_step ({la['race_step_fused']} launches, "
          f"{wall:.1f} s): {json.dumps(out)}; cross-platform floors "
          f"{V1_CROSS}: {cross}; platform floors {V1_PLATFORM}, lap < 6 s: "
          f"{platform}; on {gpu}", flush=True)
    check(all(cross.values()), f"V1 below the cross-platform floors {cross}")
    return {"metrics": out, "cross": cross, "platform": platform,
            "wall_s": wall}


# ---------------------------------------------------------------------------
# 23-26: the pixels path (the ray-casting renderer, the conv actor-critic,
# the --obs rgb trainer, the pixels evaluator, the RGB gym surfaces) and
# URDF loading. No kernel of the port runs on this path: the render and
# the CNN are plain PyTorch (cuDNN for the convolutions, TF32 off).

RENDER_RTOL = 1e-5       # depth, card against CPU


def px_scene_and_poses(n, seed=0):
    """A getting_started reset's scene (CPU) and ``n`` seeded camera poses
    looking at its gates (eyes within the track's box)."""
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


def phase23(dev, gpu, kernels, plain, totals, n_frames=512):
    """The renderer: 64 seeded poses of the getting_started scene at 64x48
    and 110 degrees on the card and on the CPU (seg equal in every pixel,
    depth within RENDER_RTOL relative; a differing pixel's ray and both
    hits are printed), then one batched render of ``n_frames``
    velocity-camera frames of a ``n_frames``-env general state (the
    trainer's observation) timed with CUDA events, its peak memory, and
    its bound."""
    from gym_pybullet_adrp_tpu_torch.envs import race as prace
    from gym_pybullet_adrp_tpu_torch.envs import race_rl
    from gym_pybullet_adrp_tpu_torch.ops import render
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    scene, eye, tgt = px_scene_and_poses(64)
    ref = render.render(scene, eye, tgt, 64, 48, 110.0)
    card = render.Scene(*(x.to(dev) for x in scene))
    with plain, LaunchCount(kernels, totals) as la:
        got = [x.cpu() for x in render.render(card, eye.to(dev),
                                              tgt.to(dev), 64, 48, 110.0)]
    bad = (got[2] != ref[2]).nonzero()
    if len(bad):
        c, i, j = (int(x) for x in bad[0])
        print(f"[23] seg differs at {len(bad)} pixels; first: camera {c} "
              f"pixel ({i}, {j}), eye {eye[c].tolist()}, target "
              f"{tgt[c].tolist()}: card id {int(got[2][c, i, j])} at t = "
              f"{float(got[1][c, i, j])!r}, CPU id {int(ref[2][c, i, j])} "
              f"at t = {float(ref[1][c, i, j])!r}", flush=True)
    rel = float(((got[1] - ref[1]).abs() / ref[1]).max())
    rgba_err = float((got[0] - ref[0]).abs().max())
    ids = sorted(int(x) for x in torch.unique(ref[2]))
    print(f"[23] render, 64 poses of getting_started at 64x48, 110 deg: "
          f"card vs CPU: seg differs at {len(bad)} of {ref[2].numel()} "
          f"pixels, depth max rel err {rel:.3g} (tol {RENDER_RTOL}), rgba "
          f"max abs err {rgba_err:.3g}; ids seen {ids[:3]}..{ids[-1]}; "
          f"launches {dict(la)}", flush=True)
    check(not len(bad), "render: seg differs between the card and the CPU")
    check(rel <= RENDER_RTOL, f"render: depth rel err {rel}")
    check(not any(la.values()) and not any(plain.calls.values()),
          "render: a kernel or plain version ran")

    cfg = load_config("getting_started")
    spec = prace.RaceSpec.from_config(cfg, 1, RaceMode.COMPARE, Physics.PYB)
    track = prace.track_tensors(prace.track_from_config(cfg, 1), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = race_rl.rl_race_reset(spec, track, n_frames, generator=gen,
                               device=dev)
    vel = st.race.phys.vel + torch.randn(st.race.phys.vel.shape,
                                         generator=gen, device=dev)
    st = st._replace(race=st.race._replace(
        phys=st.race.phys._replace(vel=vel)))

    def frames():
        return race_rl.compute_rgb_obs(spec, st, 64, 48, 110.0, "velocity")

    frames()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(frames, 10, warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    for _ in range(10):
        frames()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    out = frames()
    check(out.shape == (n_frames, 64 * 48 * 3) and bool(
        torch.isfinite(out).all()), "render: frames")
    oc = census(frames)
    rs = st.race
    b = bound((rs.gates_actual, rs.obstacles_actual, rs.phys.pos,
               rs.phys.vel, rs.phys.quat), (out,), oc.ops, oc.flops)
    print(f"[23] compute_rgb_obs, {n_frames} velocity-camera frames at "
          f"64x48, 110 deg (getting_started, "
          f"{scene.seg_a.shape[0]} segments, {scene.cap_center.shape[0]} "
          f"capsules, 1 sphere masked): {ms:.4g} ms a render (CUDA events, "
          f"10 back to back; host enqueue {host_ms:.4g} ms), peak "
          f"{peak / 2**20:.1f} MiB over the state; bound {b['bound_ms']:.4g} "
          f"ms ({b['bound_by']}: {b['ops']:.4g} operations / "
          f"{PEAK_FP32_OPS:.4g} FP32 issues/s = {ops_ms(b['ops']):.4g} ms, "
          f"{b['bytes']} B / 3.35 "
          f"TB/s = {b['bytes'] / PEAK_BYTES * 1e3:.4g} ms); on {gpu}",
          flush=True)
    return {"seg_diff": len(bad), "depth_rel": rel, "rgba_err": rgba_err,
            "render_ms": ms, "host_ms": host_ms, "peak_bytes": peak, **b}


def phase24(dev, gpu, kernels, plain, totals, render_ms, n_envs=512,
            iters=3):
    """The pixels trainer at full width, the round-5 camera-racing recipe
    (results/px5/chain.sh, its last stage): getting_started, obs rgb,
    64x48, 110 deg, velocity camera, 512 envs x 64 steps, full track,
    lr decay, warm start from results/px5/g3.msgpack; ``iters``
    iterations: finite losses, none of K1-K8 launched."""
    from gym_pybullet_adrp_tpu_torch import train_race

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        res = train_race.train(
            config="getting_started", obs="rgb", img="64x48", fov=110.0,
            camera="velocity", n_envs=n_envs, n_steps=64, end_after_gate=0,
            lr_decay=True, init=str(REPO / "results/px5/g3.msgpack"),
            iters=iters, device=dev, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    m = res["metrics"]
    check(all(math.isfinite(x["loss"]) for x in m), "pixels trainer: loss")
    check(not any(la.values()) and not any(plain.calls.values()),
          f"pixels trainer: launches {dict(la)}, plain {plain.calls}")
    steady = res["times"][1:]
    phase_ms = {k: 1e3 * sum(t[k] for t in steady) / len(steady)
                for k in steady[0]}
    rate = n_envs * 64 / (phase_ms["iteration"] / 1e3)
    share = 64 * render_ms / phase_ms["rollout"]
    print(f"[24] train(getting_started, obs rgb, 64x48, 110 deg, velocity, "
          f"{n_envs} envs x 64 steps, warm start g3, {iters} iterations) in "
          f"{wall:.1f} s: losses {[round(x['loss'], 5) for x in m]}; ms per "
          f"iteration (2-{iters}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in phase_ms.items())
          + f"; {rate:.6g} env-steps/s; the render's share of the rollout "
          f"{share:.4f} (64 renders x phase 23's {render_ms:.4g} ms); peak "
          f"memory "
          f"{peak / 2**30:.2f} GiB; launches of K1-K8 {dict(la)}; on {gpu}",
          flush=True)
    return {"phase_ms": phase_ms, "env_steps_per_sec": rate,
            "render_share": share, "peak_bytes": peak,
            "losses": [x["loss"] for x in m], "launches": dict(la)}


# the platform record of results/px5/full.msgpack (results/px5/evals.jsonl,
# VALIDATION.md:334-359): 128 of 128 envs at gate 2, mean gates 2.0; the
# cross-platform floor asserted here
PX5_RECORD = {"gates_hist": {"2": 128}, "mean_gates": 2.0}
PX5_FLOOR = 1.0


def phase25(dev, gpu, kernels, plain, totals):
    """The pixels artifact: eval_race_rgb.evaluate(results/px5/full.msgpack,
    getting_started, 128 envs, 64x48, 110 deg, velocity), deterministic;
    mean gates at least PX5_FLOOR, printed beside the platform record."""
    from gym_pybullet_adrp_tpu_torch import eval_race_rgb

    with plain, LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        out = eval_race_rgb.evaluate(
            str(REPO / "results/px5/full.msgpack"), "getting_started", 128,
            "64x48", 110.0, "velocity", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(not any(la.values()) and not any(plain.calls.values()),
          f"pixels evaluation: launches {dict(la)}")
    print(f"[25] eval_race_rgb.evaluate(px5/full, getting_started, 128 envs, "
          f"64x48, 110 deg, velocity, deterministic) in {wall:.1f} s "
          f"({out['steps']} steps): "
          f"{json.dumps(out)}; platform "
          f"record {PX5_RECORD}; floor mean gates >= {PX5_FLOOR}; on {gpu}",
          flush=True)
    check(out["mean_gates"] >= PX5_FLOOR,
          f"px5/full: mean gates {out['mean_gates']} < {PX5_FLOOR}")
    return {"metrics": out, "wall_s": wall}


def phase26(dev, gpu, kernels, plain, totals, n_envs=1024, n_steps=32):
    """The other pixel surfaces on the card: HoverAviary and
    MultiRaceAviary with RGB observations, _getDroneImages, one PPO
    iteration of a CnnActorCritic over rgb_hover_adapter (``n_envs`` x
    ``n_steps``, 64x48), and a URDF written from the CF2X registry read
    back equal to drone_params(CF2X)."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
    from gym_pybullet_adrp_tpu_torch.envs.aviary import HoverAviary
    from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
    from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
    from gym_pybullet_adrp_tpu_torch.models import urdf
    from gym_pybullet_adrp_tpu_torch.models.drone import (
        _REGISTRY, drone_params,
    )
    from gym_pybullet_adrp_tpu_torch.models.policy import CnnActorCritic
    from gym_pybullet_adrp_tpu_torch.rl import ppo
    from gym_pybullet_adrp_tpu_torch.utils.enums import (
        ActionType, DroneModel, ObservationType,
    )

    with plain, LaunchCount(kernels, totals) as la:
        env = HoverAviary(obs=ObservationType.RGB, device=dev)
        o0 = env.reset()[0]
        o1 = env.step(np.zeros((1, 4)))[0]
        imgs = env._getDroneImages(0)
        race = MultiRaceAviary("getting_started", num_drones=2,
                               obs=ObservationType.RGB, device=dev)
        r0 = race.reset()[0]
        r1 = race.step(np.zeros((2, 4)))[0]
        shapes = [o0.shape, o1.shape, [x.shape for x in imgs], r0.shape,
                  r1.shape]
        check(o0.shape == o1.shape == (1, 48, 64, 4)
              and imgs[0].shape == (48, 64, 4) and imgs[1].shape == (48, 64)
              and imgs[2].shape == (48, 64)
              and r0.shape == r1.shape == (2, 48, 64, 4),
              f"gym RGB shapes {shapes}")

        cfg = ppo.PPOConfig(n_envs=n_envs, n_steps=n_steps)
        rl_cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                                act_type=ActionType.ONE_D_RPM)
        adapter = ppo.rgb_hover_adapter(
            cfg, rl_cfg, drone_params(device=dev),
            np.array([[0.0, 0.0, 0.1125]]), np.zeros((1, 3)), 64, 48,
            device=dev)
        init_fn, train_step, _ = ppo.make_ppo_core(
            cfg, adapter, device=dev,
            network=CnnActorCritic(adapter.act_dim, img_h=48, img_w=64))
        ts = init_fn(0)
        times = {}
        ts, metrics = train_step(ts, times=times)
        loss = float(metrics["loss"])
        check(math.isfinite(loss), "rgb hover PPO: loss")

        raw = dict(_REGISTRY[DroneModel.CF2X])
        p = urdf.drone_params_from_urdf(urdf.write_drone_urdf(raw),
                                        device=dev)
        ref = drone_params(DroneModel.CF2X, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(p, ref))
        check(same and p.mass.device == torch.device(dev),
              "URDF round trip: params differ from drone_params(CF2X)")
    check(not any(la.values()) and not any(plain.calls.values()),
          f"phase 26: launches {dict(la)}")
    print(f"[26] HoverAviary(RGB) reset/step {o0.shape}/{o1.shape}, "
          f"_getDroneImages(0) {[x.shape for x in imgs]}, "
          f"MultiRaceAviary(RGB, 2 drones) {r0.shape}/{r1.shape}; "
          f"make_ppo_core(CnnActorCritic) over rgb_hover_adapter, "
          f"{n_envs} envs x {n_steps} steps at 64x48: loss {loss:.5g}, "
          + ", ".join(f"{k} {v * 1e3:.4g} ms" for k, v in times.items())
          + f"; drone_params_from_urdf(write_drone_urdf(CF2X)) == "
          f"drone_params(CF2X) on the card: {same}; on {gpu}", flush=True)
    return {"shapes": [str(x) for x in shapes], "loss": loss,
            "phase_ms": {k: v * 1e3 for k, v in times.items()},
            "urdf_equal": same}


# ---------------------------------------------------------------------------
# 27-29: the firmware-in-the-loop and Betaflight envs, the controller API
# and differentiable simulation. No kernel of the port runs on these
# paths: the firmware window, the Betaflight step and the autograd paths
# are eager PyTorch (the kernels have no backward and refuse autograd).


def no_launches(la, plain, what):
    check(not any(la.values()) and not any(plain.calls.values()),
          f"{what}: kernel launches {dict(la)}, plain calls {plain.calls}")


def timed_steps(step, n):
    """Run ``step(i)`` for i in range(n); returns (last result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        out = step(i)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase27(dev, gpu, kernels, plain, totals):
    """CFAviary and CFPIDAviary on the card (tests/test_cf_beta.py:14 and
    :34): the Mellinger takeoff to 0.3 m then a goto (0.5, 0.5, 0.5), z in
    (0.2, 0.5) after 100 steps and within 0.08 m of the goal after 200;
    the 1 kHz firmware PID's takeoff within 0.05 m of 0.3 m after 100
    steps. Host-bound at B = 1: ms per control step and per tick."""
    from gym_pybullet_adrp_tpu_torch.envs.cf import CFAviary, CFPIDAviary

    out = {}
    with plain, LaunchCount(kernels, totals) as la:
        env = CFAviary(device=dev)
        env.reset()
        env.sendTakeoffCmd(0.3, 1.5)
        obs, t_up = timed_steps(lambda i: env.step(i)[0], 100)
        z_up = float(obs[0][2])
        check(0.2 < z_up < 0.5, f"CF takeoff: z {z_up} not in (0.2, 0.5)")
        env.sendGotoCmd([0.5, 0.5, 0.5], 0.0, 2.0, False)
        obs, t_go = timed_steps(lambda i: env.step(100 + i)[0], 100)
        err = float(max(abs(obs[0][:3] - 0.5)))
        check(err <= 0.08, f"CF goto: {obs[0][:3].tolist()} off by {err}")
        ms = (t_up + t_go) / 200 * 1e3
        out["mellinger"] = {"z_100": z_up, "goto_err": err,
                            "ms_per_step": ms,
                            "ms_per_tick": ms / env._ticks_per_step}

        env = CFPIDAviary(pyb_freq=1000, device=dev)
        env.reset()
        env.sendTakeoffCmd(0.3, 1.5)
        obs, t_pid = timed_steps(lambda i: env.step(i)[0], 100)
        z_pid = float(obs[0][2])
        check(abs(z_pid - 0.3) <= 0.05, f"CF PID takeoff: z {z_pid}")
        ms = t_pid / 100 * 1e3
        out["pid"] = {"z_100": z_pid, "ms_per_step": ms,
                      "ms_per_tick": ms / env._ticks_per_step}
    no_launches(la, plain, "phase 27")
    m, p = out["mellinger"], out["pid"]
    print(f"[27] CFAviary (Mellinger, 500 Hz, 20 ticks a step) on the card: "
          f"takeoff z {z_up:.4f} after 100 steps, goto (0.5, 0.5, 0.5) off by "
          f"{err:.4f} m after 200; {m['ms_per_step']:.4g} ms a control step, "
          f"{m['ms_per_tick']:.4g} ms a tick; CFPIDAviary (1 kHz, 40 ticks): "
          f"z {z_pid:.4f} after 100 steps, {p['ms_per_step']:.4g} ms a "
          f"step, {p['ms_per_tick']:.4g} ms a tick; launches {dict(la)}; "
          f"on {gpu}", flush=True)
    return out


def phase28(dev, gpu, kernels, plain, totals, cf_steps=None):
    """BetaAviary(num_drones=2) with CTBRControl hovering within 0.05 m of
    its targets after 100 steps (tests/test_cf_beta.py:357); the object
    MellingerControl on CtrlAviary at 500 Hz climbing to 0.35-0.7 m
    (tests/test_controllers.py:211); examples.pid and examples.cf at
    tests/test_examples.py's budgets and thresholds (``cf_steps`` cuts
    the square)."""
    import numpy as np

    from gym_pybullet_adrp_tpu_torch.control import (
        CTBRControl, MellingerControl,
    )
    from gym_pybullet_adrp_tpu_torch.envs.aviary import CtrlAviary
    from gym_pybullet_adrp_tpu_torch.envs.beta import BetaAviary
    from gym_pybullet_adrp_tpu_torch.examples import cf as ex_cf
    from gym_pybullet_adrp_tpu_torch.examples import pid as ex_pid
    from gym_pybullet_adrp_tpu_torch.utils.enums import DroneModel

    out = {}
    with plain, LaunchCount(kernels, totals) as la:
        env = BetaAviary(num_drones=2, device=dev)
        obs, _ = env.reset()
        ctrl = CTBRControl(env.DRONE_MODEL, device=dev)
        target = np.array([[0.0, 0.0, 1.0], [0.3, 0.0, 1.0]])
        act = np.zeros((2, 4))

        def beta_step(i):
            o, *_ = env.step(act, i)
            for j in range(2):
                act[j] = ctrl.computeControlFromState(1 / 25, o[j],
                                                      target[j])
            return o

        obs, t_beta = timed_steps(beta_step, 100)
        beta_err = float(np.abs(obs[:, :3] - target).max())
        check(beta_err <= 0.05, f"Beta hover off by {beta_err} m")
        out["beta"] = {"err": beta_err, "ms_per_step": t_beta / 100 * 1e3}

        env = CtrlAviary(num_drones=1, pyb_freq=500, ctrl_freq=500,
                         initial_xyzs=np.array([[0, 0, 0.1]]), device=dev)
        obs, _ = env.reset()
        mell = MellingerControl(0, DroneModel.CF2X, device=dev)
        mell.reset(np.hstack([obs[0][:3], obs[0][7:10], obs[0][10:13],
                              obs[0][13:16]])[None])
        mell.sendTakeoffCmd(0.5, 2.0)
        mell.process_command_queue(0.0)
        action = np.zeros((1, 4))

        def mell_step(i):
            o, *_ = env.step(action)
            action[0] = mell.computeControl(1 / 500, o[0][:3], o[0][7:10],
                                            o[0][10:13], o[0][13:16],
                                            np.zeros(4))
            return o

        obs, t_mell = timed_steps(mell_step, 1500)
        z_mell = float(obs[0][2])
        check(0.35 < z_mell < 0.7, f"OO Mellinger: z {z_mell}")
        out["mellinger_oo"] = {"z": z_mell, "ms_per_tick": t_mell / 1.5}

        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            log = ex_pid.run(gui=False, plot=False, output_folder=tmp,
                             duration_sec=4, device=dev)
            t_pid = time.perf_counter() - t0
            z_pid = log.states[:, 2, -1]
            check(bool(np.all(z_pid > 0.05)), f"examples.pid: z {z_pid}")
            t0 = time.perf_counter()
            log = ex_cf.run(gui=False, plot=False, output_folder=tmp,
                            steps=cf_steps, device=dev)
            t_cf = time.perf_counter() - t0
            z_cf = float(log.states[0, 2, :].max())
            n_cf = log.states.shape[-1]
            check(z_cf > 0.8, f"examples.cf: max z {z_cf}")
        out["examples"] = {"pid_z": z_pid.tolist(), "pid_s": t_pid,
                           "cf_max_z": z_cf, "cf_steps": n_cf, "cf_s": t_cf}
    no_launches(la, plain, "phase 28")
    print(f"[28] BetaAviary(2 drones) + CTBRControl: off by {beta_err:.4f} m "
          f"after 100 steps, {out['beta']['ms_per_step']:.4g} ms a step; "
          f"MellingerControl on CtrlAviary(500 Hz): z {z_mell:.4f} after "
          f"1500 ticks, {out['mellinger_oo']['ms_per_tick']:.4g} ms a tick; "
          f"examples.pid (3 drones, 4 s): z {np.round(z_pid, 4).tolist()} in "
          f"{t_pid:.1f} s; examples.cf: max z {z_cf:.4f} over {n_cf} steps "
          f"in {t_cf:.1f} s; launches {dict(la)}; on {gpu}", flush=True)
    return out


# the card's gradients, and the apg losses they train, against the CPU's:
# stated first; 1e-6 relative changes of apg's initial weights move its
# 25 losses at 256 envs by at most 1.4e-6 relative on the CPU
GRAD_RTOL = 1e-4
# apg.run(25, 20, 256) at seed 0 (0.822 on the CPU): tests/test_diff.py's
# 0.75 is its 8-env criterion (the best of 25 batches of 8 random
# starts), which tests/test_torch_diff.py holds on the CPU; at 256 envs
# the JAX package reads 0.815-0.820 and the port 0.811-0.854 over seeds
# 0-4 (tests/_apg_ratios.py), so the bar holds seed 0 and the loss
# sequence is held against the CPU's
APG_256_BAR = 0.85


def final_z_grad(device, acts):
    """d(final z)/d(action) of B envs through 5 rl_steps."""
    from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
    from gym_pybullet_adrp_tpu_torch.examples import apg
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params

    params = drone_params(device=device)
    a = acts.to(device).requires_grad_(True)
    st = rlenv.rl_reset(apg.RL_CFG, apg.INIT_XYZS, apg.INIT_RPYS,
                        acts.shape[0], device=device)
    for _ in range(5):
        st, *_ = rlenv.rl_step(apg.RL_CFG, params, st, a)
    g, = torch.autograd.grad(st.core.phys.pos[:, 0, 2].sum(), a)
    return g.cpu()


def grad_step_times(fwd, horizon):
    """(ms a forward step, ms a backward step, peak MiB) of one BPTT
    iteration: ``fwd()`` returns the loss of a ``horizon``-step rollout."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(0)
    base = torch.cuda.memory_allocated(0)
    t0 = time.perf_counter()
    loss, leaves = fwd()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(0) - base) / 2 ** 20
    return (t1 - t0) / horizon * 1e3, (t2 - t1) / horizon * 1e3, peak


# race_grad's iterations in phase 29: 4 of the example's 8 (its loss falls
# from the first; the 8-iteration run took 77-120 s of the smoke's budget)
RACE_GRAD_ITERS = 4


def phase29(dev, gpu, kernels, plain, totals):
    """Differentiable simulation on the card: d(final z)/d(action) through
    5 rl_steps for 64 envs against the CPU at GRAD_RTOL, all positive at
    the zero action; apg.run(iters=25, horizon=20, n_envs=256), its 25
    losses against the CPU's at GRAD_RTOL and its best loss below
    APG_256_BAR x its first; race_grad.run(iters=RACE_GRAD_ITERS,
    horizon=10) with its last loss below its first (:54); ms a forward
    and a backward step and the peak memory of one BPTT iteration of
    each."""
    from gym_pybullet_adrp_tpu_torch.examples import apg, race_grad
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    gen = torch.Generator().manual_seed(0)
    acts = torch.cat([torch.zeros(1, 1, 4),
                      torch.rand((63, 1, 4), generator=gen) * 1.6 - 0.8])
    with plain, LaunchCount(kernels, totals) as la:
        got = final_z_grad(dev, acts)
        ref = final_z_grad("cpu", acts)
        rel = float(((got - ref).abs() / ref.abs()).max())
        check(bool((got[0] > 0).all()) and rel <= GRAD_RTOL,
              f"dz/da: card vs CPU rel err {rel}, zero-action grad {got[0]}")

        t0 = time.perf_counter()
        losses, dist = apg.run(iters=25, horizon=20, n_envs=256, device=dev,
                               verbose=False)
        t_apg = time.perf_counter() - t0
        cpu_losses, _ = apg.run(iters=25, horizon=20, n_envs=256,
                                device="cpu", verbose=False)
        apg_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                          cpu_losses))
        check(apg_rel <= GRAD_RTOL,
              f"apg: card losses vs CPU rel err {apg_rel}")
        ratio = min(losses) / losses[0]
        check(math.isfinite(dist) and ratio < APG_256_BAR,
              f"apg: best loss {min(losses)} not < {APG_256_BAR} x "
              f"{losses[0]}")
        params = drone_params(device=dev)
        net = ActorCritic(apg.RL_CFG.obs_size, 4,
                          generator=torch.Generator().manual_seed(0)).to(dev)
        dz = torch.linspace(-0.05, 0.3, 256, device=dev)
        apg_t = grad_step_times(lambda: (apg.loss_fn(net, params, dz, 20),
                                         list(net.parameters())), 20)

        t0 = time.perf_counter()
        rg_losses, gates, closest = race_grad.run(
            iters=RACE_GRAD_ITERS, horizon=10, verbose=False, device=dev)
        t_rg = time.perf_counter() - t0
        check(all(map(math.isfinite, rg_losses))
              and rg_losses[-1] < rg_losses[0],
              f"race_grad: losses {rg_losses[0]} -> {rg_losses[-1]}")
        spec, track, start, wp, noise = race_grad.setup(device=dev,
                                                        horizon=10)
        plan = torch.zeros((10, 1, 4), device=dev, requires_grad=True)

        def rg_fwd():
            _, traj = race_grad.rollout(spec, track, start, torch.tanh(plan),
                                        noise)
            return race_grad.plan_loss(traj, plan, wp).sum(), [plan]

        rg_t = grad_step_times(rg_fwd, 10)
    no_launches(la, plain, "phase 29")
    print(f"[29] autograd on the card: dz/da through 5 rl_steps, 64 envs, "
          f"max rel err vs CPU {rel:.3g} (tol {GRAD_RTOL}), zero-action "
          f"grad {got[0, 0].tolist()}; apg.run(25 iters, horizon 20, 256 "
          f"envs): loss {losses[0]:.5g} -> best {min(losses):.5g} "
          f"({ratio:.3f} x, bar {APG_256_BAR}), max rel err vs CPU "
          f"{apg_rel:.3g}, final distance {dist:.4f} "
          f"m, {t_apg:.1f} s; one iteration {apg_t[0]:.4g} ms a forward "
          f"step, {apg_t[1]:.4g} "
          f"ms a backward step (checkpointed), peak {apg_t[2]:.1f} MiB; "
          f"race_grad.run({RACE_GRAD_ITERS} iters, horizon 10): loss "
          f"{rg_losses[0]:.5g} -> "
          f"{rg_losses[-1]:.5g}, gates {gates}, closest {closest:.3f} m, "
          f"{t_rg:.1f} s; one iteration {rg_t[0]:.4g} ms a forward step, "
          f"{rg_t[1]:.4g} ms a backward step, peak {rg_t[2]:.1f} MiB; "
          f"launches {dict(la)}; on {gpu}", flush=True)
    return {"dzda_rel_err": rel, "apg_losses": losses, "apg_dist": dist,
            "apg_s": t_apg, "apg_ms": apg_t,
            "race_grad_losses": rg_losses,
            "race_grad_gates": gates, "race_grad_closest": closest,
            "race_grad_s": t_rg, "race_grad_ms": rg_t}


# ---- phases 30-31: distributed training and the training tools ----------

# phase 30's sizes: the race throughput workload (getting_started, 2 drones
# COMPETE), the data-parallel hover PPO and the tensor-parallel step
P30_RACE = dict(n_envs=4096, n_steps=64)
P30_PPO = dict(n_envs=1024, n_steps=32, n_minibatches=4, grad_accum=2)
P30_TIMEOUT = 300
# examples.learn's final deterministic evaluations in phase 31: each of
# the same network replays the same 242 steps (the tests run all 10)
N_EVAL_LEARN = 1


def _hover_setup(dev):
    from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
    from gym_pybullet_adrp_tpu_torch.envs.rl import RLConfig
    from gym_pybullet_adrp_tpu_torch.models.drone import drone_params
    from gym_pybullet_adrp_tpu_torch.utils.enums import ActionType

    return (RLConfig(aviary=AviaryConfig(ctrl_freq=30),
                     act_type=ActionType.RPM), drone_params(device=dev),
            [[0.0, 0.0, 0.1125]], [[0.0, 0.0, 0.0]])


def _rank_race(dev, mesh, rank, world, kernels, plain):
    """Phase 30 (a) in a rank: the sharded race rollout with K4 each step
    and with K5 every 32 steps, its launches counted around the
    distributed run only; the same seed alone after it."""
    from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config
    from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

    cfg = load_config("getting_started")
    spec = race_mod.RaceSpec.from_config(cfg, 2, RaceMode.COMPETE,
                                         Physics.PYB)
    track = race_mod.track_from_config(cfg, 2)
    seed = distributed.rank_seeds(0, world)[rank]
    n, steps = P30_RACE["n_envs"], P30_RACE["n_steps"]
    out = {}
    for k in (0, 32):
        args = (spec, track, n, steps)
        fn = distributed.race_rollout_throughput_fn(mesh, *args,
                                                    rollout_k=k, device=dev)
        fn(seed)                                           # warm-up
        torch.cuda.synchronize()
        with plain, LaunchCount(kernels, dict.fromkeys(
                list(kernels) + ["race_step_fused[policy]"], 0)) as la:
            t0 = time.perf_counter()
            total, local = fn(seed)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        _, alone = distributed.race_rollout_throughput_fn(
            None, *args, rollout_k=k, device=dev)(seed)
        out[str(k)] = {"total": float(total), "local": float(local),
                       "alone": float(alone),
                       "equal": bool(torch.equal(local, alone)),
                       "launches": dict(la), "seconds": sec,
                       "plain_calls": dict(plain.calls)}
    return out


def _rank_ppo(dev, mesh, world):
    """Phase 30 (b) in a rank: make_distributed_ppo, 2 iterations, the
    gradient all-reduces counted; returns the row and the parameters."""
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = _hover_setup(dev)
    cfg = ppo.PPOConfig(**P30_PPO)
    gi, step = distributed.make_distributed_ppo(mesh, cfg, rl_cfg, P, xyz,
                                                rpy, device=dev)
    ts = distributed.host_to_global(mesh, gi(0))
    n_params = sum(p.numel() for p in ts.params.parameters())
    sizes, orig = [], torch.distributed.all_reduce

    def counting(t, *a, **k):
        sizes.append(t.numel())
        return orig(t, *a, **k)

    torch.distributed.all_reduce = counting
    syncs, ms, losses = [], [], []
    try:
        for _ in range(2):
            sizes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = step(ts)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            syncs.append(sum(s == n_params for s in sizes))
    finally:
        torch.distributed.all_reduce = orig
    row = {"grad_syncs": syncs, "ms_per_iter": ms, "losses": losses,
           "expected_syncs": cfg.n_epochs * cfg.n_minibatches
           // cfg.grad_accum, "n_params": n_params}
    return row, [p.detach().cpu() for p in ts.params.parameters()]


def _tensor_errs(got, ref):
    """Per tensor max |diff| over max(1, max |ref|), the largest."""
    return max(float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
               for g, r in zip(got, [r.detach() for r in ref]))


def _rank_pjit(dev, world):
    """Phase 30 (d) in a rank: make_pjit_ppo at dp=1 x tp=world against
    make_ppo in one process (rank 0), 2 iterations."""
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = _hover_setup(dev)
    kw = dict(P30_PPO, grad_accum=1)
    cfg = ppo.PPOConfig(**kw)
    mesh = distributed.make_mesh_2d(1, world)
    init, step = distributed.make_pjit_ppo(mesh, cfg, rl_cfg, P, xyz, rpy,
                                           device=dev)
    ts = init(3)
    losses, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    full = ts.params.full_state_dict()
    row = {"losses": losses, "ms_per_iter": ms}
    if torch.distributed.get_rank() == 0:
        rinit, rstep, _ = ppo.make_ppo(cfg, rl_cfg, P, xyz, rpy, device=dev)
        rts = rinit(3)
        ref = []
        for _ in range(2):
            rts, rm = rstep(rts)
            ref.append(float(rm["loss"]))
        names = [n for n, _ in rts.params.named_parameters()]
        row.update(ref_losses=ref, max_err=_tensor_errs(
            [full[n] for n in names], list(rts.params.parameters())))
    return row


def _rank_world1(dev):
    """Phase 30 (c) in a world of one rank on NCCL: make_distributed_ppo's
    step against make_ppo's from the rank's seed, bit for bit."""
    from gym_pybullet_adrp_tpu_torch.parallel import distributed
    from gym_pybullet_adrp_tpu_torch.rl import ppo

    rl_cfg, P, xyz, rpy = _hover_setup(dev)
    cfg = ppo.PPOConfig(**P30_PPO)
    mesh = distributed.make_mesh()
    gi, step = distributed.make_distributed_ppo(mesh, cfg, rl_cfg, P, xyz,
                                                rpy, device=dev)
    ts = distributed.host_to_global(mesh, gi(0))
    rinit, rstep, _ = ppo.make_ppo(cfg, rl_cfg, P, xyz, rpy, device=dev)
    rts = rinit(distributed.rank_seeds(0, 1)[0])
    for _ in range(2):
        ts, m = step(ts)
        rts, rm = rstep(rts)
    got = [p.detach() for p in ts.params.parameters()]
    ref = [p.detach() for p in rts.params.parameters()]
    return {"equal": all(torch.equal(a, b) for a, b in zip(got, ref)),
            "max_abs_diff": max(float((a - b).abs().max())
                                for a, b in zip(got, ref)),
            "loss": float(m["loss"]), "ref_loss": float(rm["loss"])}


def rank_main(args):
    """A rank of phase 30 (``--rank``): joins the group, runs its cases
    on its card and writes ``rank<R>.json`` (and the PPO parameters) to
    ``--work``."""
    from gym_pybullet_adrp_tpu_torch import _scaling_worker
    from gym_pybullet_adrp_tpu_torch.ops import (
        hover_step, hover_variants, race_rollout, race_step, race_window,
    )
    from gym_pybullet_adrp_tpu_torch import op_calibrate
    from gym_pybullet_adrp_tpu_torch.parallel import distributed, hosts

    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(args.work)
    hosts.ensure_initialized(f"127.0.0.1:{args.port}", args.world,
                             args.rank, backend=args.backend)
    dev = hosts.rank_device("cuda")
    mesh = distributed.make_mesh()
    kernels = {"race_step_fused": race_step.race_step_fused,
               "race_rollout": race_rollout.race_rollout}
    plain = PlainCalls(race_step=race_step, race_window=race_window,
                       race_rollout=race_rollout, hover_step=hover_step,
                       hover_variants=hover_variants,
                       op_calibrate=op_calibrate)
    res = {"backend": torch.distributed.get_backend(), "device": str(dev)}
    if args.world > 1:
        res["race"] = _rank_race(dev, mesh, args.rank, args.world, kernels,
                                 plain)
        res["ppo"], params = _rank_ppo(dev, mesh, args.world)
        torch.save(params, work / f"ppo_params_rank{args.rank}.pt")
        res["pjit"] = _rank_pjit(dev, args.world)
    else:
        res["world1"] = _rank_world1(dev)
    res["allreduce_us"] = 1e6 * _scaling_worker.time_allreduce(
        mesh.get_group("dp"), dev)
    (work / f"rank{args.rank}.json").write_text(json.dumps(res))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_ranks(world, backend, work):
    """Start ``world`` ranks of this script (new processes, never forks of
    this one), wait for them at most ``P30_TIMEOUT`` s, stop every one
    and return their results; a dead or hung rank fails the phase."""
    from gym_pybullet_adrp_tpu_torch.scaling import free_port

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--backend", backend,
         "--work", str(work)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=P30_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                logs.append("(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(all(p.returncode == 0 for p in procs),
          f"{world} {backend} ranks failed: " + "\n".join(
              f"--- rank {r} ---\n{lg[-3000:]}" for r, lg in enumerate(logs)))
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]


def phase30(dev, gpu, kernels, plain, totals):
    """Distributed training on the card: two ranks of this script on gloo
    with CUDA tensors on the one card (NCCL refuses two ranks on one GPU),
    then one rank on NCCL. (a) the sharded race rollout at getting_started
    2-drone COMPETE, 4096 envs a rank x 64 steps, K4 every step and K5
    every 32 steps: each rank's sum equal to the same seed alone by
    torch.equal, the reduced sum the sum of the locals; (b)
    make_distributed_ppo on the hover env, 1024 envs a rank x 32 steps, 4
    minibatches, grad_accum 2, 2 iterations: the ranks' parameters equal
    by torch.equal, n_epochs x 4 / 2 gradient all-reduces an iteration;
    (c) world size 1 on NCCL: make_distributed_ppo's step equal to
    make_ppo's bit for bit; (d) make_pjit_ppo at dp=1 x tp=2 within
    PPO_TOL of make_ppo; (e) the 26,757-float all-reduce on both
    backends. The ranks' K4/K5 launches go into ``totals``."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ranks = run_ranks(2, "gloo", work)
        params = [torch.load(work / f"ppo_params_rank{r}.pt")
                  for r in range(2)]
        (nccl,) = run_ranks(1, "nccl", work)
    check(all(r["backend"] == "gloo" for r in ranks)
          and nccl["backend"] == "nccl", "backends")
    out = {"race": {}, "launches": {"race_step_fused": 0,
                                    "race_rollout": 0}}
    n, steps = P30_RACE["n_envs"], P30_RACE["n_steps"]
    for k, (name, want) in (("0", ("race_step_fused", steps)),
                            ("32", ("race_rollout", steps // 32))):
        rows = [r["race"][k] for r in ranks]
        for r, row in enumerate(rows):
            check(row["equal"], f"race k={k} rank {r}: local "
                  f"{row['local']} != alone {row['alone']}")
            la = row["launches"]
            check(la[name] == want and sum(la.values()) == want,
                  f"race k={k} rank {r}: launches {la}")
            check(not any(row["plain_calls"].values()),
                  f"race k={k}: plain calls {row['plain_calls']}")
            out["launches"][name] += la[name]
            totals[name] += la[name]
        total = np.float32(rows[0]["total"])
        check(all(np.float32(row["total"]) == total for row in rows)
              and total == np.float32(rows[0]["local"])
              + np.float32(rows[1]["local"]) and np.isfinite(total),
              f"race k={k}: reduced {[row['total'] for row in rows]} vs "
              f"locals {[row['local'] for row in rows]}")
        rates = [n * steps / row["seconds"] for row in rows]
        out["race"][k] = {"totals": [row["total"] for row in rows],
                          "rank_env_steps_per_sec": rates,
                          "env_steps_per_sec": 2 * n * steps / max(
                              row["seconds"] for row in rows),
                          "seconds": [row["seconds"] for row in rows]}
        print(f"[30] (a) race_rollout_throughput_fn(getting_started 2-drone "
              f"COMPETE, {n} envs a rank x {steps} steps, rollout_k={k}) on "
              f"2 gloo ranks sharing the card: {want} {name} launches a "
              f"rank; each rank's sum equal to its seed alone (torch.equal)"
              f"; reduced {rows[0]['total']:.9g} = the sum of the locals; "
              f"{rates[0]:.6g} / {rates[1]:.6g} env-steps/s a rank, "
              f"{out['race'][k]['env_steps_per_sec']:.6g} together",
              flush=True)
    ppo_rows = [r["ppo"] for r in ranks]
    check(all(torch.equal(a, b) for a, b in zip(*params)),
          "(b) the ranks' parameters differ")
    for row in ppo_rows:
        check(row["grad_syncs"] == [row["expected_syncs"]] * 2,
              f"(b) gradient all-reduces {row['grad_syncs']}, expected "
              f"{row['expected_syncs']} an iteration")
        check(all(math.isfinite(x) for x in row["losses"]),
              f"(b) losses {row['losses']}")
    out["ppo"] = ppo_rows
    print(f"[30] (b) make_distributed_ppo(hover RPM, {P30_PPO['n_envs']} envs "
          f"a rank x {P30_PPO['n_steps']} steps, 4 minibatches, grad_accum 2)"
          f", 2 iterations on 2 gloo ranks: parameters equal by torch.equal"
          f"; {ppo_rows[0]['grad_syncs']} gradient all-reduces an iteration "
          f"({ppo_rows[0]['n_params']} floats); losses "
          f"{ppo_rows[0]['losses']}; ms an iteration "
          + " / ".join(f"{x:.4g}" for x in ppo_rows[0]["ms_per_iter"]),
          flush=True)
    w1 = nccl["world1"]
    check(w1["equal"] and w1["loss"] == w1["ref_loss"],
          f"(c) world-1 NCCL step differs from make_ppo's: {w1}")
    print(f"[30] (c) world size 1 on NCCL: make_distributed_ppo's 2 steps "
          f"equal to make_ppo's bit for bit (loss {w1['loss']:.9g})",
          flush=True)
    pj = ranks[0]["pjit"]
    check(pj["max_err"] <= PPO_TOL and all(
        math.isclose(a, b, rel_tol=1e-4) for a, b in
        zip(pj["losses"], pj["ref_losses"])),
          f"(d) make_pjit_ppo vs make_ppo: {pj}")
    out["pjit"] = [r["pjit"] for r in ranks]
    print(f"[30] (d) make_pjit_ppo(dp=1 x tp=2, {P30_PPO['n_envs']} envs x "
          f"{P30_PPO['n_steps']} steps) against make_ppo, 2 iterations: "
          f"max per-tensor error {pj['max_err']:.3g} (PPO_TOL {PPO_TOL}), "
          f"losses {pj['losses']} vs {pj['ref_losses']}; ms an iteration "
          + " / ".join(f"{x:.4g}" for x in pj["ms_per_iter"]), flush=True)
    out["allreduce_us"] = {"gloo_2_ranks_cuda": [r["allreduce_us"]
                                                 for r in ranks],
                           "nccl_world_1": nccl["allreduce_us"]}
    print(f"[30] (e) all-reduce of 26,757 float32 (64 dependent syncs): "
          f"gloo, 2 ranks, CUDA tensors "
          + " / ".join(f"{x:.4g}" for x in
                       out["allreduce_us"]["gloo_2_ranks_cuda"])
          + f" us a sync; NCCL, world size 1, "
          f"{nccl['allreduce_us']:.4g} us; phase 30 "
          f"{time.perf_counter() - t_start:.1f} s; on {gpu}", flush=True)
    return out


def phase31(dev, gpu, kernels, plain, totals, phase10_ms=None):
    """The training tools on the card: profile_ppo at getting_started
    4096 x 64 with --fuse_policy (its phases, K5's launches and device
    time, beside phase 10's), examples.learn at the CI size (both
    artifacts written, no kernel launch), and scaling.py's cluster rows at
    1 and 2 processes with the 2-process all-reduce row."""
    from gym_pybullet_adrp_tpu_torch import profile_ppo, scaling
    from gym_pybullet_adrp_tpu_torch.examples import learn

    t_start = time.perf_counter()
    with plain, LaunchCount(kernels, totals) as la:
        prof = profile_ppo.main(["--envs", "4096", "--n_steps", "64",
                                 "--fuse_policy", "--repeats", "1",
                                 "--rounds", "2"])
    t_prof = time.perf_counter() - t_start
    check(not any(plain.calls.values()), f"plain calls {plain.calls}")
    check(la["race_rollout"] > 0 and prof["launches"][
        "rollout (env+policy)"]["race_rollout"] == 4,
          f"profile_ppo launches {dict(la)}, {prof['launches']}")
    ph = {k: v * 1e3 for k, v in prof["phases"].items()}
    uc = prof["update_counts"]
    k5 = (prof["trace"] or {}).get("kernels", {}).get("race_rollout",
                                                       (0, None))
    print(f"[31] profile_ppo(getting_started 4096 x 64, --fuse_policy): "
          + ", ".join(f"{k} {v:.4g} ms" for k, v in ph.items())
          + f"; K5 {prof['launches']['rollout (env+policy)']['race_rollout']:g}"
          f" launches a rollout, traced {k5[0]} launches "
          + (f"{k5[1]:.4g} ms" if k5[1] is not None else "not measured")
          + f" on the device; idle share "
          + (f"{prof['trace']['idle_share']:.3f}" if prof["trace"]
             else "not measured")
          + f"; update counted {uc['ops']:.4g} operations, "
          f"{uc['bytes']:.4g} bytes op by op (the eager update's traffic, "
          f"{uc['traffic_ms']:.4g} ms at HBM's rate), bound "
          f"{uc['bound_ms']:.4g} ms ({uc['bound_by']}: "
          f"{uc['floor_bytes']:.4g} bytes it must move); phase 10 (ms an "
          f"iteration): "
          + (", ".join(f"{k} {v:.4g}" for k, v in phase10_ms.items())
             if phase10_ms else "not run"), flush=True)
    with tempfile.TemporaryDirectory() as tmp, plain, \
            LaunchCount(kernels, totals) as la:
        t0 = time.perf_counter()
        best = learn.run(output_folder=tmp, plot=False, local=False,
                         n_envs=16, n_eval=N_EVAL_LEARN)
        t_learn = time.perf_counter() - t0
        (save,) = Path(tmp).glob("save-*")
        saved = sorted(p.name for p in save.glob("*.msgpack"))
    no_launches(la, plain, "examples.learn")
    check(saved == ["best_model.msgpack", "final_model.msgpack"]
          and math.isfinite(best), f"learn: {saved}, best {best}")
    print(f"[31] examples.learn.run(local=False, n_envs=16, n_eval="
          f"{N_EVAL_LEARN}) on the card: {saved} written, best eval return "
          f"{best:.6g}, {t_learn:.1f} s", flush=True)
    t0 = time.perf_counter()
    backend = scaling.cluster_backend("cuda", (1, 2))
    rows = [scaling.run_cluster(n, 4 // n, 64, 16, 5, backend=backend,
                                timeout=P30_TIMEOUT) for n in (1, 2)]
    ar = scaling.run_cluster(2, 2, 64, 16, 5, mode="allreduce",
                             backend=backend, timeout=P30_TIMEOUT)
    t_scaling = time.perf_counter() - t0
    for r in rows:
        check(math.isfinite(r["sec_per_iter"]), f"scaling row {r}")
    check(all(r["backend"] == backend for r in rows + [ar]),
          f"scaling rows' backends {[r['backend'] for r in rows + [ar]]}, "
          f"expected {backend}")
    print(f"[31] scaling.py (hover PPO, global batch "
          f"{rows[0]['global_batch']}, {backend} ranks sharing the card: the "
          f"process boundary, not multi-GPU scaling): "
          + ", ".join(f"{r['nproc']} proc {r['sec_per_iter'] * 1e3:.4g} ms"
                      for r in rows)
          + f" an iteration, efficiency "
          f"{rows[0]['sec_per_iter'] / rows[1]['sec_per_iter']:.3f}; "
          f"all-reduce 2 proc {ar['sec_per_sync'] * 1e6:.4g} us a sync; "
          f"phase 31 {time.perf_counter() - t_start:.1f} s (profile_ppo "
          f"{t_prof:.1f}, learn {t_learn:.1f}, scaling {t_scaling:.1f}); "
          f"on {gpu}", flush=True)
    return {"profile_ppo": {"phases_ms": ph, "launches": prof["launches"],
                            "trace": prof["trace"],
                            "update_counts": prof["update_counts"]},
            "learn": {"best": best, "seconds": t_learn},
            "scaling": {"ppo": rows, "allreduce": ar}}


# ---- phase 32: the last tools on the card --------------------------------

# the twogates flights of (a) and (d) use rl_twogates, which reaches gate 2
# in ~25-31 steps (hardcoded_twogates clears gate 1 only, on both
# packages); the report's episode is cut to P32_REPORT_SEC of sim time,
# gate 2 inside it; a cap on the wrapped flight's steps
P32_AGENT = "rl_twogates"
P32_REPORT_SEC = 2.4
P32_MAX_STEPS = 250
P32_VIDEO = dict(frames=20, width=320, height=240)
P32_PROBE_GRID = 32
# the reference's rig steps CtrlAviary at 240 Hz in real time; the live
# page polls /state LIVE_POLL_S after each answer, here for LIVE_SECONDS
LIVE_RIG_MS = 1e3 / 240
LIVE_POLL_S = 0.05
LIVE_SECONDS = 3.0


def _p32_wrappers(dev):
    """(a) RewardWrapper(DroneObservationWrapper(MultiRaceAviary)) flown
    to its end: terminated no later than the step that counts gate 2,
    every reward finite, their sum above one gate's bonus."""
    from gym_pybullet_adrp_tpu_torch.envs.race import MultiRaceAviary
    from gym_pybullet_adrp_tpu_torch.utils.utils import load_controller
    from gym_pybullet_adrp_tpu_torch.utils.wrapper import (
        DroneObservationWrapper, RewardWrapper,
    )

    env = RewardWrapper(DroneObservationWrapper(
        MultiRaceAviary("twogates", num_drones=1, device=dev)))
    check(env.unwrapped is env.env.env, "wrappers: unwrapped")
    obs, info = env.reset()
    agent = load_controller(P32_AGENT)(0, obs[0],
                                       dict(info, delay=0, device=str(dev)))
    rewards, gate2_step, te = [], None, False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(P32_MAX_STEPS):
        a = agent.predict(obs[0], ep_time=i / env.CTRL_FREQ)
        obs, r, te, tr, _ = env.step([a])
        rewards.append(r)
        if gate2_step is None and int(env.unwrapped.current_gate[0]) >= 2:
            gate2_step = i
        if te or tr:
            break
    ms = (time.perf_counter() - t0) / len(rewards) * 1e3
    check(te and gate2_step is not None and i <= gate2_step,
          f"wrappers: terminated {te} at step {i}, gate 2 at {gate2_step}")
    check(all(map(math.isfinite, rewards)) and sum(rewards) > 5.0,
          f"wrappers: rewards {rewards}")
    return {"steps": i + 1, "gate2_step": gate2_step,
            "reward_sum": sum(rewards), "ms_per_step": ms}


def _p32_video(dev, tmp):
    """(c) race_video.run: the PNG frames, each decoded by the port's own
    reader (no PIL) to H x W x 4."""
    import contextlib
    import io
    import os

    from gym_pybullet_adrp_tpu_torch.examples import race_video
    from gym_pybullet_adrp_tpu_torch.utils.rendering import read_png

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rec = race_video.run(out=tmp, device=dev, **P32_VIDEO)
    secs = time.perf_counter() - t0
    files = sorted(f for f in os.listdir(rec.path) if f.endswith(".png"))
    shapes = set()
    for f in files:
        with open(os.path.join(rec.path, f), "rb") as fh:
            shapes.add(read_png(fh.read()).shape)
    want = (P32_VIDEO["height"], P32_VIDEO["width"], 4)
    check(len(files) == P32_VIDEO["frames"] and shapes == {want},
          f"race_video: {len(files)} frames, shapes {shapes}")
    return {"frames": len(files), "ms_per_frame":
            secs / len(files) * 1e3}


def _p32_reports(dev, tmp):
    """(d) flight_report.record_episode on twogates (1 drone, the episode
    cut to P32_REPORT_SEC): gate events G1 and G2; the same telemetry
    through replay_viewer.build_html; render_report where matplotlib is
    installed."""
    import importlib.util

    from gym_pybullet_adrp_tpu_torch import flight_report, replay_viewer
    from gym_pybullet_adrp_tpu_torch.utils.config import load_config

    cfg = load_config("twogates")
    cfg.episode_len_sec = P32_REPORT_SEC
    t0 = time.perf_counter()
    poses, gates_t, events, track, freq = flight_report.record_episode(
        cfg, P32_AGENT, 1, device=dev)
    secs = time.perf_counter() - t0
    labels = [e[3] for e in events if e[2] == "gate"]
    check(labels[:2] == ["G1", "G2"] and poses.shape[1:] == (1, 6)
          and np.isfinite(poses).all(),
          f"record_episode: events {events}, poses {poses.shape}")
    html = replay_viewer.build_html(poses, gates_t, events, track, freq,
                                    "twogates, card")
    check("requestAnimationFrame" in html and len(html) > 8000,
          "build_html: not the replay page")
    (Path(tmp) / "replay.html").write_text(html)
    if importlib.util.find_spec("matplotlib") is None:
        report = ("render_report not run: matplotlib is not installed on "
                  "this machine")
    else:
        png = flight_report.render_report(poses, gates_t, events, track,
                                          freq, Path(tmp) / "report.png")
        report = f"render_report wrote {png.stat().st_size} B"
    return {"steps": poses.shape[0], "events": events, "seconds": secs,
            "ms_per_step": secs / poses.shape[0] * 1e3,
            "html_bytes": len(html), "report": report}


def _p32_live(dev):
    """(e) live_fly.serve(port=0) in a thread: the page, 21000 RPM posted,
    /state polled three times (z up by more than 0.05 m, a PNG), /reset;
    then the page's loop, /state polled LIVE_POLL_S after each answer for
    LIVE_SECONDS: the sim time it advanced over the wall time
    (``RealTimeFactor``), and LiveSim's totals of those polls, the host
    time of a control step and of a poll's frame."""
    import base64
    import threading
    import urllib.request

    from gym_pybullet_adrp_tpu_torch import live_fly
    from gym_pybullet_adrp_tpu_torch.utils.profiling import RealTimeFactor

    httpd = live_fly.serve(port=0, device=dev)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path, data=None):
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if data is None
                                     else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    try:
        page = get("/").decode()
        check("input type=range" in page and "/rpm" in page,
              "live_fly: the page")
        get("/rpm", b"[21000,21000,21000,21000]")
        s = []
        for k in range(3):
            if k:
                time.sleep(0.3)
            s.append(json.loads(get("/state")))
        check(s[2]["t"] > s[0]["t"] and s[2]["pos"][2] > s[0]["pos"][2] + 0.05,
              f"live_fly: z {s[0]['pos'][2]} -> {s[2]['pos'][2]}")
        check(base64.b64decode(s[1]["png"])[:8] == b"\x89PNG\r\n\x1a\n",
              "live_fly: /state's frame is not a PNG")
        get("/reset", b"")
        s3 = json.loads(get("/state"))
        check(s3["t"] < s[2]["t"] and s3["pos"][2] < s[2]["pos"][2],
              f"live_fly: /reset: t {s3['t']}, z {s3['pos'][2]}")
        sim = httpd.sim
        # the page's sliders start at the hover RPM
        get("/rpm", json.dumps([sim.env.HOVER_RPM] * 4).encode())
        get("/state")
        n0, s0, p0, f0 = (sim.n_steps, sim.step_seconds, sim.n_polls,
                          sim.frame_seconds)
        t_sim = sim.t
        rtf = RealTimeFactor()
        while time.time() - rtf.start < LIVE_SECONDS:
            get("/state")
            time.sleep(LIVE_POLL_S)
        get("/state")
        wall = time.time() - rtf.start
        factor = rtf.factor(sim.t - t_sim)
        n, secs = sim.n_steps - n0, sim.step_seconds - s0
        polls, frame = sim.n_polls - p0, sim.frame_seconds - f0
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    check(n > 0 and polls > 0, f"live_fly: {n} steps in {polls} polls")
    return {"z": [x["pos"][2] for x in s], "t": [x["t"] for x in s],
            "real_time_factor": factor, "wall_s": wall, "polls": polls,
            "steps": n, "ms_per_step": secs / n * 1e3,
            "frame_ms_per_poll": frame / polls * 1e3,
            "busy_share": (secs + frame) / wall}


def phase32(dev, gpu, kernels, plain, totals, results, times11):
    """The last tools on the card, none of which launches a kernel: (a)
    the race wrappers, (b) hover_ceiling's probe at the 32 x 32 grid, (c)
    race_video, (d) flight_report and replay_viewer, (e) live_fly; then
    (f) the roofline shares of the kernels' rates measured in phases 6,
    11 and 13, the census recounted on the card and calibrated by phase
    15's weights, and every kernel's corrected operation bound beside its
    time (K6 at or under 100%)."""
    from gym_pybullet_adrp_tpu_torch.examples import hover_ceiling
    from gym_pybullet_adrp_tpu_torch.utils import roofline as rf

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, plain, \
            LaunchCount(kernels, totals) as la:
        out["wrappers"] = w = _p32_wrappers(dev)
        print(f"[32] (a) RewardWrapper(DroneObservationWrapper("
              f"MultiRaceAviary(twogates, 1 drone))), {P32_AGENT}: "
              f"terminated at step {w['steps']} (gate 2 counted on step "
              f"{w['gate2_step'] + 1}), reward sum {w['reward_sum']:.4f}; "
              f"{w['ms_per_step']:.4g} ms a wrapped step", flush=True)
        ub = hover_ceiling.analytic_upper_bound()
        t0 = time.perf_counter()
        best, kp, kd = hover_ceiling.probe_best_return(P32_PROBE_GRID,
                                                       device=dev)
        out["probe"] = {"ub": ub, "best": best, "kp": kp, "kd": kd,
                        "seconds": time.perf_counter() - t0}
        check(ub - 1.0 <= best <= ub + 0.2 and best >= 471.0,
              f"hover_ceiling: best {best} against the bound {ub}")
        print(f"[32] (b) hover_ceiling.probe_best_return(grid="
              f"{P32_PROBE_GRID}), {P32_PROBE_GRID ** 2} envs x 242 steps: "
              f"best {best:.4f} (kp {kp:.4g}, kd {kd:.4g}), bound {ub:.4f}; "
              f"{out['probe']['seconds']:.2f} s", flush=True)
        out["video"] = v = _p32_video(dev, tmp)
        print(f"[32] (c) race_video.run({P32_VIDEO}): {v['frames']} PNGs "
              f"decoded to {P32_VIDEO['height']} x {P32_VIDEO['width']} x 4 "
              f"by utils/rendering.read_png; {v['ms_per_frame']:.4g} ms a "
              f"frame (step and render)", flush=True)
        out["reports"] = r = _p32_reports(dev, tmp)
        print(f"[32] (d) flight_report.record_episode(twogates cut to "
              f"{P32_REPORT_SEC} s, {P32_AGENT}): {r['steps']} steps, "
              f"events {r['events']}, {r['ms_per_step']:.4g} ms a step; "
              f"replay_viewer.build_html {r['html_bytes']} B; "
              f"{r['report']}", flush=True)
        out["live"] = lv = _p32_live(dev)
        print(f"[32] (e) live_fly.serve(port=0): z {lv['z']} over polls at "
              f"t {lv['t']}; the page's loop ({LIVE_POLL_S} s after each "
              f"answer) for {lv['wall_s']:.4g} s: {lv['polls']} polls, "
              f"{lv['steps']} control steps, real-time factor "
              f"{lv['real_time_factor']:.4g} (sim time over wall time); "
              f"{lv['ms_per_step']:.4g} ms a control step (the 240 Hz rig: "
              f"{LIVE_RIG_MS:.3g} ms), {lv['frame_ms_per_poll']:.4g} ms a "
              f"poll's frame (render, 4x, PNG); the server busy "
              f"{100 * lv['busy_share']:.4g}% of the wall time", flush=True)
        torch.cuda.synchronize()
    no_launches(la, plain, "phase 32")

    # (f) the roofline shares
    census = rf.measure_ops_per_env_step(dev)
    cal_run = {k: rf.cal_ops(v, results["op_chain"]["weights"])
               for k, v in census["by_op"].items()}
    for k, v in census["ops"].items():
        check(abs(v - rf.OPS_PER_ENV_STEP[k]) <= 0.02 * v,
              f"roofline: {k} counts {v} on the card, stored "
              f"{rf.OPS_PER_ENV_STEP[k]}")
    n = 4096
    k4_rate = n / results["race_step_fused"]["ms"] * 1e3
    rows = [("K2 hover_rollout headline (phase 13)", "hover",
             results["hover_rollout"]["env_steps_per_sec"],
             rf.hover_rollout_bytes_per_step(n, 64)),
            ("K5 race_rollout actions, 1 drone (phase 11)", "race1",
             times11[1]["env_steps_per_sec"],
             rf.race_rollout_bytes_per_step(n, 1)),
            ("K5 race_rollout actions, 2 drones (phase 11)", "race2",
             times11[2]["env_steps_per_sec"],
             rf.race_rollout_bytes_per_step(n, 2)),
            ("K4 race_step_fused, 2 drones (phase 6)", "race2", k4_rate,
             rf.race_fused_bytes_per_step(n, 2))]
    out["roofline"] = {}
    for label, case, rate, by in rows:
        pct = rf.roofline_pct(rate, rf.OPS_PER_ENV_STEP[case], by,
                              rf.CAL_OPS_PER_ENV_STEP[case])
        pct["fp32_cal_pct_this_run"] = 100.0 * rate * cal_run[case] / \
            rf.H100["fp32_issues_per_s"]
        out["roofline"][label] = dict(pct, rate=rate, bytes=by)
        check(all(0.0 < pct[k] <= 100.0 for k in ("fp32_pct", "hbm_pct",
                                                  "fp32_cal_pct")),
              f"roofline: {label} {pct}")
        print(f"[32] (f) {label}: {rate:.6g} env-steps/s x "
              f"{rf.OPS_PER_ENV_STEP[case]:.0f} ops = fp32_pct "
              f"{pct['fp32_pct']:.4g}, fp32_cal_pct {pct['fp32_cal_pct']:.4g} "
              f"({pct['fp32_cal_pct_this_run']:.4g} by phase 15's weights), "
              f"hbm_pct {pct['hbm_pct']:.4g} ({by:.4g} B a step)",
              flush=True)
    print(f"[32] (f) census on the card (ops per env-step): "
          f"{census['ops']}; calibrated by phase 15's weights {cal_run}",
          flush=True)
    out["bounds"] = {}
    for name, r in results.items():
        if not isinstance(r, dict) or "bound_ms" not in r or "ms" not in r:
            continue
        out["bounds"][name] = share = r["bound_ms"] / r["ms"]
        print(f"[32] (f) bound of {name}: {r['bound_ms']:.4g} ms "
              f"({r['bound_by']}; {r['ops']:.4g} ops at "
              f"{PEAK_FP32_OPS:.4g} issues/s, {r['bytes']:.4g} B at "
              f"{PEAK_BYTES:.3g} B/s), card {r['ms']:.4g} ms: "
              f"{100 * share:.4g}% of the card time", flush=True)
    check(out["bounds"]["op_chain"] <= 1.0,
          f"K6 above its bound: {out['bounds']['op_chain']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[32] phase 32 {out['seconds']:.1f} s; launches {dict(la)}; on "
          f"{gpu}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the build report and metrics")
    # a rank of phase 30, started by the script itself
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.rank is not None:
        return rank_main(args)
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
    oc = census(lambda: race_window.race_window_plain(
        env.kf, env.km, env.arm, env.ground_z, st.S, W, env.n_ticks,
        env.dt, noise))
    k3.update(bound((st.S, W, noise), (st.S,), oc.ops, oc.flops))
    results["race_window"] = k3

    # ---- 4. race_step kernel vs plain -----------------------------------------
    # after the getting_started and level1 cases, the main paths' own envs:
    # the evaluation's (phase 5: level1, 128 envs, 1 drone, seed 42, 4
    # tiles of 32 envs), the league trainer's (phase 18) and V1's (phase 22)
    k4 = {"max_abs_err": 0.0}
    cases = [(f"{cfg} {n} envs N={nd}",
              lambda cfg=cfg, nd=nd, n=n, seed=seed: eval_race.make_eval_env(
                  cfg, n, dev, seed=seed, n_drones=nd))
             for cfg, nd, n, seed in (("getting_started", 2, n_envs, 5),
                                      ("getting_started", 1, n_envs, 5),
                                      ("level1", 1, n_envs, 5),
                                      ("level1", 1, 128, 42),
                                      ("level3", 4, 128, 42))]
    cases.insert(4, ("league: level3 1024 envs N=4",
                     lambda: league_env(dev, 1024)))
    for label, make in cases:
        env = make()
        n, nd = env.n_envs, env.N
        st = env.reset()
        for i in range(13):
            a = torch.rand((n, nd, 4) if nd > 1 else (n, 4),
                           generator=gen, device=dev) * 2 - 1
            draws = env.step_draws()
            args_ = (env.kf, env.km, env.arm, env.ground_z, st.S,
                     env.action_rows(a), st.R, st.GG, st.OO, st.EP,
                     draws.RST, draws.RSTG, draws.RSTO)
            kw = dict(n_ticks=env.n_ticks, dt=env.dt,
                      spec_tail=env.spec_tail, noise_rows=draws.noise_rows,
                      telemetry=env.telemetry, elim_penalty=env.elim_penalty)
            ref = race_step.race_step_fused_plain(*args_, **kw)
            if i >= 10:  # compare 3 consecutive steps, from the same input
                got = race_step.race_step_fused(*args_, **kw)
                torch.cuda.synchronize()
                name = f"race_step[{label} step {i}]"
                errs = check_step(name, dict(zip(STEP_OUT, got)),
                                  dict(zip(STEP_OUT, ref)))
                check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                      f"{name}: not equal to the plain version bit for bit")
                k4["max_abs_err"] = max(k4["max_abs_err"], errs["max"])
                print(f"[4] {name}: equal to the plain version bit for bit "
                      f"(all {len(got)} outputs; {int(ref[7].sum())} envs "
                      f"done)", flush=True)
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
    k4["ms"] = (prof["kernel_ms"] / prof["launches"] if prof["launches"]
                else k4["loop_ms"])
    st = env.reset()
    k4_in = (st.S, rows[0], st.R, st.GG, st.OO, st.EP, draws.RST,
             draws.RSTG, draws.RSTO)
    k4["queued_ms"] = device_ms(lambda: race_step.race_step_fused(
        env.kf, env.km, env.arm, env.ground_z, *k4_in, **kw))
    print(f"[6] profile, {n_prof} kernel steps: wall {prof['wall_ms']:.4g} "
          f"ms, {prof['launches']} race_step launches traced, "
          f"{prof['kernel_ms']} ms on the device (device idle share "
          f"{prof['idle_share']}): {k4['ms']:.4g} ms per launch, "
          f"{k4['queued_ms']:.4g} ms queued back to back (one thread per "
          f"env, the drones' windows in turn: "
          f"{EARLIER_MS['race_step_fused']} ms queued)", flush=True)
    text, k4["launch"] = launch_lines(race_step, "race_step", env, (64, 64))
    print(f"[6] race_step launches: {text}", flush=True)

    def k4_plain():
        return race_step.race_step_fused_plain(env.kf, env.km, env.arm,
                                               env.ground_z, *k4_in, **kw)

    oc = census(k4_plain)
    k4.update(bound(k4_in, k4_plain(), oc.ops, oc.flops))
    print(f"[6] race_step bound: {k4['bytes']} B moved = "
          f"{k4['bytes'] / PEAK_BYTES * 1e3:.4g} ms, {k4['ops']} operations "
          f"of the plain version = {ops_ms(k4['ops']):.4g} ms: "
          f"bound {k4['bound_ms']:.4g} ms ({k4['bound_by']})", flush=True)
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

    # ---- 17. the general race env, its K3 route and trainer ---------------
    results["race_window[phase 3]"] = results["race_window"]
    general = phase17(dev, gen, gpu, eval_race, race_window, kernels, plain,
                      main_launches)
    results["race_window"] = general

    # ---- 18-22. the league, checkpoints, the public surfaces, V1 ----------
    surfaces = {
        "league": phase18(dev, gpu, kernels, plain, main_launches),
        "checkpoint": phase19(dev, gpu, kernels, plain, main_launches),
        "race_vector_env": phase20(dev, gpu, kernels, plain, main_launches),
        "sim": phase21(dev, gpu, kernels, plain, main_launches),
        "v1": phase22(dev, gpu, eval_race, kernels, plain, main_launches),
    }

    # ---- 23-26. the pixels path and URDF loading --------------------------
    px = {"render": phase23(dev, gpu, kernels, plain, main_launches)}
    px["trainer"] = phase24(dev, gpu, kernels, plain, main_launches,
                            px["render"]["render_ms"])
    px["artifact"] = phase25(dev, gpu, kernels, plain, main_launches)
    px["surfaces"] = phase26(dev, gpu, kernels, plain, main_launches)

    # ---- 27-29. CF and Beta envs, the controller API, autograd ------------
    fitl = {"cf": phase27(dev, gpu, kernels, plain, main_launches),
            "beta_api": phase28(dev, gpu, kernels, plain, main_launches,
                                cf_steps=200),
            "grad": phase29(dev, gpu, kernels, plain, main_launches)}

    # ---- 30-31. distributed training, the training tools --------------------
    dist_out = phase30(dev, gpu, kernels, plain, main_launches)
    tools = phase31(dev, gpu, kernels, plain, main_launches,
                    train_out["phase_ms"])

    # ---- 32. the last tools, and the roofline -------------------------------
    last_tools = phase32(dev, gpu, kernels, plain, main_launches, results,
                         times11)

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
    # K3's launches are its main path's, the --fast trainer's (phase 17);
    # the others', every path's that launched them
    main_launches["race_window"] = general["launches"]
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
            "loop_ms": {"race_window":
                        results["race_window[phase 3]"]["loop_ms"],
                        "race_step_fused": k4["loop_ms"]},
            "profile": prof, "scaling": scaling,
            "seconds": {"eval_fused": t_fused, "eval_unfused": t_unfused},
            "ppo_card_vs_cpu": ppo_err, "training": train_out,
            "rollout_times": times11, "hover_ppo": hover_ppo,
            "general": general, "surfaces": surfaces, "pixels": px,
            "firmware_and_grad": fitl, "distributed": dist_out,
            "tools": tools, "last_tools": last_tools,
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

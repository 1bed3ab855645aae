"""Drive the PyTorch/CUDA port of the race env on one NVIDIA GPU.

Builds the race kernels from gym_pybullet_adrp_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, evaluates the shipped
level1 policy through the port's main path (the fused race step kernel,
and the window kernel + plain tail), and times the fused step against its
plain version. Every phase prints one line; any failed phase exits
non-zero without the final result line.

Usage (needs one CUDA device and nvcc; no JAX):
  python3 chip_smoke.py [--out DIR]

``--out`` also writes the nvcc/ptxas report and the metrics there.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

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
    from gym_pybullet_adrp_tpu_torch.ops import _build, race_step, race_window
    from gym_pybullet_adrp_tpu_torch import eval_race

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
    _build.library()
    info = _build.build_info
    print(f"[2] build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.get('seconds', 0.0):.1f} s, "
          f"cached={info.get('cached')}) -> {info['path']}", flush=True)
    if out_dir and info.get("ptxas"):
        (out_dir / "ptxas.txt").write_text(info["ptxas"])
    for line in (info.get("ptxas") or "").splitlines():
        if "registers" in line or "spill" in line:
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
    results["race_window"] = k3

    # ---- 4. race_step kernel vs plain -----------------------------------------
    k4 = {"max_abs_err": 0.0}
    for cfg, nd in (("getting_started", 2), ("level1", 1)):
        env = eval_race.make_eval_env(cfg, n_envs, dev, seed=5, n_drones=nd)
        env.telemetry = True
        st = env.reset()
        n_done = 0
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
                compare_s(name + " S", got[0], ref[0])
                for j, lbl in ((1, "R"), (5, "OBS"), (6, "REW")):
                    check(got[j].shape == ref[j].shape, f"{name} {lbl} shape")
                    check(torch.isfinite(got[j]).all().item(),
                          f"{name} {lbl} non-finite")
                check(torch.equal(got[1][:4], ref[1][:4]),
                      f"{name}: discrete R rows differ")
                r_err = float((got[1][4:] - ref[1][4:]).abs().max())
                check(r_err <= TOL["pos/quat/vel"],
                      f"{name}: R rows err {r_err}")
                o_err = float((got[5] - ref[5]).abs().max())
                check(o_err <= TOL["obs"], f"{name}: OBS err {o_err}")
                w_err = float((got[6] - ref[6]).abs().max())
                check(w_err <= TOL["reward"], f"{name}: REW err {w_err}")
                for j, lbl in ((2, "GG"), (3, "OO"), (4, "EP"), (7, "DONE"),
                               (8, "INFO")):
                    check(torch.equal(got[j], ref[j]),
                          f"{name}: {lbl} differs")
                n_done += int(ref[7].sum())
                k4["max_abs_err"] = max(
                    k4["max_abs_err"],
                    max(float((g - r).abs().max())
                        for g, r in zip(got, ref)))
                print(f"[4] {name}: S ok, R err {r_err:.3g}, OBS err "
                      f"{o_err:.3g}, REW err {w_err:.3g}, DONE/INFO/GG "
                      f"equal ({int(ref[7].sum())} envs done)", flush=True)
            st = st._replace(S=ref[0], R=ref[1], GG=ref[2], OO=ref[3],
                             EP=ref[4])

    # ---- 5. the slice: evaluate the shipped level1 policy ---------------------
    calls = {"plain_step": 0, "plain_window": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    orig_step_plain = race_step.race_step_fused_plain
    orig_window_plain = race_window.race_window_plain
    race_step.race_step_fused_plain = counting("plain_step", orig_step_plain)
    race_window.race_window_plain = counting("plain_window",
                                             orig_window_plain)
    policy = str(REPO / "results/level1_robust.msgpack")
    race_step.race_step_fused.launches = 0
    race_window.race_window.launches = 0
    t0 = time.perf_counter()
    m_fused = eval_race.evaluate(policy, "level1", 128, device=dev)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_unfused = eval_race.evaluate(policy, "level1", 128, device=dev,
                                   fused=False)
    t_unfused = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {"race_step_fused": race_step.race_step_fused.launches,
                "race_window": race_window.race_window.launches}
    race_step.race_step_fused_plain = orig_step_plain
    race_window.race_window_plain = orig_window_plain
    print(f"[5] evaluate(level1_robust, level1, 128 envs) through "
          f"race_step ({t_fused:.1f} s): {json.dumps(m_fused)}", flush=True)
    print(f"[5] evaluate(..., fused=False) through race_window + plain tail "
          f"({t_unfused:.1f} s): {json.dumps(m_unfused)}", flush=True)
    print(f"[5] launches in the main path: {launches}; plain versions "
          f"called: {calls}", flush=True)
    check(launches["race_step_fused"] == 825, "race_step launch count")
    check(launches["race_window"] == 825, "race_window launch count")
    check(calls == {"plain_step": 0, "plain_window": 0},
          "a plain version ran on the main path")
    for label, m in (("fused", m_fused), ("unfused", m_unfused)):
        check(m["mean_gates"] >= 1.0,
              f"{label}: mean_gates {m['mean_gates']} < 1.0")
        check(m["completion_rate"] >= 0.2,
              f"{label}: completion {m['completion_rate']} < 0.2")

    # ---- 6. times: fused step, getting_started 2-drone COMPETE ---------------
    env = eval_race.make_eval_env("getting_started", n_envs, dev, seed=7,
                                  n_drones=2)
    env.telemetry = False
    steps = 256
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
    t_plain = [run(race_step.race_step_fused_plain, steps)]
    t_kern = [run(race_step.race_step_fused, steps),
              run(race_step.race_step_fused, steps)]
    t_plain.append(run(race_step.race_step_fused_plain, steps))
    kern_rate = n_envs * steps / (sum(t_kern) / 2)
    plain_rate = n_envs * steps / (sum(t_plain) / 2)
    k4["loop_ms"] = sum(t_kern) / 2 / steps * 1e3
    k4["plain_ms"] = sum(t_plain) / 2 / steps * 1e3
    print(f"[6] step_fused, getting_started 2-drone COMPETE, {n_envs} envs, "
          f"{steps} steps (plain, kernel, kernel, plain): kernel "
          f"{kern_rate:.6g} env-steps/s ({k4['loop_ms']:.4g} ms/step), plain "
          f"{plain_rate:.6g} env-steps/s ({k4['plain_ms']:.4g} ms/step) "
          f"on {gpu}", flush=True)

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

    src = "gym_pybullet_adrp_tpu_torch/csrc/"
    kernels = [
        {"name": "race_window", "route": "cuda",
         "source": src + "race_window.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race.py:664",
         "launches": launches["race_window"]},
        {"name": "race_step_fused", "route": "cuda",
         "source": src + "race_step.cu",
         "replaces": "gym_pybullet_adrp_tpu/ops/pallas_race_step.py:897",
         "launches": launches["race_step_fused"]},
    ]
    for k in kernels:
        r = results[k["name"]]
        k.update(max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"])
    if out_dir:
        (out_dir / "chip_smoke_metrics.json").write_text(json.dumps({
            "device": gpu, "kernels": kernels,
            "eval_fused": m_fused, "eval_unfused": m_unfused,
            "env_steps_per_sec": {"kernel": kern_rate, "plain": plain_rate},
            "loop_ms": {"race_window": results["race_window"]["loop_ms"],
                        "race_step_fused": k4["loop_ms"]},
            "profile": prof, "scaling": scaling,
            "seconds": {"eval_fused": t_fused, "eval_unfused": t_unfused},
        }, indent=1))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device times of the race kernels K3, K4 and K5 at the race trainer's
and the evaluation's shapes on one card, for this checkout or others, in
turns.

  python3 -m gym_pybullet_adrp_tpu_torch.race_kernel_times [--tree DIR]...
      [--out FILE]

Each ``--tree`` (default: this checkout) runs in a process of its own, in
the order given, importing the ``gym_pybullet_adrp_tpu_torch`` package
found in DIR and building its kernels there, so a parent commit's package
unpacked by ``git archive`` can be held against this one on the same card
(list the trees as parent, change, change, parent). A tree written DIR@L
runs the window kernel K3 with L lanes per agent whatever the agent
count (a package that picks L with ``race_window.lane_count``). Each
process prints one JSON line: the card's name and power limit, the
ptxas report of the race window, step and rollout kernels (registers,
stack frame, spills), the step kernels' launch geometry at
getting_started 4096 x 2 COMPETE, and the device ms per launch (CUDA
events around launches queued behind a spin kernel, so the host's
enqueue is not timed) of
  K4 with the policy: getting_started 4096 envs x 1 drone, 64-64;
  K5 in policy mode: the same, K=16;
  K5 in action mode: getting_started 4096 x 1 and x 2 COMPETE, K=32;
  K4 without the policy: getting_started 4096 x 2 COMPETE and 4096 x 1,
    and the evaluation's shape, level1 128 x 1 with its disturbances;
  K3 at the --fast trainer's twogates 4096 x 1 agents, level1's 4096 x 2
    (its disturbances) and getting_started 65536 x 1, each with the
    window statics of random actions ("hold") and with the poly7 planner
    on every other agent ("planner"), with the host ms per call of its
    wrapper's enqueue beside (``host_ms``; the change's wrapper with its
    constants folded once, ``consts``, where it takes them) and the lane
    count picked per agent count (``k3_lanes``).
Needs a CUDA device and nvcc; imports no JAX.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

N_ENVS = 4096


RACE_KERNELS = ("race_step_kernel", "race_rollout_kernel",
                "race_window_kernel")


def ptxas_entries(report, kernels=RACE_KERNELS):
    """{instantiation: {registers, stack, spill_stores, spill_loads}} of the
    kernels named ``kernels`` (base names) in an ``nvcc -Xptxas -v``
    report; a template instantiation is named by its mangled template
    arguments, a bool as 0 or 1 (``race_step_kernel<1>`` with the policy,
    ``hover_rollout_kernel<1,0,4>``)."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        base = next((k for k in kernels if k in mangled), None)
        if base is None:
            continue
        args = re.findall(r"L[bi](\d+)E", mangled)
        name = f"{base}<{','.join(args)}>" if args else base
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        out[name] = {
            "registers": int(regs.group(1)) if regs else None,
            "stack": int(frame.group(1)) if frame else None,
            "spill_stores": int(frame.group(2)) if frame else None,
            "spill_loads": int(frame.group(3)) if frame else None,
        }
    return out


def device_host_ms(fn, n=20, sleep_cycles=20_000_000):
    """(device ms, host ms) per call of ``fn``: ``n`` calls queued behind
    a spin kernel, so that the events time the launches back to back and
    the host's clock times their enqueue alone; the spin is doubled until
    it outlasts the host's queueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
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
            return ev[1].elapsed_time(ev[2]) / n, host_ms / n
        sleep_cycles *= 2
    raise RuntimeError(f"the host queued {n} calls in {host_ms} ms, longer "
                       "than the spin")


def device_ms(fn, n=20, sleep_cycles=20_000_000):
    """Device time per call of ``fn`` (``device_host_ms``)."""
    return device_host_ms(fn, n, sleep_cycles)[0]


def policy_pack(env, hidden=(64, 64), seed=3):
    """The pack of a random ActorCritic (log_std -1)."""
    import torch
    from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
        pack_policy_params,
    )
    from gym_pybullet_adrp_tpu_torch.models.policy import ActorCritic

    net = ActorCritic(env.obs_size, 4, hidden,
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.log_std.fill_(-1.0)
    return pack_policy_params(net.to(env.device))


def k3_window(env, st, gen, planner):
    """The W block of random FULLSTATE actions and, with ``planner``, the
    poly7 planner on every other agent with random coefficients."""
    import torch

    dev = st.S.device
    a = torch.rand((env.n_envs, env.N, 4), generator=gen, device=dev) * 2 - 1
    W = env.build_W(st, env.action_rows(a)).clone()
    if planner:
        T = env.T
        W[16] = ((torch.arange(T * 128, device=dev).reshape(T, 128) % 2)
                 == 0).float()
        W[17] = st.S[53] * env.dt
        W[18] = 1.0 + torch.rand((T, 128), generator=gen, device=dev)
        W[20:52] = torch.randn((32, T, 128), generator=gen, device=dev) * 0.2
        W[20] += st.S[0]
        W[28] += st.S[1]
        W[36] += st.S[2]
    return W.contiguous()


def measure(lanes=None):
    """The JSON record of the package on ``sys.path`` (see the module
    docstring); ``lanes`` forces the window kernel's lane count."""
    import torch
    from gym_pybullet_adrp_tpu_torch import eval_race
    from gym_pybullet_adrp_tpu_torch.ops import (
        _build, race_rollout, race_step, race_window,
    )

    if not torch.cuda.is_available():
        raise SystemExit("race_kernel_times: no CUDA device")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(11)
    _build.library("race_step")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rec = {"card": card, "ptxas": ptxas_entries(_build.build_info["ptxas"]),
           "ms": {}}

    def env_of(nd):
        env = eval_race.make_eval_env("getting_started", N_ENVS, dev, seed=7,
                                      n_drones=nd)
        return env, env.reset()

    env, st = env_of(1)
    pack = policy_pack(env)
    obs = env.initial_obs_rows(st)
    d = env.step_draws()
    actn = torch.randn((4, env.T, 128), generator=gen, device=dev)
    def kw_of(env):
        return dict(n_ticks=env.n_ticks, dt=env.dt, spec_tail=env.spec_tail,
                    telemetry=False)

    kw = kw_of(env)
    rec["ms"]["k4_policy"] = device_ms(lambda: race_step.race_step_fused(
        env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R, st.GG,
        st.OO, st.EP, d.RST, d.RSTG, d.RSTO, noise_rows=d.noise_rows,
        policy_pack=pack, obs_rows=obs, actn=actn, **kw))
    K = 16
    ds = env.stacked_draws(K)
    seq = torch.randn((K, 4, env.T, 128), generator=gen, device=dev)
    rec["ms"]["k5_policy_k16"] = device_ms(lambda: race_rollout.race_rollout(
        env.kf, env.km, env.arm, env.ground_z, st.S, None, st.R, st.GG,
        st.OO, st.EP, ds.RST, ds.RSTG, ds.RSTO, noise_rows_seq=ds.noise_rows,
        policy_pack=pack, obs_rows=obs, actn_seq=seq, **kw), n=5)
    K = 32
    for nd in (1, 2):
        env, st = env_of(nd)
        kw = kw_of(env)
        ds = env.stacked_draws(K)
        A = torch.rand((K, 4, env.T, 128), generator=gen, device=dev) * 2 - 1
        rec["ms"][f"k5_actions_k32_{nd}drone"] = device_ms(
            lambda: race_rollout.race_rollout(
                env.kf, env.km, env.arm, env.ground_z, st.S, A, st.R, st.GG,
                st.OO, st.EP, ds.RST, ds.RSTG, ds.RSTO, emit_obs=False, **kw),
            n=5)
        d = env.step_draws()
        rec["ms"][f"k4_{nd}drone"] = device_ms(
            lambda: race_step.race_step_fused(
                env.kf, env.km, env.arm, env.ground_z, st.S, A[0], st.R,
                st.GG, st.OO, st.EP, d.RST, d.RSTG, d.RSTO, noise_rows=None,
                **kw))
    rec["geometry"] = {
        f"{k}[{mode}]": race_step.launch_geometry(
            k, env.N, env.Tb,
            race_step.policy_layout(env.obs_size)[0] if mode == "policy"
            else None)
        for k in ("race_step", "race_rollout")
        for mode in ("policy", "actions")}

    # the evaluation's step: level1, 128 envs, 1 drone, disturbances
    env = eval_race.make_eval_env("level1", 128, dev, seed=7, n_drones=1)
    st = env.reset()
    d = env.step_draws()
    a = torch.rand((128, 4), generator=gen, device=dev) * 2 - 1
    A1 = env.action_rows(a)
    rec["ms"]["k4_level1_128"] = device_ms(lambda: race_step.race_step_fused(
        env.kf, env.km, env.arm, env.ground_z, st.S, A1, st.R, st.GG, st.OO,
        st.EP, d.RST, d.RSTG, d.RSTO, noise_rows=d.noise_rows, **kw_of(env)))

    # K3 at the --fast trainer's, level1's and a 65536-agent shape
    import inspect

    if lanes is not None and hasattr(race_window, "lane_count"):
        race_window.lane_count = lambda A, n_sm=132: int(lanes)
    fold = "consts" in inspect.signature(race_window.race_window).parameters
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rec["host_ms"], rec["k3_lanes"] = {}, {}
    for cfg, n_envs, nd in (("twogates", N_ENVS, 1), ("level1", N_ENVS, 2),
                            ("getting_started", 65536, 1)):
        env = eval_race.make_eval_env(cfg, n_envs, dev, seed=7, n_drones=nd)
        st = env.reset()
        A = n_envs * nd
        nz = env.step_draws().noise_rows
        kw = {}
        if fold:
            kw["consts"] = race_window.window_consts(
                env.kf, env.km, env.arm, env.ground_z, env.dt, env.n_ticks)
        if hasattr(race_window, "lane_count"):
            rec["k3_lanes"][A] = race_window.lane_count(A, n_sm)
        for label in ("hold", "planner"):
            W = k3_window(env, st, gen, label == "planner")
            key = f"k3_{A}_{label}"
            rec["ms"][key], rec["host_ms"][key] = device_host_ms(
                lambda: race_window.race_window(
                    env.kf, env.km, env.arm, env.ground_z, st.S, W,
                    env.n_ticks, env.dt, nz, **kw))
        del env, st, W
    return rec


def run_trees(script, trees, out, label):
    """Run ``script --worker [ARG]`` once per tree, in order, each in a
    process of its own with the tree's package first on its path; a tree
    is DIR or DIR@ARG. Prints and returns the JSON records (the tree
    added); writes them to ``out`` as well, if given."""
    script = Path(script).resolve()
    lines, failed = [], []
    for tree in trees:
        path, _, arg = tree.partition("@")
        root = Path(path).resolve()
        argv = [str(script), "--worker"] + ([arg] if arg else [])
        # the package of `root` comes first on the worker's path
        code = (f"import runpy, sys; sys.path.insert(0, {str(root)!r}); "
                f"sys.argv = {argv!r}; "
                f"runpy.run_path({str(script)!r}, run_name='__main__')")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr[-4000:])
            failed.append(tree)
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = tree
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("\n".join(lines) + "\n")
    if failed:
        print(f"{label}: failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=None,
                    help="a directory holding gym_pybullet_adrp_tpu_torch/ "
                         "(repeatable; default: this checkout), or DIR@L "
                         "to force L lanes per agent in the window kernel")
    ap.add_argument("--out", default=None, help="also write the records "
                    "here, one JSON line per tree")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("lanes", nargs="?", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(measure(args.lanes)), flush=True)
        return 0
    here = Path(__file__).resolve()
    return run_trees(here, args.tree or [str(here.parent.parent)], args.out,
                     "race_kernel_times")


if __name__ == "__main__":
    sys.exit(main())

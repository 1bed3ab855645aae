"""One run of one cell: set-up, warm-up, the measured window, the traced
segment, the check against the reference, and the metrics.

Everything that belongs to one configuration, traffic mix, entry kind or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json`` (the cell's ``config``, through ``configs``'
  ``file``) and ``counts/<config>.json``;
* ``traffic/<traffic>.json``, whose ``kind`` names
  ``kinds/<kind>.py``: the program's entry (``Program``), the control
  (``Control``) and the reference check (``check``);
* ``metrics/<metric>.py``, a ``read(ctx)`` that returns the metric's
  value or None when it finds nothing to read.

The window calls the entry back to back, each call followed by
``torch.cuda.synchronize()``, until ``seconds`` have passed; one call of
the window, drawn from the seed by reservoir sampling, is kept with its
inputs and the generators' states for the check.
"""

import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import stats

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gym_pybullet_adrp_tpu")
WARMUP_CALLS = 2


class RunError(Exception):
    """A run that must end without a result."""


def load_benchmark():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_config(entry):
    """The configuration file of a ``configs`` entry of BENCHMARK.json."""
    return load_json(REPO / entry["file"])


def load_module(kind, name):
    """``<kind>/<name>.py`` under the benchmark, by path (a name may hold
    dots and dashes)."""
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise RunError(f"no {kind} file {path.relative_to(REPO)}")
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench, name, traffic=None):
    """(cell, config, traffic) of the workload ``name``; ``traffic``
    replaces the cell's traffic file (the CPU tests' small sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_config(configs[cell["config"]])
    if traffic is None:
        traffic = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench, cell, section):
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def derive_seeds(seed):
    """The run's seeds, all from ``--seed`` (any whole number >= 0)."""
    if seed < 0:
        raise RunError("--seed must be a whole number >= 0")
    ss = np.random.SeedSequence(int(seed)).generate_state(5)
    return dict(zip(("env", "policy", "weights", "sample", "actions"),
                    (int(s) for s in ss)))


def mismatches(got, want):
    """Elements of ``got`` that differ from ``want``, key by key (NaN
    equals NaN; a missing key or another shape counts every element)."""
    per_key = {}
    for k, w in want.items():
        g = got.get(k)
        if g is None or tuple(g.shape) != tuple(w.shape):
            per_key[k] = w.numel()
            continue
        g = g.to(w.device)
        diff = g != w
        if w.is_floating_point():
            diff &= ~(torch.isnan(g) & torch.isnan(w))
        n = int(diff.sum())
        if n:
            per_key[k] = n
    return sum(per_key.values()), per_key


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_run(config, traffic, seed, device):
    """The benchmark-made inputs of a run: seeds, generators, weights."""
    from .reference.plain_step import obs_channels
    from .reference.race_env import scenario_spec
    from .weights import make_weights

    seeds = derive_seeds(seed)
    sp = scenario_spec(config)
    C = obs_channels(sp["N"], sp["G"], sp["O"], sp["compete"])
    run = SimpleNamespace(config=config, traffic=traffic, seeds=seeds,
                          device=device)
    run.env_gen = torch.Generator(device=device)
    run.env_gen.manual_seed(seeds["env"])
    run.pol_gen = torch.Generator(device=device)
    run.pol_gen.manual_seed(seeds["policy"])
    run.weights = make_weights(C, config["policy"]["hidden"],
                               seeds["weights"], device)
    run.actions = None
    if "action_amplitude" in traffic:
        from .kinds.action_rollout import make_actions
        run.actions = make_actions(run)
    return run


def run_cell(name, seed, seconds, trace, *, device=None, traffic=None,
             control=None, hook=None, t_start=None, log=None):
    """Run the workload ``name`` once; returns the result dict (the
    result line's keys, ``checks`` last). ``device`` defaults to the card;
    ``control`` ("bfloat16") puts the reference in the program's place;
    ``hook(entry)`` may alter the program's entry (the tests' faults)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_benchmark()
    cell, config, traffic = find_cell(bench, name, traffic)
    device = torch.device(device or "cuda")
    kind = load_module("kinds", traffic["kind"])
    run = make_run(config, traffic, seed, device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- set-up and warm-up ---------------------------------------------------
    if control:
        entry = kind.Control(run, getattr(torch, control))
    else:
        entry = kind.Program(run)
    if hook is not None:
        hook(entry)
    start = _clone(entry.inputs())
    warm = None
    with torch.no_grad():
        for i in range(WARMUP_CALLS):
            out = entry.call()
            _sync(device)
            if i == 0:
                warm = _clone(entry.outputs(out))
            del out
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({WARMUP_CALLS} warm-up calls)")

    # ---- the measured window ----------------------------------------------------
    pick = random.Random(run.seeds["sample"])
    lat, host = [], []
    sample = None
    with torch.no_grad():
        t0 = time.perf_counter()
        while True:
            keep = pick.random() * (len(lat) + 1) < 1.0
            if keep:
                snap = {"inputs": _clone(entry.inputs()),
                        "env_gen": run.env_gen.get_state(),
                        "pol_gen": run.pol_gen.get_state()}
            a = time.perf_counter()
            out = entry.call()
            b = time.perf_counter()
            _sync(device)
            c = time.perf_counter()
            lat.append(c - a)
            host.append(b - a)
            if keep:
                sample = (snap, _clone(entry.outputs(out)))
            del out
            if c - t0 >= seconds:
                break
        window_s = c - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    calls = len(lat)
    units = traffic["n_envs"] * traffic["n_steps"]
    log(f"window {window_s:.3f} s, {calls} calls of {units} env-steps")
    log_latencies(lat, log)

    # ---- the traced segment -------------------------------------------------------
    tsum = None
    if trace and device.type != "cuda":
        log("traced segment: the profiler traces a card, and this run has "
            "none")
    elif trace:
        from . import trace as trace_mod

        def one():
            with torch.no_grad():
                entry.call()

        events, seg_s = trace_mod.profile_calls(
            one, traffic["trace_calls"], lambda: _sync(device))
        tsum = trace_mod.summarize(events, kind.KERNEL)
        del events
        if tsum is not None:
            tsum["calls"] = traffic["trace_calls"]
            tsum["launches_made"] = (traffic["trace_calls"]
                                     * kind.launches_per_call(traffic))
            log(f"traced {tsum['calls']} calls in {seg_s:.3f} s: "
                f"{tsum['kernel_launches']} of {tsum['launches_made']} "
                f"{kind.KERNEL} launches recorded")
        else:
            log("traced segment: no device time in the trace")

    found = forbidden_modules()
    if found:
        raise RunError("the run loaded " + ", ".join(found))

    # ---- the check, after the program's state is freed --------------------------
    del entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = []
    failed = 0
    for cname, (n, per_key) in kind.check(run, start, warm, sample,
                                          mismatches):
        checks.append((cname, n, 0))
        failed += cname == "window_mismatch" and n > 0
        if per_key:
            log(f"{cname}: " + ", ".join(f"{k} {v}"
                                         for k, v in sorted(per_key.items())))
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(n <= limit for _, n, limit in checks)

    # ---- metrics ------------------------------------------------------------------
    from .counts import load as load_counts

    ctx = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, setup_s=setup_s,
        window_s=window_s, latencies_s=lat, host_s=host, calls=calls,
        units_per_call=units, trace=tsum,
        counts=load_counts(cell["config"]).get(traffic["kind"]),
        peaks=peaks_of(device), dims=dims_of(config, traffic), log=log)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, section):
        v = load_module("metrics", m["name"]).read(ctx)
        if v is None:
            log(f"{m['name']}: nothing to read")
            continue
        if not math.isfinite(v):
            raise RunError(f"{m['name']} reads {v}")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": calls, "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    if tsum is not None:
        dev_info["busy_s"] = tsum["busy_s"]
        dev_info["window_s"] = tsum["window_s"]
        result["breakdown"] = {"device_ops": tsum["device_ops"],
                               "idle_gaps": tsum["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result


def log_latencies(lat, log):
    """The latency distribution and its drift over the window, for the
    reader of a run's log."""
    ms = [1e3 * x for x in lat]
    qs = " ".join(f"p{q} {stats.percentile(ms, q):.3f}"
                  for q in (50, 90, 95, 99, 100))
    k = max(1, len(ms) // 10)
    tenths = [sum(ms[i:i + k]) / len(ms[i:i + k])
              for i in range(0, len(ms), k)]
    log(f"latency ms: {qs}; mean by tenth of the window: "
        + " ".join(f"{x:.3f}" for x in tenths))


def peaks_of(device):
    """The peak rates of the run's card from ``peaks.json``, or None."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for entry in load_json(ROOT / "peaks.json")["cards"]:
        if entry["match"] in name:
            return entry
    return None


def dims_of(config, traffic):
    """The shapes one K5 launch works on, for the byte count."""
    from .reference.plain_step import obs_channels
    from .reference.race_env import scenario_spec

    sp = scenario_spec(config)
    N, B = sp["N"], traffic["n_envs"]
    return dict(N=N, Tb=B // 128, G=sp["G"], O=sp["O"],
                C=obs_channels(N, sp["G"], sp["O"], sp["compete"]),
                n_ticks=sp["n_ticks"], noise=sp["disturbances"],
                static=not (sp["random_drone_state"]
                            or sp["random_gates_obstacles"]
                            or sp["random_drone_inertia"]
                            or sp["disturbances"]),
                K=traffic["kernel_chunk"],
                hidden=tuple(config["policy"]["hidden"]))

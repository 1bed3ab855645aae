"""CPU tests of the benchmark's harness: its arithmetic, the discovery of
its data files, the shape of BENCHMARK.json, the refusal to
run without a card, the imports, and whole runs at a small size whose
check passes for the program and fails for the control and for planted
faults. The card-only test carries the ``cuda`` marker."""

import ast
import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import harness, run, stats, trace

BENCH = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = dict(n_envs=128, n_steps=8, kernel_chunk=4, trace_calls=2)
CELLS = ("gs-1d.rollout.16k", "level3-2d.rollout.32k")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- arithmetic ---------------------------------------------------------------


def test_rate_and_percentile():
    assert stats.rate(640, 2.0) == 320.0
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs[::-1], 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                             15, 16, 17, 18, 19, 100], 95) == 19
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_gaps_idle():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert stats.merge(iv) == [(0.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union_length(iv) == 7.0
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.clip(iv, 0.5, 10.0) == [(0.5, 2.0), (1.0, 3.0), (5.0, 6.0),
                                         (5.5, 5.7), (9.0, 10.0)]
    # the device's idle share of [0, 10]: 1 - 5 / 10
    assert 1 - stats.union_length(stats.clip(iv, 0.0, 10.0)) / 10 == 0.5


def test_quartile_spread():
    xs = [100.0, 101.0, 99.0, 100.5, 99.5, 100.0]
    q = stats.quartile_spread(xs)
    import statistics
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert q == pytest.approx((q3 - q1) / statistics.median(xs))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary():
    """The window is the span of the CUDA API calls; the busy time is the
    union of the device intervals inside it; each gap is labelled by the
    API call the host was in, or as the host's own time."""
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 100.0, 5.0),
        _ev("kernel", "void race_rollout_kernel<true>(x)", 104.0, 30.0),
        _ev("kernel", "race_rollout_kernel<true>", 124.0, 20.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 150.0, 10.0),
        _ev("gpu_memcpy", "Memcpy DtoD", 170.0, 5.0),
        _ev("kernel", "before the window", 20.0, 50.0),
        _ev("kernel", "elementwise", 190.0, 20.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 186.0, 2.0),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 195.0, 5.0),
    ]
    t = trace.summarize(events, "race_rollout_kernel")
    us = 1e-6
    assert t["window_s"] == pytest.approx(100 * us)
    # device 104-144, 170-175, 190-200 (clipped): 55 us busy
    assert t["busy_s"] == pytest.approx(55 * us)
    assert t["kernel_launches"] == 2
    assert t["kernel_s"] == pytest.approx(50 * us)
    assert t["device_s"] == pytest.approx(65 * us)
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(4 * us)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(26 * us)
    assert gaps["host, between CUDA calls"] == pytest.approx(15 * us)
    assert sum(gaps.values()) == pytest.approx(45 * us)
    assert t["device_ops"][0][1] == pytest.approx(30 * us)
    assert trace.summarize([e for e in events if e["cat"] == "kernel"],
                           "race_rollout_kernel") is None
    assert trace.summarize([e for e in events if e["cat"] == "cuda_runtime"],
                           "race_rollout_kernel") is None


# ---- the shape of BENCHMARK.json and the discovery of files ------------------------------


def _bench():
    return harness.load_benchmark()


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][-1] == "benchmark.run"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(b)) < 64 * 1024


def test_discovery():
    """Every name BENCHMARK.json gives has its file, and each loads."""
    b = _bench()
    for w in b["workloads"]:
        cell, config, traffic = harness.find_cell(b, w["name"])
        assert config["name"] == w["config"]
        assert config["reduced"] == []
        kind = harness.load_module("kinds", traffic["kind"])
        for attr in ("Program", "Control", "check", "KERNEL",
                     "launches_per_call"):
            assert hasattr(kind, attr)
        counts = json.loads((BENCH / "counts" /
                             f"{w['config']}.json").read_text())
        assert traffic["kind"] in counts
        for sec in ("end_to_end", "per_layer"):
            for m in harness.cell_metrics(b, cell, sec):
                assert callable(harness.load_module("metrics",
                                                    m["name"]).read)
    for f in (BENCH / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        assert (BENCH / "kinds" / f"{t['kind']}.py").exists()
    with pytest.raises(harness.RunError):
        harness.find_cell(b, "no-such-cell")
    with pytest.raises(harness.RunError):
        harness.load_module("metrics", "no_such_metric")


def test_seeds_large_and_steady():
    a = harness.derive_seeds(2 ** 40 + 7)
    assert a == harness.derive_seeds(2 ** 40 + 7)
    assert a != harness.derive_seeds(2 ** 40 + 8)
    assert all(0 <= v < 2 ** 32 for v in a.values())


def test_run_fails_without_card(monkeypatch, capsys):
    monkeypatch.setattr(run, "fix_cache_dirs", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_unknown_workload_fails(monkeypatch, capsys):
    monkeypatch.setattr(run, "fix_cache_dirs", lambda: None)
    rc = run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


# ---- imports ------------------------------------------------------------------------


def _top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax():
    """Whole top-level names: the port's name begins with the JAX
    package's, so a prefix test would be wrong both ways."""
    bad = {"jax", "jaxlib", "flax", "optax", "gym_pybullet_adrp_tpu"}
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (_top_imports(f) & bad), f
    assert "gym_pybullet_adrp_tpu_torch" not in bad


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")) + [
            BENCH / "counts.py", BENCH / "weights.py", BENCH / "stats.py"]:
        assert not (_top_imports(f) & {"gym_pybullet_adrp_tpu_torch",
                                       "gym_pybullet_adrp_tpu"}), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "gym_pybullet_adrp_tpu_torch_x",
                        types.ModuleType("x"))
    assert "gym_pybullet_adrp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert "jax" in harness.forbidden_modules()


# ---- whole runs at a small size on the CPU -----------------------------------------------


def _small(cell, kind=None):
    b = _bench()
    _, _, tr = harness.find_cell(b, cell)
    if kind == "action_rollout":
        tr = json.loads((BENCH / "traffic" / "actions.16k.json").read_text())
    return dict(tr, **SMALL)


def _run(cell, traffic, **kw):
    return harness.run_cell(cell, 2 ** 33 + 17, 0.05, 0, device="cpu",
                            traffic=traffic, log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_correct(cell):
    res = _run(cell, _small(cell))
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"reset_mismatch", "warmup_mismatch",
                                  "window_mismatch"}
    assert set(res["metrics"]) == {"env_steps_per_s", "rollout_p95_ms",
                                   "setup_s"}
    assert res["device"]["platform"] == "cpu"


def test_small_traced_run():
    """The traced segment runs; without a card's trace the device
    metrics find nothing to read and are left out."""
    tr = _small(CELLS[0])
    res = harness.run_cell(CELLS[0], 5, 0.05, 1, device="cpu", traffic=tr,
                           log=lambda m: None)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"rollout_host_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference with the policy's towers in bfloat16 in the
    program's place reads not correct."""
    res = _run(cell, _small(cell), control="bfloat16")
    assert res["correct"] is False
    assert res["checks"]["warmup_mismatch"]["value"] > 0
    assert res["checks"]["window_mismatch"]["value"] > 0


def _state_unchanged(entry):
    orig = entry.override

    def broken(ts):
        _, traj, metrics = orig(ts)
        return ts, traj, metrics
    entry.override = broken


def _half_batch(entry):
    orig = entry.override

    def broken(ts):
        ts2, traj, metrics = orig(ts)
        fields = []
        for x in traj:
            x = x.clone()
            x[:, x.shape[1] // 2:] = 0
            fields.append(x)
        return ts2, type(traj)(*fields), metrics
    entry.override = broken


def _altered_reward(entry):
    orig = entry.override

    def broken(ts):
        ts2, traj, metrics = orig(ts)
        reward = traj.reward.clone()
        reward[-1, 3] += 1e-3
        return ts2, traj._replace(reward=reward), metrics
    entry.override = broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _altered_reward],
                         ids=["state_unchanged", "half_batch",
                              "altered_reward"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_fail(cell, fault):
    """The program's timed entry broken underneath: the run reads not
    correct (one chip: there is no exchange between chips to leave
    out)."""
    res = _run(cell, _small(cell), hook=fault)
    assert res["correct"] is False
    assert res["checks"]["warmup_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_action_kind(cell):
    tr = _small(cell, "action_rollout")
    assert _run(cell, tr)["correct"] is True
    assert _run(cell, tr, control="bfloat16")["correct"] is False


# ---- on the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["policy_rollout", "action_rollout"])
def test_card_run(card, kind):
    """Both entry kinds on the card at the traffic's own 16384 envs, two
    seconds, traced: correct, and the trace reads K5's launches."""
    tr = _small(CELLS[0], kind)
    tr.update(n_envs=16384, n_steps=64, kernel_chunk=16, trace_calls=4)
    res = harness.run_cell(CELLS[0], 2 ** 35 + 3, 2.0, 1, device=card,
                           traffic=tr, log=print)
    print(json.dumps(res))
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert "race_rollout_roofline" in res["metrics"]

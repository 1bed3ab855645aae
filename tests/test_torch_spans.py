"""Port: the span and counter recorder of utils/profiling.py and the spans
of the race trainer's policy rollout.

  The recorder: off, a span stores nothing; it records under a
    ``torch.profiler`` capture and inside ``recording()``; nesting gives
    each span its parent and root, counts go to the innermost span, the
    bounded buffer counts what it drops.
  The clock: a span exported into ``profiling.trace()``'s Chrome trace
    holds a ``record_function`` event opened inside it, within 1 ms;
    ``idle_by_span`` puts planted idle gaps down to the innermost span,
    and ``device_totals`` sums the planted device events by name.
  The rollout at 128 envs, 8 steps (getting_started 1 drone and level3 2
    drones COMPETE, 4 steps a K5 call and 1 a step): one root a call, the
    draws' host copies (none and 9 a step), every child inside its root,
    and the trajectory and state equal bit for bit with recording on and
    off.

The benchmark's readers of these spans: tests/test_torch_span_metrics.py.
No JAX here; one torch thread.
"""

import json
import time

import pytest
import torch

from gym_pybullet_adrp_tpu_torch.envs import race as race_mod
from gym_pybullet_adrp_tpu_torch.envs.race_rl_rowfast import (
    make_policy_rollout, make_row_env,
)
from gym_pybullet_adrp_tpu_torch.rl.ppo import (
    EnvAdapter, PPOConfig, Transition, make_ppo_core,
)
from gym_pybullet_adrp_tpu_torch.utils import profiling
from gym_pybullet_adrp_tpu_torch.utils.config import load_config
from gym_pybullet_adrp_tpu_torch.utils.enums import Physics, RaceMode

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.take()
    yield
    profiling.take()


def _names(recs):
    return [r.name for r in recs]


def test_off_records_nothing_on_records():
    from torch.profiler import ProfilerActivity, profile

    with profiling.span("off") as sp:
        profiling.count("n")
    assert sp is None and profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("captured"):
            pass
    with profiling.recording():
        with profiling.span("forced"):
            pass
    with profiling.span("off again"):
        pass
    assert _names(profiling.records()) == ["captured", "forced"]
    assert _names(profiling.take()) == ["captured", "forced"]
    assert profiling.records() == []


def test_nesting_counts_and_dropped():
    with profiling.recording():
        with profiling.span("root"):
            profiling.count("a")
            with profiling.span("child"):
                profiling.count("a", 2)
                with profiling.span("grandchild"):
                    time.sleep(0.002)
            profiling.count("b", 5)
        with profiling.span("second root"):
            pass
    profiling.count("nobody")          # no span open: kept nowhere
    gc, child, root, root2 = profiling.take()
    assert _names([gc, child, root, root2]) == [
        "grandchild", "child", "root", "second root"]
    assert root.parent is None and root.root == root.id
    assert child.parent == root.id and gc.parent == child.id
    assert child.root == gc.root == root.id
    assert root2.parent is None and root2.root == root2.id != root.id
    assert root.start <= child.start <= gc.start <= gc.end <= child.end \
        <= root.end
    assert root.counts == {"a": 1, "b": 5} and child.counts == {"a": 2}
    assert gc.counts is None
    table = profiling.span_table([gc, child, root])
    own = (root.end - root.start - (child.end - child.start)) / 1e6
    assert table["root"]["self_ms"] == pytest.approx(own)
    assert table["child"]["self_ms"] < table["child"]["ms"]
    assert table["grandchild"]["ms"] >= 2.0
    assert table["root"]["counts"] == {"a": 1, "b": 5}

    rec = profiling.Recorder(capacity=3)
    with rec.recording():
        for i in range(5):
            with rec.span(f"s{i}"):
                pass
    assert _names(rec.records()) == ["s2", "s3", "s4"] and rec.dropped == 2


def test_span_on_the_trace_clock(tmp_path):
    """A span in the exported trace holds the record_function event
    opened inside it, within 1 ms at each end."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with torch.profiler.record_function("inner"):
                time.sleep(0.003)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (outer,) = [e for e in events if e.get("cat") == profiling.SPAN_CAT]
    (inner,) = [e for e in events if e.get("name") == "inner"
                and e.get("ph") == "X"]
    assert outer["name"] == "outer" and outer["dur"] >= 3000
    assert outer["ts"] - 1000 <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1000


def test_idle_by_span():
    """Device busy on [0, 10), [12, 20) and [15, 30) (the union), [40, 41)
    and [50, 51); idle on [10, 12) inside the child, [30, 40) inside the
    root only and [41, 50) outside every span."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("kernel", "k", 0, 10), ev("gpu_memcpy", "c", 12, 8),
              ev("kernel", "k", 15, 15), ev("gpu_memset", "m", 40, 1),
              ev("kernel", "k", 50, 1),
              ev("cuda_runtime", "cudaLaunchKernel", 20, 2),
              ev(profiling.SPAN_CAT, "root", 0, 40),
              ev(profiling.SPAN_CAT, "child", 5, 10)]
    assert profiling.idle_by_span(events) == {
        "root": 10.0, profiling.OUTSIDE: 9.0, "child": 2.0}
    assert profiling.union_us(profiling.device_intervals(events)) == 30.0
    assert sorted(profiling.device_totals(events)) == [
        ("c", 1, 8.0), ("k", 3, 26.0), ("m", 1, 1.0)]


def _rollout(config, n_drones, chunk, n_envs=128, n_steps=8):
    cfg = load_config(config)
    mode = RaceMode.COMPETE if n_drones > 1 else RaceMode.COMPARE
    spec = race_mod.RaceSpec.from_config(cfg, n_drones, mode, Physics.PYB)
    track = race_mod.track_from_config(cfg, n_drones)
    gen = torch.Generator().manual_seed(3)
    env = make_row_env(spec, track, n_envs, device="cpu", generator=gen,
                       end_after_gate=2, per_drone_reward=n_drones > 1)
    b_reset, override, step = make_policy_rollout(env, n_steps, chunk)
    adapter = EnvAdapter(batched_reset=b_reset, step=step,
                         obs_dim=env.obs_size, act_dim=4, generator=gen)
    ppo = PPOConfig(n_envs=n_envs * n_drones, n_steps=n_steps,
                    shuffle_block=64)
    init_fn, _, _ = make_ppo_core(ppo, adapter, rollout_override=override,
                                  device="cpu")
    return env, override, init_fn(0)


def _flat(out):
    ts, traj, metrics = out
    res = {f"traj.{f}": getattr(traj, f) for f in Transition._fields}
    res.update({f"metrics.{k}": v for k, v in metrics.items()})
    res.update({f"ts.{f}": getattr(ts, f)
                for f in ("last_obs", "ep_return", "ep_len")})
    res.update({f"state.{i}": x for i, x in enumerate(ts.env_state[0])})
    res["obs_rows"] = ts.env_state[1]
    return res


@pytest.mark.parametrize("config,n_drones,chunk,copies", [
    ("getting_started", 1, 4, 0), ("level3", 2, 4, 9), ("level3", 2, 0, 9)],
    ids=["gs-chunk4", "level3-chunk4", "level3-per-step"])
def test_policy_rollout_spans(config, n_drones, chunk, copies):
    n_steps = 8
    env, override, ts = _rollout(config, n_drones, chunk, n_steps=n_steps)
    states = (env.generator.get_state(), ts.rng.get_state())
    off = _flat(override(ts))
    assert profiling.records() == []
    env.generator.set_state(states[0])
    ts.rng.set_state(states[1])
    with profiling.recording():
        on = _flat(override(ts))
        override(ts)
    for k, v in off.items():
        assert torch.equal(v, on[k]) or (
            v.is_floating_point() and torch.equal(v.isnan(), on[k].isnan())
            and torch.equal(v.nan_to_num(), on[k].nan_to_num())), k

    recs = profiling.take()
    roots = [r for r in recs if r.parent is None]
    assert _names(roots) == ["rollout", "rollout"]
    for root in roots:
        under = [r for r in recs if r.root == root.id and r is not root]
        for r in under:
            assert root.start <= r.start <= r.end <= root.end, r
        names = _names(under)
        n_chunks = n_steps // chunk if chunk else n_steps
        assert names.count("rollout.account") == n_chunks
        assert names.count("rollout.flatten") == 1
        assert names.count("rollout.draws") == n_chunks
        # the CPU takes the kernels' plain versions: no launch span
        assert "race_rollout.launch" not in names
        assert sum((r.counts or {}).get("host_copies", 0)
                   for r in under) == copies * n_steps
        assert names.count("draws.host_copies") == copies * n_steps
        assert all(r.parent != root.id for r in under
                   if r.name == "draws.host_copies")

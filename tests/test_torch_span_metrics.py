"""benchmark/metrics' readers of the port's spans (benchmark/spans.py)
on planted span records: each reads its value, and None without a
trace, a root span or a recorder, or when reading the records fails
(a reader never raises). No JAX here.
"""

from types import SimpleNamespace

import pytest

from benchmark import harness
from gym_pybullet_adrp_tpu_torch.utils import profiling

READERS = ("draws_ms", "draws_blocked_ms", "host_copies_per_rollout",
           "account_ms", "flatten_ms", "race_rollout_enqueue_us",
           "rollout_other_ms")
MS = 1_000_000     # ns


def _planted():
    """Two traced rollouts after one from before the segment: root 10 ms
    with draws 4 ms (two copies of 1 ms inside, 9 host_copies), a launch
    of 200 us, accounting 2 ms, flattening 1 ms."""
    S = profiling.Record
    out, t = [], 0
    for r in range(3):
        rid = 100 * r
        out += [S("draws.host_copies", t + 1 * MS, t + 2 * MS, rid + 2,
                  rid + 1, rid, counts={"host_copies": 4}),
                S("draws.host_copies", t + 2 * MS, t + 3 * MS, rid + 3,
                  rid + 1, rid, counts={"host_copies": 5}),
                S("rollout.draws", t, t + 4 * MS, rid + 1, rid, rid),
                S("race_rollout.launch", t + 4 * MS, t + 4 * MS + 200_000,
                  rid + 4, rid, rid),
                S("rollout.account", t + 5 * MS, t + 7 * MS, rid + 5, rid,
                  rid),
                S("rollout.flatten", t + 8 * MS, t + 9 * MS, rid + 6, rid,
                  rid),
                S("rollout", t, t + 10 * MS, rid, None, rid)]
        t += 20 * MS
    # the first rollout ran before the segment: it doubles every span
    out[0] = out[0]._replace(end=out[0].end + 1 * MS)
    out[6] = out[6]._replace(end=out[6].end + 10 * MS)
    return out


WANT = {"draws_ms": 4.0, "draws_blocked_ms": 2.0,
        "host_copies_per_rollout": 9.0, "account_ms": 2.0,
        "flatten_ms": 1.0, "race_rollout_enqueue_us": 200.0,
        "rollout_other_ms": 10.0 - 4.0 - 0.2 - 2.0 - 1.0}


@pytest.mark.parametrize("name", READERS)
def test_span_metric_readers(name, monkeypatch):
    read = harness.load_module("metrics", name).read
    logs = []
    ctx = SimpleNamespace(trace={"calls": 2}, log=logs.append)
    monkeypatch.setattr(profiling, "records", _planted)
    assert read(ctx) == pytest.approx(WANT[name])
    assert read(SimpleNamespace(trace=None, log=logs.append)) is None
    monkeypatch.setattr(profiling, "records", lambda: [
        s for s in _planted() if s.name != "rollout"])
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "records")
    assert read(ctx) is None
    monkeypatch.setattr(profiling, "records", lambda: 1 / 0, raising=False)
    assert read(ctx) is None and "ZeroDivisionError" in logs[-1]

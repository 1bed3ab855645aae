"""The device trace of a run's traced segment: ``torch.profiler`` around a
fixed number of the entry's calls, read back from its Chrome trace.

``summarize`` turns the trace's events into what the per-layer readers
take: the traced window (from the first CUDA API call to the end of the
last synchronize), every device interval (kernels, copies, memsets), the
device time and recorded launches of each kernel name, the busy time (the
union of the device intervals), the longest idle gaps labelled by the
CUDA API call the host was in ("host, between CUDA calls" when in none:
Python and the framework's dispatch), and the device operations that took
most time.
"""

import bisect
import json
import os
import tempfile
import time

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def profile_calls(call, n_calls, device_sync):
    """Run ``call()`` ``n_calls`` times under ``torch.profiler``, each
    followed by ``device_sync()``. Only the card's activity and the CUDA
    API calls are traced: recording the host's aten ops too slows a
    rollout by half (gs-1d.rollout.16k on an H100 80GB HBM3: 29.1 against
    19.4 ms untraced; 20.3 ms this way). Returns (the trace's event list, the host seconds
    the segment took)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
            device_sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    return events, time.perf_counter() - t0


def _span(ev):
    return float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))


def _label(host, starts, t):
    """The innermost host event around time ``t`` (its name), or None."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(events, kernel):
    """The traced segment's numbers (seconds) from Chrome trace
    ``events``. ``kernel`` is the name (a substring) of the kernel whose
    launches are counted apart. Returns None when the trace holds no
    window or no device time."""
    win = [_span(e) for e in events if e.get("ph") == "X"
           and e.get("cat") in HOST_CATS]
    if not win:
        return None
    lo, hi = min(s for s, _ in win), max(t for _, t in win)
    dev = [(e, _span(e)) for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    dev = [(e, (s, t)) for e, (s, t) in dev if t > lo and s < hi]
    if not dev:
        return None
    by_name = {}
    for e, (s, t) in dev:
        c, d = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (c + 1, d + (min(t, hi) - max(s, lo)))
    k_count = sum(c for n, (c, _) in by_name.items() if kernel in n)
    k_time = sum(d for n, (_, d) in by_name.items() if kernel in n)
    total = sum(d for _, d in by_name.values())
    intervals = [iv for _, iv in dev]
    busy = stats.union_length(stats.clip(intervals, lo, hi))
    host = sorted((s, t, e["name"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in HOST_CATS
                  for s, t in [_span(e)] if t > lo and s < hi)
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in stats.gaps(intervals, lo, hi):
        name = (_label(host, starts, 0.5 * (g0 + g1))
                or "host, between CUDA calls")
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    us = 1e-6
    return {
        "window_s": (hi - lo) * us,
        "busy_s": busy * us,
        "device_s": total * us,
        "kernel_s": k_time * us,
        "kernel_launches": k_count,
        "device_ops": [[n[:120], d * us] for n, (_, d) in top_ops],
        "idle_gaps": [[n[:120], d * us] for n, d in top_idle],
    }

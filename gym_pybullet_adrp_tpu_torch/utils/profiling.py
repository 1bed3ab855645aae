"""Profiling and tracing utilities.

Counterpart of gym_pybullet_adrp_tpu/utils/profiling.py (``trace`` :18,
``measure_steps_per_sec`` :28, ``RealTimeFactor`` :60): a
``torch.profiler`` capture around any code, a steps/s harness, and the
reference's real-time factor. Beside them, the port's roofline tools,
which take the place of XLA's cost model: ``OpCount``/``census``
count the operations a plain PyTorch function performs, ``bound`` turns
bytes and operations into the least time the card could take, and
``traced``/``kernel_time`` read the card's device time per kernel from a
trace. utils/roofline.py turns counts per env-step into shares of the
card's peaks.

Spans and counters: ``span(name)`` marks a stretch of the host's work
and ``count(name, n)`` adds to the innermost open span's counts. They
record only while a ``torch.profiler`` capture runs or inside
``recording()``; otherwise a span costs one check of those flags and
stores nothing. Records stay in a bounded buffer (``records()`` reads
it, ``take()`` empties it), timed by ``time.perf_counter_ns`` and put
on the Chrome trace's clock by ``chrome_events``, so a trace shows each
span above the CUDA calls it made; ``idle_by_span`` puts the card's idle
gaps down to the innermost span the host was in.

The currency of the operation bound is the FP32 issue. The port's
kernels are built with ``-fmad=false``: no multiply and add is fused,
so each pointwise operation ``OpCount`` counts is (at least) one FP32
instruction, and the ceiling is the card's issue rate, 132 SMs x 128
FP32 lanes x 1.98 GHz = 3.345e13 a second, not the data sheet's 67
TFLOP/s, which counts a fused multiply-add as two. Matrix products are
the exception: their 2 m n k flops run as fused multiply-adds in a
library or a tile loop, so they count as flops / 2 issues.
"""

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB HBM3 (700 W): HBM3's rate (data sheet); the
# FP32 issue rate, 132 SMs x 128 FP32 lanes x 1.98 GHz boost (the
# Hopper whitepaper's SM and lane counts); and the data sheet's FP32
# rate, which counts a fused multiply-add as 2 flops (matrix products)
PEAK_BYTES = 3.35e12
PEAK_FP32_OPS = 132 * 128 * 1.98e9
PEAK_FMA_FLOPS = 2 * PEAK_FP32_OPS


# ---------------------------------------------------------------------------
# spans and counters


SPAN_CAT = "adrp_span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside the program"


class Record(NamedTuple):
    """A closed span: ``start``/``end`` in ``time.perf_counter_ns``,
    ``parent`` the id of the innermost span open when it began (None for
    a root), ``root`` the id of its root, ``tid`` its host thread's native
    id, ``counts`` what ``count`` added while it was the innermost open
    span (None when nothing was)."""

    name: str
    start: int
    end: int
    id: int
    parent: Optional[int]
    root: int
    tid: int = 0
    counts: Optional[dict] = None


class _Span:
    """An open span; closing it stores its record as a plain tuple (which
    the garbage collector stops tracking) in the recorder's buffer."""

    __slots__ = ("rec", "name", "start", "id", "parent", "root", "tid",
                 "counts")

    def __init__(self, rec, name):
        self.rec, self.name, self.counts = rec, name, None

    def __enter__(self):
        rec = self.rec
        self.id = i = rec._next_id
        rec._next_id = i + 1
        stack = rec._stack
        if stack:
            top = stack[-1]
            self.parent, self.root, self.tid = top.id, top.root, top.tid
        else:
            rec._anchor = (time.time_ns(), time.perf_counter_ns())
            self.parent, self.root = None, i
            self.tid = threading.get_native_id()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec._stack.pop()
        buf = rec._buf
        if len(buf) == buf.maxlen:
            rec.dropped += 1
        buf.append((self.name, self.start, end, self.id, self.parent,
                    self.root, self.tid, self.counts and tuple(
                        self.counts.items())))
        return False


class _Off:
    """The span of a recorder that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """Spans and counters of the host's work, kept in memory.

    Recording is on while a ``torch.profiler`` capture runs (the flag
    ``torch.autograd.profiler._is_profiler_enabled``, which a capture
    sets whatever its activities) or inside ``recording()``. Each root
    span, as it opens, takes an anchor pair ``(time.time_ns(),
    time.perf_counter_ns())`` that ties the spans' clock to the Unix
    epoch, the clock of the profiler's Chrome trace: spans are converted
    with the latest anchor, which drifts from an older one by the clocks'
    slew (parts per million). Spans nest by the order they open on one
    host thread. The buffer keeps the last ``capacity`` records;
    ``dropped`` counts those it let go."""

    def __init__(self, capacity=1 << 16):
        self._buf = collections.deque(maxlen=capacity)
        self._stack = []
        self._next_id = 0
        self._forced = 0
        self._anchor = None      # (Unix ns, perf_counter ns)
        self.dropped = 0

    def span(self, name):
        """``with recorder.span(name):`` records the block as a span."""
        if self._forced or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name)
        return _OFF

    def count(self, name, n=1):
        """Add ``n`` to ``name`` in the innermost open span's counts (no
        span open: nothing is kept)."""
        if self._stack:
            sp = self._stack[-1]
            if sp.counts is None:
                sp.counts = {}
            sp.counts[name] = sp.counts.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block, whether or not a capture runs."""
        self._forced += 1
        try:
            yield self
        finally:
            self._forced -= 1

    def records(self):
        """The closed spans as ``Record``s, oldest first, without
        clearing them."""
        return [Record(*r[:7], r[7] and dict(r[7])) for r in self._buf]

    def take(self):
        """The closed spans as ``Record``s, oldest first; the buffer is
        emptied."""
        out = self.records()
        self._buf.clear()
        return out

    def chrome_events(self, base_ns, spans):
        """``spans`` (``Record``s) as Chrome trace ``"X"`` events on a
        trace's clock: ``ts`` and ``dur`` in us from ``base_ns`` (the
        trace's ``baseTimeNanoseconds``, Unix-epoch ns; 0 where a trace
        writes absolute times)."""
        pid = os.getpid()
        out = []
        for sp in spans:
            unix_ns = self._anchor[0] + (sp.start - self._anchor[1])
            args = {"id": sp.id, "parent": sp.parent, "root": sp.root}
            if sp.counts:
                args.update(sp.counts)
            out.append({"ph": "X", "cat": SPAN_CAT, "name": sp.name,
                        "pid": pid, "tid": sp.tid,
                        "ts": (unix_ns - base_ns) / 1e3,
                        "dur": (sp.end - sp.start) / 1e3, "args": args})
        return out


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
recording = RECORDER.recording
records = RECORDER.records
take = RECORDER.take
chrome_events = RECORDER.chrome_events


def span_table(spans):
    """Per span name: ``n`` spans, their host ``ms``, ``self_ms`` (less
    their direct children's time) and summed ``counts``; oldest name
    first."""
    child_ns = {}
    for sp in spans:
        if sp.parent is not None:
            child_ns[sp.parent] = child_ns.get(sp.parent, 0) + (
                sp.end - sp.start)
    table = {}
    for sp in sorted(spans, key=lambda s: s.start):
        row = table.setdefault(sp.name, {"n": 0, "ms": 0.0, "self_ms": 0.0,
                                         "counts": {}})
        dur = sp.end - sp.start
        row["n"] += 1
        row["ms"] += dur / 1e6
        row["self_ms"] += (dur - child_ns.get(sp.id, 0)) / 1e6
        for k, v in (sp.counts or {}).items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return table


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_us(intervals):
    """The time ``intervals`` cover, overlaps counted once."""
    return sum(e - s for s, e in _merge(intervals))


def device_intervals(events):
    """``(start, end)`` (us) of every kernel, copy and memset among Chrome
    trace ``events``."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS]


def idle_by_span(events):
    """The card's idle time (us) by the innermost span that holds each
    idle gap's midpoint, ``OUTSIDE`` for a gap in none. ``events`` is a
    Chrome trace's event list: its device intervals give the busy time
    (their union), its span events (``chrome_events``) the spans. The
    gaps are taken from the first to the last device interval or span."""
    sp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
          for e in events if e.get("cat") == SPAN_CAT]
    busy = _merge(device_intervals(events))
    ends = [t for s, e in busy for t in (s, e)] + [
        t for s, e, _ in sp for t in (s, e)]
    if not ends:
        return {}
    lo, hi = min(ends), max(ends)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = min(((e - s, name) for s, e, name in sp if s <= mid <= e),
                    default=(None, OUTSIDE))[1]
        idle[inner] = idle.get(inner, 0.0) + (g1 - g0)
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def _chrome_trace(prof):
    """The profiler's Chrome trace as a dict."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _since(t0):
    return [sp for sp in records() if sp.start >= t0]


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a ``torch.profiler`` trace of the host and, where CUDA is
    present, the card; yields the profiler (``key_averages()`` reads it)
    and writes ``log_dir/trace.json`` (Chrome trace format) on exit, with
    the spans recorded during the capture (category ``adrp_span``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter_ns()
    with profile(activities=acts) as prof:
        yield prof
    doc = _chrome_trace(prof)
    doc["traceEvents"] += chrome_events(
        int(doc.get("baseTimeNanoseconds", 0)), _since(t0))
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "trace.json", "w") as f:
        json.dump(doc, f)


def _block(out):
    """Wait for ``out``'s device work (the JAX ``block_until_ready``)."""
    tensors = [out] if isinstance(out, torch.Tensor) else (
        [x for x in out if isinstance(x, torch.Tensor)]
        if isinstance(out, (tuple, list)) else [])
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_steps_per_sec(fn, *args, n_warmup: int = 1, n_repeats: int = 3,
                          steps_per_call: int = 1, pipelined: bool = True,
                          batch: int = 8):
    """Throughput of a callable. Returns (steps/s, seconds-per-call).

    ``n_repeats`` is the number of independent timing rounds (best
    taken), in both modes. ``pipelined=True``: each round queues
    ``batch`` calls back to back and waits once, so the host's launch
    cost overlaps the device's work (sustained throughput);
    ``pipelined=False`` waits after every call (end-to-end latency;
    ``batch`` is ignored)."""
    for _ in range(n_warmup):
        _block(fn(*args))
    best = float("inf")
    if pipelined:
        batch = max(batch, 2)
        for _ in range(n_repeats):
            t0 = time.perf_counter()
            outs = [fn(*args) for _ in range(batch)]
            for o in outs:
                _block(o)
            best = min(best, (time.perf_counter() - t0) / batch)
    else:
        for _ in range(n_repeats):
            t0 = time.perf_counter()
            _block(fn(*args))
            best = min(best, time.perf_counter() - t0)
    return steps_per_call / best, best


class RealTimeFactor:
    """Wall-clock vs sim-time ratio (reference render():408-410)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()

    def factor(self, sim_time_sec: float) -> float:
        wall = max(time.time() - self.start, 1e-9)
        return sim_time_sec / wall


# ---------------------------------------------------------------------------
# operation counts and bounds


class OpCount(TorchDispatchMode):
    """Counts the operations a plain version performs: ``ops``, one per
    output element of every elementwise aten op (tagged pointwise) and
    one per input element of a reduction; with ``matmul``, ``flops``, 2 m
    n k per matrix product. ``by_op`` splits both by aten op name.
    ``bytes`` adds up each op's tensor inputs and outputs: the traffic of
    running the ops one by one."""

    REDUCTIONS = ("aten.amin", "aten.amax", "aten.sum", "aten.mean")
    MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")

    def __init__(self, matmul=False):
        super().__init__()
        self.ops = 0
        self.flops = 0
        self.bytes = 0
        self.by_op = {}
        self.matmul = matmul

    def _add(self, name, n, attr):
        setattr(self, attr, getattr(self, attr) + n)
        self.by_op[name] = self.by_op.get(name, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        name = str(func)
        if torch.Tag.pointwise in func.tags:
            self._add(name, sum(o.numel() for o in outs
                                if isinstance(o, torch.Tensor)), "ops")
        elif name.startswith(self.REDUCTIONS):
            self._add(name, args[0].numel(), "ops")
        elif self.matmul and name.startswith(self.MATMULS):
            a = args[1] if name.startswith(("aten.addmm", "aten.baddbmm")) \
                else args[0]
            self._add(name, 2 * outs[0].numel() * a.shape[-1], "flops")
        self.bytes += nbytes(*outs, *[a for a in args
                                      if isinstance(a, torch.Tensor)])
        return out


def census(fn, matmul=True):
    """The ``OpCount`` of ``fn()``: ``ops``, ``flops``, ``by_op``; pass
    its ``ops`` and ``flops`` to ``bound``, which weighs them apart."""
    with OpCount(matmul) as c:
        fn()
    return c


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def ops_ms(ops, flops=0):
    """The least time of ``ops`` pointwise operations and ``flops``
    matrix-product flops at the FP32 issue rate (ms)."""
    return (ops + flops / 2) / PEAK_FP32_OPS * 1e3


def bound(inputs, outputs, ops, flops=0):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM's rate and
    ``ops`` pointwise operations plus ``flops`` / 2 (matrix products'
    fused multiply-adds) over the FP32 issue rate."""
    b = nbytes(*inputs) + nbytes(*outputs)
    t_b, t_o = b / PEAK_BYTES * 1e3, ops_ms(ops, flops)
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": b, "ops": ops, "flops": flops}


# ---------------------------------------------------------------------------
# device time from a trace


class Traced(NamedTuple):
    """What ``traced`` read: the host's ``wall_ms``; ``events``, (name,
    launches, device us) of each kernel, copy and memset name in the
    trace; ``spans``, the records made during the call; ``trace``, the
    Chrome trace's events with those spans among them."""

    wall_ms: float
    events: list
    spans: list
    trace: list

    def busy_ms(self):
        """The device's busy time: the union of its intervals."""
        return union_us(device_intervals(self.trace)) / 1e3


def device_totals(events):
    """(name, count, device us) of each kernel, copy and memset name among
    Chrome trace ``events``."""
    tot = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            n, us = tot.get(e["name"], (0, 0.0))
            tot[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    return [(k, n, us) for k, (n, us) in tot.items()]


def traced(fn):
    """Run ``fn`` under torch.profiler (host and card); returns a
    ``Traced``, read from the profiler's Chrome trace alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    doc = _chrome_trace(prof)
    spans = _since(t0)
    events = doc["traceEvents"] + chrome_events(
        int(doc.get("baseTimeNanoseconds", 0)), spans)
    return Traced(wall, device_totals(events), spans, events)


def kernel_time(events, kernel):
    """(launches, device ms) of ``kernel`` in ``traced``'s events."""
    hits = [(c, us) for k, c, us in events if kernel in k]
    return sum(c for c, _ in hits), sum(us for _, us in hits) / 1e3

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

The currency of the operation bound is the FP32 issue. The port's
kernels are built with ``-fmad=false``: no multiply and add is fused,
so each pointwise operation ``OpCount`` counts is (at least) one FP32
instruction, and the ceiling is the card's issue rate, 132 SMs x 128
FP32 lanes x 1.98 GHz = 3.345e13 a second, not the data sheet's 67
TFLOP/s, which counts a fused multiply-add as two. Matrix products are
the exception: their 2 m n k flops run as fused multiply-adds in a
library or a tile loop, so they count as flops / 2 issues.
"""

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB HBM3 (700 W): HBM3's rate (data sheet); the
# FP32 issue rate, 132 SMs x 128 FP32 lanes x 1.98 GHz boost (the
# Hopper whitepaper's SM and lane counts); and the data sheet's FP32
# rate, which counts a fused multiply-add as 2 flops (matrix products)
PEAK_BYTES = 3.35e12
PEAK_FP32_OPS = 132 * 128 * 1.98e9
PEAK_FMA_FLOPS = 2 * PEAK_FP32_OPS


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a ``torch.profiler`` trace of the host and, where CUDA is
    present, the card; yields the profiler (``key_averages()`` reads it)
    and writes ``log_dir/trace.json`` (Chrome trace format) on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


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

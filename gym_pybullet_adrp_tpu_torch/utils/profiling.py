"""Profiling and tracing utilities.

Counterpart of gym_pybullet_adrp_tpu/utils/profiling.py (``trace`` :18,
``measure_steps_per_sec`` :28, ``RealTimeFactor`` :60): a
``torch.profiler`` capture around any code, a steps/s harness, and the
reference's real-time factor. Beside them, the port's roofline tools,
which take the place of XLA's cost model: ``OpCount``/``count_ops``
count the operations a plain PyTorch function performs, ``bound`` turns
bytes and operations into the least time the card could take, and
``traced``/``kernel_time`` read the card's device time per kernel from a
trace.
"""

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM data sheet: float32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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
    """Counts the operations a plain version performs: one per output
    element of every elementwise aten op (tagged pointwise), one per
    input element of a reduction, and, with ``matmul``, 2 m n k per
    matrix product. ``bytes`` adds up each op's tensor inputs and
    outputs: the traffic of running the ops one by one."""

    REDUCTIONS = ("aten.amin", "aten.amax", "aten.sum", "aten.mean")
    MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")

    def __init__(self, matmul=False):
        super().__init__()
        self.ops = 0
        self.bytes = 0
        self.matmul = matmul

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        name = str(func)
        if torch.Tag.pointwise in func.tags:
            self.ops += sum(o.numel() for o in outs
                            if isinstance(o, torch.Tensor))
        elif name.startswith(self.REDUCTIONS):
            self.ops += args[0].numel()
        elif self.matmul and name.startswith(self.MATMULS):
            a = args[1] if name.startswith(("aten.addmm", "aten.baddbmm")) \
                else args[0]
            self.ops += 2 * outs[0].numel() * a.shape[-1]
        self.bytes += nbytes(*outs, *[a for a in args
                                      if isinstance(a, torch.Tensor)])
        return out


def count_ops(fn, matmul=False):
    """The operations ``fn()`` performs (``OpCount``)."""
    with OpCount(matmul) as c:
        fn()
    return c.ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(inputs, outputs, ops):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM's rate and
    the operations over the float32 peak."""
    b = nbytes(*inputs) + nbytes(*outputs)
    t_b, t_o = b / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": b, "ops": ops}


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

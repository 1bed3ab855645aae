"""Per-op cost calibration on the card (K6).

Counterpart of scripts/vpu_calibrate.py (``OPS`` :48, ``_kernel`` :66,
``chain_time`` :84, ``calibrate`` :107). A kernel (csrc/op_chain.cu)
runs ``iters`` outer rounds of 16 inlined rounds of ``N_IND`` = 8
independent chains ``y = op(y, 0.7)`` over a (rows, 128) float32 block
and writes the chains' sum. Two chain lengths difference out the launch
and loop overhead:

    cost_per_iter = (t(2 iters) - t(iters)) / iters
    weight(op)    = cost_per_iter(op) / cost_per_iter(fma)

The weights are this card's per-op costs under the port's build flags
(``-fmad=false``: the ``fma`` op is an unfused multiply and add, so every
weight is relative to that pair), for an operation-weighted bound of the
port's kernels.

``ROWS``: the TPU script's 32 rows were sized for VMEM. Here each element
is one thread, and a measurement of throughput needs every SM's every
issue slot busy: 132 SMs x 2048 resident threads = 270,336 threads, i.e.
2,112 rows of 128.

CLI (needs a CUDA device; measures nothing on the CPU):

    python -m gym_pybullet_adrp_tpu_torch.op_calibrate [--iters N]
        [--rows 2112] [--target_ms 10]
"""

import argparse
import math
import sys

import torch

from .ops import _build
from .ops.race_step import launch_error
from .ops.race_window import _check_block

N_IND = 8
N_INLINE = 16
ROWS = 2112
LANE = 128

OPS = {
    # name -> fn(y, c), in the order of csrc/op_chain.cu's enum
    "fma": lambda y, c: y * 0.9999 + c,
    "mul": lambda y, c: y * 0.9999,
    "add": lambda y, c: y + c,
    "max": lambda y, c: torch.clamp_min(y, c),
    "div": lambda y, c: torch.full_like(y, c) / y,   # a true division
    "sqrt": lambda y, c: torch.sqrt(y) + c,
    "rsqrt": lambda y, c: torch.rsqrt(y) + c,
    "sin": lambda y, c: torch.sin(y) + c,
    "cos": lambda y, c: torch.cos(y) + c,
    "exp": lambda y, c: torch.exp(y * 0.1),
    "log": lambda y, c: torch.log(y) + c,
    "tanh": lambda y, c: torch.tanh(y) + c,
    "logistic": lambda y, c: torch.sigmoid(y) + c,
}


def op_chain_plain(op, x, iters):
    """Plain PyTorch version of the chain kernel (any device). The ``log``
    chain leaves the domain after a few rounds (log(y) + 0.7 < y for
    every y > 0) and ends in NaN, as in the TPU script."""
    fn = OPS[op]
    c = 0.7
    ys = [x * (1.0 + 0.1 * j) + 0.5 for j in range(N_IND)]
    for _ in range(iters * N_INLINE):
        ys = [fn(y, c) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def op_chain(op, x, iters):
    """The chains of ``op`` over x (rows, 128) float32; returns (rows,
    128). CPU tensors take the plain version. CUDA tensors launch the
    kernel (csrc/op_chain.cu, one thread per element) on the current
    stream, counting the launch in ``op_chain.launches``. Any other device
    raises."""
    dev = x.device
    if dev.type == "cpu":
        return op_chain_plain(op, x, iters)
    if dev.type != "cuda":
        raise ValueError(f"op_chain: unsupported device {dev}")
    if op not in OPS:
        raise ValueError(f"op_chain: unknown op {op!r}")
    if x.dim() != 2 or x.shape[1] != LANE or iters < 0:
        raise ValueError(f"op_chain: expected (rows, 128) and iters >= 0, "
                         f"got {tuple(x.shape)}, {iters}")
    _check_block("x", x, tuple(x.shape), dev)
    out = torch.empty_like(x)
    lib = _build.library("op_chain")
    with torch.cuda.device(dev):
        err = lib.adrp_op_chain(list(OPS).index(op), x.data_ptr(),
                                out.data_ptr(), x.numel(), int(iters),
                                torch.cuda.current_stream(dev).cuda_stream)
    launch_error("op_chain", err)
    op_chain.launches += 1
    return out


op_chain.launches = 0


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("op_calibrate measures the card: no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def chain_time(op, iters, rows=ROWS, repeats=8):
    """Seconds per launch of the chain kernel, the least of 5 means of
    ``repeats`` launches timed with CUDA events."""
    dev = _require_card()
    x = torch.full((rows, LANE), 0.62, dtype=torch.float32, device=dev)
    op_chain(op, x, iters)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            op_chain(op, x, iters)
        stop.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(stop) / 1e3 / repeats)
    return min(times)


def calibrate(iters=None, rows=ROWS, target_ms=10.0, verbose=True):
    """Per-op rates (op-elements/s) and weights against ``fma``. With
    ``iters`` None each op's ``iters`` is set from a short probe so that
    its longer chain takes about ``2 * target_ms``. Returns (weights,
    rates, iters by op)."""
    elems = N_INLINE * N_IND * rows * LANE
    rates, used = {}, {}
    for op in OPS:
        k1 = iters
        if k1 is None:
            probe = 64
            t = chain_time(op, probe, rows, repeats=2)
            k1 = max(probe, int(probe * target_ms * 1e-3 / t))
        t1, t2 = chain_time(op, k1, rows), chain_time(op, 2 * k1, rows)
        per_iter = (t2 - t1) / k1
        rates[op], used[op] = elems / per_iter, k1
        if verbose:
            w = rates["fma"] / rates[op]
            print(f"{op:9s} iters {k1:7d}  {rates[op] / 1e12:8.4f}T "
                  f"elems/s   weight vs fma: {w:7.3f}", flush=True)
    weights = {op: rates["fma"] / r for op, r in rates.items()}
    return weights, rates, used


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=None,
                    help="outer rounds (x16 inlined op rounds each); "
                         "default: per op, from --target_ms")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--target_ms", type=float, default=10.0)
    args = ap.parse_args(argv)
    _require_card()
    print(torch.cuda.get_device_name(), flush=True)
    weights, _, _ = calibrate(args.iters, args.rows, args.target_ms)
    print("weights vs fma (unfused multiply + add) = {")
    for op, w in weights.items():
        print(f'    "{op}": {w:.4g},')
    print("}")
    return 0 if all(math.isfinite(w) for w in weights.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

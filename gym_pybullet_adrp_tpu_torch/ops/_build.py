"""Build the port's kernels with nvcc at first use and bind them with ctypes.

``library(name)`` returns the shared library of ``csrc/<name>.cu``, with
its plain C interface, built for ``sm_90a`` (Hopper) under
``gym_pybullet_adrp_tpu_torch/_build/`` (listed in ``.gitignore``). The
first call compiles every source that has no library yet, one nvcc per
source, all started together. A file name carries a hash of its source,
the headers it includes (followed through ``#include "..."``) and the
flags, so an edited source or header rebuilds the libraries that include
it, and only those, and a stale library is never loaded. Only sources in
this package are compiled; nothing is downloaded.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded,
as PyTorch's elementwise kernels round them, so each kernel agrees with
its plain PyTorch version to the bit wherever no libm function
intervenes; no ``--use_fast_math`` (IEEE division and square root).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("race_window", "race_step", "race_rollout", "hover_step",
           "hover_rollout", "op_chain")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
ARCH = "sm_90a"
NVCC_FLAGS = (
    f"-gencode=arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-fmad=false", "-lineinfo",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs = {}
build_info = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's kernels are built from "
        "gym_pybullet_adrp_tpu_torch/csrc at first use on a CUDA machine"
    )


def includes(fname) -> list:
    """``fname`` and the csrc headers it includes, transitively, in order
    of first appearance."""
    seen = [fname]
    for f in seen:
        for inc in _INCLUDE.findall((CSRC / f).read_text()):
            if (CSRC / inc).exists() and inc not in seen:
                seen.append(inc)
    return seen


def _target(name) -> Path:
    h = hashlib.sha256()
    for fname in includes(name + ".cu"):
        h.update(fname.encode())
        h.update((CSRC / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libadrp_{name}_{h.hexdigest()[:16]}.so"


def _report(target: Path) -> Path:
    """Where the ptxas report of a library is kept, beside it."""
    return target.with_suffix(".ptxas.txt")


def build() -> dict:
    """Compile every source without a library for its current text, in
    parallel; returns {name: library path}. Records ``build_info``
    (wall seconds, which were cached, the ptxas report of every library,
    kept beside it so that a cached library still has one)."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    t0 = time.perf_counter()
    procs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
        else:
            _report(todo[name]).write_text(text)
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    build_info.update(
        paths={n: str(t) for n, t in targets.items()},
        seconds=time.perf_counter() - t0,
        cached=sorted(set(SOURCES) - set(todo)),
        ptxas="\n".join(
            f"== {n}.cu\n" + (_report(t).read_text()
                              if _report(t).exists() else "")
            for n, t in targets.items()),
    )
    return targets


def library(name):
    """The loaded library of ``csrc/<name>.cu`` (all built on first call)."""
    if not _libs:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            # one packed buffer of arguments (ops/race_window.py)
            "race_window": ("adrp_race_window", [ctypes.c_char_p]),
            "race_step": ("adrp_race_step", [vp, vp, vp]),
            "race_rollout": ("adrp_race_rollout", [vp, vp, vp]),
            # one packed buffer of arguments (ops/hover_step.py)
            "hover_step": ("adrp_hover_step", [ctypes.c_char_p]),
            "hover_rollout": ("adrp_hover_rollout", [ctypes.c_char_p]),
            "op_chain": ("adrp_op_chain", [i, vp, vp, ll, i, vp]),
        }
        libs = {}
        for n, path in build().items():
            lib = ctypes.CDLL(str(path))
            fn, argtypes = sigs[n]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = i
            libs[n] = lib
        for n in ("race_step", "race_rollout"):
            fn = getattr(libs[n], f"adrp_{n}_geometry")
            fn.argtypes = [vp, i, vp]
            fn.restype = i
        libs["race_window"].adrp_error_string.argtypes = [i]
        libs["race_window"].adrp_error_string.restype = ctypes.c_char_p
        _libs.update(libs)
    return _libs[name]


def error_string(err: int) -> str:
    msg = library("race_window").adrp_error_string(err).decode()
    return f"{err} ({msg})"


# the eager paths to differentiate instead of the kernel routes
HOVER_EAGER = "envs/rl.rl_step (the eager hover env)"
RACE_EAGER = "envs/race_rl.rl_race_step without fast (the eager race step)"


def refuse_grad(route, eager, *tensors):
    """Raise where autograd would record through a kernel route: the
    kernels have no backward, so a gradient taken through one would be
    silently zero. ``eager`` names the path to differentiate instead.
    Called once where a route is entered, before it picks the kernel or
    its plain version. The tensors' flags are read before the grad mode:
    a headline loop enters the K2 route once a launch."""
    for t in tensors:
        if t is not None and t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{route}: the hand-written kernel has no backward, so a "
                f"gradient through it would be zero; differentiate {eager} "
                f"instead, or call it under torch.no_grad()")


def launch_error(name, err):
    """Raise on a launch's non-zero ``cudaGetLastError``."""
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {error_string(err)}")


# ---------------------------------------------------------------------------
# what a wrapper needs per launch, looked up once


_entries = {}   # csrc name -> its C entry point, bound once
_n_sm = {}      # device index -> SM count


def entry(name):
    """The C entry point ``adrp_<name>`` of ``csrc/<name>.cu``."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(name), f"adrp_{name}")
    return fn


def sm_count(idx):
    """The SM count of CUDA device ``idx``."""
    n = _n_sm.get(idx)
    if n is None:
        import torch

        n = _n_sm[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def device_index(dev):
    import torch

    return dev.index if dev.index is not None else torch.cuda.current_device()


def raw_stream(idx):
    """The raw handle of device ``idx``'s current stream. (The getter
    PyTorch's own generated kernels call: the public ``current_stream``
    builds a Stream object, a few microseconds of host time a launch.)"""
    import torch

    return torch._C._cuda_getCurrentRawStream(idx)


def call_on(idx, fn, args):
    """fn(args) with device ``idx`` made the current device for the call
    if it is not already (``torch.cuda.device`` swaps the device twice,
    a few microseconds a launch); returns the C error code."""
    import torch

    if torch._C._cuda_getDevice() == idx:
        return fn(args)
    with torch.cuda.device(idx):
        return fn(args)

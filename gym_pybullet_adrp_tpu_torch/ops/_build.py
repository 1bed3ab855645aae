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


def build() -> dict:
    """Compile every source without a library for its current text, in
    parallel; returns {name: library path}. Records ``build_info``
    (wall seconds, which were cached, the ptxas report)."""
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
    reports, failed = [], []
    for name, (cmd, tmp, proc) in procs.items():
        text = proc.communicate()[0]
        reports.append(f"== {name}.cu\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    build_info.update(
        paths={n: str(t) for n, t in targets.items()},
        seconds=time.perf_counter() - t0,
        cached=sorted(set(SOURCES) - set(todo)),
        ptxas="\n".join(reports),
    )
    return targets


def library(name):
    """The loaded library of ``csrc/<name>.cu`` (all built on first call)."""
    if not _libs:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            "race_window": ("adrp_race_window", [vp, vp, vp, vp, ll, vp, vp]),
            "race_step": ("adrp_race_step", [vp, vp, vp]),
            "race_rollout": ("adrp_race_rollout", [vp, vp, vp]),
            "hover_step": ("adrp_hover_step", [vp, vp, vp, ll, vp, i, vp]),
            "hover_rollout": ("adrp_hover_rollout",
                              [vp, vp, vp, vp, vp, ll, i, ctypes.c_uint, i,
                               i, vp, i, vp]),
            "op_chain": ("adrp_op_chain", [i, vp, vp, ll, i, vp]),
        }
        libs = {}
        for n, path in build().items():
            lib = ctypes.CDLL(str(path))
            fn, argtypes = sigs[n]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = i
            libs[n] = lib
        libs["race_window"].adrp_error_string.argtypes = [i]
        libs["race_window"].adrp_error_string.restype = ctypes.c_char_p
        _libs.update(libs)
    return _libs[name]


def error_string(err: int) -> str:
    msg = library("race_window").adrp_error_string(err).decode()
    return f"{err} ({msg})"

"""Build the race kernels with nvcc at first use and bind them with ctypes.

``library()`` compiles ``csrc/race_window.cu`` and ``csrc/race_step.cu``
into one shared library with a plain C interface, for ``sm_90a``
(Hopper), under ``gym_pybullet_adrp_tpu_torch/_build/`` (listed in
``.gitignore``). The file name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded. Only
sources in this package are compiled; nothing is downloaded.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded,
as PyTorch's elementwise kernels round them, so each kernel agrees with
its plain PyTorch version to the bit wherever no libm function
intervenes; no ``--use_fast_math`` (IEEE division and square root).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("race_window.cu", "race_step.cu")
HEADERS = ("race_window.cuh",)
ARCH = "sm_90a"
NVCC_FLAGS = (
    f"-gencode=arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-fmad=false", "-lineinfo",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
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
        "/usr/local/cuda/bin): the race kernels are built from "
        "gym_pybullet_adrp_tpu_torch/csrc at first use on a CUDA machine"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Records ``build_info`` (seconds, ptxas report)."""
    out = BUILD_DIR / f"libadrp_race_{_digest()}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False,
                      ptxas=res.stderr + res.stdout)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.adrp_race_window.argtypes = [vp, vp, vp, vp, ll, vp, vp]
        lib.adrp_race_window.restype = i
        lib.adrp_race_step.argtypes = [vp, vp, vp]
        lib.adrp_race_step.restype = i
        lib.adrp_error_string.argtypes = [i]
        lib.adrp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({library().adrp_error_string(err).decode()})"

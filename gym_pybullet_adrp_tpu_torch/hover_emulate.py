"""Run the hover kernels' CUDA sources on the CPU and hold them against
their plain PyTorch versions, without a card.

  python3 -m gym_pybullet_adrp_tpu_torch.hover_emulate [--envs 256]
      [--steps 37]

g++ compiles csrc/hover_rollout.cu and csrc/hover_step.cu of this
checkout against a stub of the CUDA runtime (emu/cuda_runtime.h; the
launch syntax rewritten to a call): each CUDA thread is a host thread,
and a warp's ``__shfl_sync`` a pair of barriers over its 32 threads
(emu/emu_rt.cpp). Multiplies and adds stay separately rounded
(``-ffp-contract=off``), as ``-fmad=false`` keeps them on the card. The
library is then called through the wrappers' own packed arguments. Cases
(``cases``): K2 small-angle and exact, K7 (``<false, false>``), each with
Philox and with injected draws, at every lane count the rollout kernel is
built for; and K1. Each rollout at L > 1 must equal L = 1 bit for bit,
and the small-angle cases the plain version on the same inputs. The
emulation runs the host's libm (``sinf``, ``cosf``), which rounds some
arguments apart from PyTorch's CPU ``sin``/``cos``, so the exact paths
(K2 exact, K7, K1) are held to the plain version within ``EXACT_ATOL``.
Prints one line per case; exits 1 if any case fails (``failures``).

What this does not check: the card's scheduling (a warp here runs its
lanes as threads between barriers), its libm, and whatever nvcc does
that g++ does not. It is a rehearsal before a card run, not a
replacement for ``tests/test_torch_cuda.py``.
"""

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .models.drone import drone_params
from .ops import hover_step as hs
from .ops import quat as quat_ops

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
EMU = PKG / "emu"
SOURCES = ("hover_rollout.cu", "hover_step.cu")
HEADERS = ("hover_step.cuh",)
GXX_FLAGS = ("-std=c++20", "-O2", "-ffp-contract=off", "-fno-fast-math",
             "-fPIC", "-shared", "-pthread")
_LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                     re.S)

# (name, smallangle, near_sqrt): the rollout kernel's instantiations
ROLLOUTS = (("k2_smallangle", True, False), ("k2_exact", False, True),
            ("k7", False, False))


def _rewrite(src: str) -> str:
    """``k<<<blocks, threads, ...>>>(args);`` -> ``emu_launch(blocks,
    threads, [&] { k(args); });``"""
    def one(m):
        grid = [a.strip() for a in m.group(2).split(",")]
        return (f"emu_launch({grid[0]}, {grid[1]}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")
    return _LAUNCH.sub(one, src)


def build(out_dir=None) -> ctypes.CDLL:
    """The hover sources compiled by g++ for the CPU into ``out_dir``
    (default: the package's ``_build/emu``), loaded. The library's name
    carries a hash of the sources and flags."""
    out_dir = Path(out_dir or PKG / "_build" / "emu")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update((CSRC / f).read_bytes())
    for f in ("cuda_runtime.h", "emu_rt.cpp"):
        h.update((EMU / f).read_bytes())
    lib = out_dir / f"libhover_emu_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            srcs = []
            for f in SOURCES:
                dst = Path(tmp) / f.replace(".cu", ".cpp")
                dst.write_text(_rewrite((CSRC / f).read_text()))
                srcs.append(str(dst))
            part = Path(tmp) / lib.name
            subprocess.run(["g++", *GXX_FLAGS, f"-I{EMU}", f"-I{CSRC}",
                            "-o", str(part), *srcs, str(EMU / "emu_rt.cpp")],
                           check=True, capture_output=True, text=True)
            part.replace(lib)
    out = ctypes.CDLL(str(lib))
    for fn in (out.adrp_hover_rollout, out.adrp_hover_step):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return out


def rollout(lib, c, st, seed, n_steps, smallangle, near_sqrt, actions,
            lanes):
    """(state, acc, resets) of the emulated rollout kernel on CPU tensors,
    with ``lanes`` lanes per env."""
    T = st.shape[1]
    out, acc, resets = (torch.empty_like(st), st.new_empty((T, hs.LANE)),
                        st.new_empty((T, hs.LANE)))
    err = lib.adrp_hover_rollout(hs._ROLLOUT_ARGS.pack(
        st.data_ptr(), 0 if actions is None else actions.data_ptr(),
        out.data_ptr(), acc.data_ptr(), resets.data_ptr(),
        ctypes.addressof(hs.consts_struct(c)), 0, T * hs.LANE, n_steps,
        seed & 0xFFFFFFFF, int(smallangle), int(near_sqrt), lanes,
        hs.THREADS))
    if err:
        raise RuntimeError(f"adrp_hover_rollout returned {err}")
    return out, acc, resets


def step(lib, c, st, rpm):
    """The emulated control-step kernel's new state."""
    out = torch.empty_like(st)
    err = lib.adrp_hover_step(hs._STEP_ARGS.pack(
        st.data_ptr(), rpm.data_ptr(), out.data_ptr(),
        ctypes.addressof(hs.consts_struct(c)), 0, st.shape[1] * hs.LANE,
        hs.THREADS))
    if err:
        raise RuntimeError(f"adrp_hover_step returned {err}")
    return out


def inputs(n_envs=256, n_steps=37, seed=5):
    """(state, rpm, actions) as the card tests draw them: random attitudes
    and rates, the first 128 envs on the ground with no thrust, so that
    contact and episode ends happen inside a launch."""
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    P = drone_params(device="cpu")
    pos = u(-1, 1, n_envs, 3) + torch.tensor([0.0, 0.0, 1.2])
    pos[:128, 2] = 0.02
    quat = quat_ops.from_euler_xyz(u(-0.3, 0.3, n_envs, 3))
    st = hs.pack_state(pos, quat, u(-1, 1, n_envs, 3), u(-2, 2, n_envs, 3))
    rpm = u(0.9, 1.1, 4, n_envs // 128, 128) * float(P.hover_rpm)
    rpm[:, 0] = 0.0
    acts = (u(0, 1, n_steps, 4, n_envs // 128, 128) - 0.5) * 0.1
    return P, st, rpm.contiguous(), acts


# the exact paths against the plain version: the host's sinf/cosf and
# PyTorch's CPU sin/cos differ in the last bit for some arguments, which
# 37 steps carry to a few 1e-6 in the state and 1e-5 in the reward sum
EXACT_ATOL = 1e-4


def _diff(got, ref):
    """(words whose bits differ, largest absolute difference) of two
    tuples of tensors."""
    words = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                for a, b in zip(got, ref))
    return words, max(float((a - b).abs().max()) for a, b in zip(got, ref))


def cases(lib, n_envs=256, n_steps=37, seed=21):
    """{case: {"plain": (words, max abs) against the plain version, "l1":
    words against L = 1 (rollouts at L > 1), "exact": whether the case
    runs sinf/cosf}}."""
    P, st, rpm, acts = inputs(n_envs, n_steps)
    c = hs.hover_consts(P)
    out = {}
    for name, small, near in ROLLOUTS:
        for mode in ("random", "injected"):
            a = acts if mode == "injected" else None
            ref = hs.rollout_plain(c, st, seed, n_steps, small, near, a,
                                   True)
            first = None
            for L in hs.ROLLOUT_LANES:
                got = rollout(lib, c, st, seed, n_steps, small, near, a, L)
                rec = {"plain": _diff(got, ref), "exact": not small}
                if first is None:
                    first = got
                else:
                    rec["l1"] = _diff(got, first)[0]
                out[f"{name} {mode} L={L}"] = rec
    c1 = hs.hover_consts(P, 8, 1 / 240)
    out["k1"] = {"plain": _diff(
        (step(lib, c1, st, rpm),),
        (hs.ctrl_step_packed_plain(P, st, rpm, 8, 1 / 240, consts=c1),)),
        "exact": True}
    return out


def failures(records):
    """The cases that fail: a lane group not bit for bit with L = 1; a
    small-angle case not bit for bit with the plain version; an exact one
    further from it than ``EXACT_ATOL``."""
    bad = []
    for key, r in records.items():
        words, err = r["plain"]
        if r.get("l1", 0) or (err > EXACT_ATOL if r["exact"] else words):
            bad.append(key)
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=256,
                    help="a multiple of 128")
    ap.add_argument("--steps", type=int, default=37)
    args = ap.parse_args()
    records = cases(build(), args.envs, args.steps)
    for key, r in records.items():
        words, err = r["plain"]
        print(f"{key}: {words} words differ from the plain version (max "
              f"{err:.3g})" + (f", {r['l1']} from L = 1" if "l1" in r
                               else ""))
    bad = failures(records)
    print("failed: " + ", ".join(bad) if bad else "ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

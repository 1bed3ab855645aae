"""The hover kernels' CUDA sources (csrc/hover_rollout.cu, csrc/hover_step.cu)
compiled by g++ against the CUDA stub and run on the CPU
(gym_pybullet_adrp_tpu_torch/hover_emulate.py): every lane group equals
one lane per env bit for bit, the small-angle rollouts equal their plain
PyTorch version bit for bit, and the exact paths (K2 exact, K7, K1) agree
with it within ``hover_emulate.EXACT_ATOL`` (the host's libm against
PyTorch's CPU sin/cos). The plain versions are held against the JAX
package in test_torch_hover_kernels.py. Skips where no g++ is found."""

import shutil

import pytest

from gym_pybullet_adrp_tpu_torch import hover_emulate as he
from gym_pybullet_adrp_tpu_torch.ops import hover_step as hs

CASES = [f"{name} {mode} L={L}" for name, _, _ in he.ROLLOUTS
         for mode in ("random", "injected") for L in hs.ROLLOUT_LANES] + ["k1"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the CUDA sources for the CPU")
    lib = he.build(tmp_path_factory.mktemp("hover_emu"))
    return he.cases(lib, n_envs=256, n_steps=37)


@pytest.mark.parametrize("case", CASES)
def test_emulated_hover_kernel_matches_plain(records, case):
    r = records[case]
    words, err = r["plain"]
    assert r.get("l1", 0) == 0          # a lane group: L = 1's bits
    if r["exact"]:
        assert err <= he.EXACT_ATOL
    else:
        assert words == 0 and err == 0.0
    assert he.failures({case: r}) == []


def test_emulated_rollouts_end_episodes():
    """The cases exercise the tail: the 128 grounded envs without thrust
    and the random attitudes end episodes inside a 37-step launch."""
    P, st, _, acts = he.inputs(256, 37)
    _, _, resets = hs.rollout_plain(hs.hover_consts(P), st, 21, 37, True,
                                    False, acts, True)
    assert float(resets.sum()) > 0

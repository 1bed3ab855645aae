"""Port: examples/hover_ceiling.py (the hover-PPO return ceiling) against
the JAX example on CPU.

* ``analytic_upper_bound`` equal to the JAX one to 1e-12, with the JAX
  test's assertions (tests/test_hover_ceiling.py:29-34).
* ``probe_best_return(grid=4, n_steps=30)``: the best return within 1e-3
  relative of the JAX probe's at the same arguments (the env's float32
  steps in both packages), at the same gains (kp, kd within 1e-6
  relative: each package's float32 ``linspace``).
* ``main`` prints the four lines of the JAX script.
* The grid-16 probe at the JAX test's criteria (:37-48), ``slow`` as there.
"""

import importlib.util
from pathlib import Path

import pytest

from gym_pybullet_adrp_tpu_torch.examples import hover_ceiling

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_spec = importlib.util.spec_from_file_location(
    "jax_hover_ceiling",
    Path(__file__).resolve().parent.parent / "examples/hover_ceiling.py")
jax_hc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_hc)


def test_analytic_upper_bound_matches_jax():
    ub = hover_ceiling.analytic_upper_bound()
    assert abs(ub - jax_hc.analytic_upper_bound()) <= 1e-12
    assert ub < 474.15 and 470.0 < ub < 473.0
    kw = dict(z0=0.2, zt=0.9, ep_sec=5.0, ctrl_hz=48, up=0.09)
    assert abs(hover_ceiling.analytic_upper_bound(**kw)
               - jax_hc.analytic_upper_bound(**kw)) <= 1e-12


def test_probe_matches_jax():
    best, kp, kd = hover_ceiling.probe_best_return(grid=4, n_steps=30,
                                                   device="cpu")
    jbest, jkp, jkd = jax_hc.probe_best_return(grid=4, n_steps=30)
    assert abs(best - jbest) <= 1e-3 * abs(jbest), (best, jbest)
    assert kp == pytest.approx(jkp, rel=1e-6)
    assert kd == pytest.approx(jkd, rel=1e-6, abs=1e-12)


def test_main_prints_the_ceiling(capsys):
    ub, best, _, _ = hover_ceiling.main(["--grid", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"analytic upper bound (frictionless): {ub:.2f}"
    assert out[1].startswith("probe best return (kp=")
    assert out[2].endswith(": 474.15")
    assert out[3] == "threshold attainable: False"
    assert best <= ub + 0.2


@pytest.mark.slow
def test_probe_reaches_bound_on_real_env():
    ub = hover_ceiling.analytic_upper_bound()
    best, kp, kd = hover_ceiling.probe_best_return(grid=16, device="cpu")
    assert best >= ub - 1.0, (best, ub)
    assert best <= ub + 0.2, (best, ub)
    assert 471.0 <= best

"""Port: the example scripts (gym_pybullet_adrp_tpu_torch/examples) on the
CPU at tests/test_examples.py's budgets and thresholds: ``pid`` (3 drones
hold their altitudes, 4 s), ``pid_velocity`` (4 drones climb above 0.3 m,
4 s), ``downwash`` (2 drones above 0.2 m, 4 s), ``cf`` (the square reaches
z > 0.8; ``slow``), ``beta`` (the circle reaches z > 0.8) and ``debug`` (1 s at
1.001x hover rpm climbs above 1 m). Each returns what the JAX example
returns; the JAX examples' own tests run beside these.
"""

from pathlib import Path

import numpy as np
import pytest

from gym_pybullet_adrp_tpu_torch.examples import (
    beta, cf, debug, downwash, pid, pid_velocity,
)

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_pid(tmp_path):
    logger = pid.run(gui=False, plot=False, output_folder=str(tmp_path),
                     duration_sec=4, device="cpu")
    z = logger.states[:, 2, -1]
    assert np.all(z > 0.05), z
    assert logger.states.shape == (3, 16, 4 * 48)
    assert list(tmp_path.glob("save-flight-*.npy"))


def test_pid_velocity(tmp_path):
    logger = pid_velocity.run(gui=False, plot=False,
                              output_folder=str(tmp_path), duration_sec=4,
                              device="cpu")
    assert np.all(logger.states[:, 2, :].max(axis=-1) > 0.3)


def test_downwash(tmp_path):
    logger = downwash.run(gui=False, plot=False, output_folder=str(tmp_path),
                          duration_sec=4, device="cpu")
    assert np.all(logger.states[:, 2, -1] > 0.2)


@pytest.mark.slow
def test_cf(tmp_path):
    """A 525-step closed loop over the firmware window that
    tests/test_torch_cf_beta.py holds against the JAX package tick by
    tick (~30 s here); chip_smoke.py runs it on the card."""
    logger = cf.run(gui=False, plot=False, output_folder=str(tmp_path),
                    device="cpu")
    assert logger.states[0, 2, :].max() > 0.8
    assert logger.states.shape[-1] == 7 * 75
    assert list(tmp_path.glob("save-flight-cf-*/z0.csv"))


def test_beta(tmp_path):
    logger = beta.run(gui=False, plot=False, output_folder=str(tmp_path),
                      device="cpu")
    assert logger.states[0, 2, :].max() > 0.8


def test_debug():
    state = debug.run(duration_sec=1, device="cpu")
    assert float(state.phys.pos[0, 0, 2]) > 1.0


def test_logger_saves_what_the_jax_logger_saves(tmp_path):
    """utils/logger.py against the JAX package's Logger: the same samples
    give the same arrays, .npy archive and CSV files."""
    from gym_pybullet_adrp_tpu.utils.logger import Logger as JLogger
    from gym_pybullet_adrp_tpu_torch.utils.logger import Logger

    rng = np.random.default_rng(0)
    logs = []
    for cls, sub in ((Logger, "port"), (JLogger, "jax")):
        log = cls(logging_freq_hz=25, output_folder=str(tmp_path / sub),
                  num_drones=2, duration_sec=1)
        for i in range(30):          # past the preallocated 25 samples
            for j in range(2):
                log.log(drone=j, timestamp=i / 25,
                        state=rng.standard_normal(20),
                        control=np.full(12, float(i)))
        log.log(drone=5, timestamp=0.0, state=np.zeros(20))  # refused
        rng = np.random.default_rng(0)
        csv = sorted(p.name for p in Path(log.save_as_csv("x")).glob("*.csv"))
        logs.append((log, np.load(log.save()), csv))
    (a, na, ca), (b, nb, cb) = logs
    for k in ("timestamps", "states", "controls"):
        np.testing.assert_array_equal(na[k], nb[k])
    np.testing.assert_array_equal(a.counters, b.counters)
    assert a.states.shape == (2, 16, 30) and ca == cb and len(ca) == 40

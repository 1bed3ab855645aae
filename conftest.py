"""How a pytest-xdist run with ``--dist loadfile`` deals the tests out to its workers.

pytest-xdist 3.8 hands out whole test files, those with the most tests first, and a
worker runs each file it is given from its first test to its last. Two things in this
repo's suite do not fit that order:

* ``tests/test_race_rowfast.py`` holds 11 tests of the Pallas race kernels in interpret
  mode, 60-400 s each and ~1500 s together: one worker running all of them outlasts
  the rest of the run by minutes.
* Files with few but long tests (``tests/test_pallas_race.py``: 4 tests, ~400 s) come
  last, behind dozens of quick files, and end the run on their own.

So the scheduler below deals the tests of the files in ``PER_TEST`` out one by one and
hands out the units of work in ``SECONDS`` first, longest first; every other file
follows in xdist's own order. It decides only which worker runs a test and when:
every collected test runs, on a worker that collected the same tests.
"""

import pytest

# Files whose tests are dealt out one by one: no test in them shares state with another.
PER_TEST = ("tests/test_race_rowfast.py",)

# Seconds a unit of work (a file, or one test of a PER_TEST file) took on its worker,
# every unit of 60 s or more: ROADMAP.md's tier-1 command on an 8-core CPU-only host.
SECONDS = {
    "tests/test_torch_race_rollout.py": 607,
    "tests/test_pallas_race.py": 413,
    "tests/test_torch_race_step.py": 398,
    "tests/test_race_rowfast.py::test_fused_matches_unfused": 394,
    "tests/test_policy_fused.py": 385,
    "tests/test_race_rowfast.py::test_rollout_kernel_matches_step_sequence": 232,
    "tests/test_torch_slice.py": 227,
    "tests/test_torch_tools.py": 217,
    "tests/test_race_rowfast.py::test_rowfast_matches_general_path": 198,
    "tests/test_rl.py": 197,
    "tests/test_torch_train.py": 193,
    "tests/test_controllers.py": 176,
    "tests/test_torch_diff.py": 174,
    "tests/test_race_vector.py": 170,
    "tests/test_race_rowfast.py::test_rowfast_level2_randomization": 160,
    "tests/test_race_rl.py": 140,
    "tests/test_race_rowfast.py::test_rowfast_per_drone_reward_selfplay": 137,
    "tests/test_race_rowfast.py::test_rowfast_compete_matches_fast_path": 135,
    "tests/test_torch_hover_emulation.py": 131,
    "tests/test_torch_race_window.py": 121,
    "tests/test_torch_hover_kernels.py": 120,
    "tests/test_torch_cf_beta.py": 116,
    "tests/test_torch_video.py": 115,
    "tests/test_examples.py": 110,
    "tests/test_race_rowfast.py::test_rollout_policy_matches_step_policy": 106,
    "tests/test_agents.py": 106,
    "tests/test_render.py": 95,
    "tests/test_torch_pixels.py": 95,
    "tests/test_torch_race_general_env.py": 94,
    "tests/test_torch_reports_lockstep.py": 90,
    "tests/test_race_rowfast.py::test_rowfast_compete_drone_collision_eliminates": 89,
    "tests/test_torch_reports.py": 84,
    "tests/test_roofline.py": 82,
    "tests/test_torch_race_general.py": 78,
    "tests/test_torch_race_general_step.py": 75,
    "tests/test_torch_ppo.py": 74,
    "tests/test_torch_race_general_fast.py": 70,
    "tests/test_race_rowfast.py::test_rowfast_disturbances": 64,
    "tests/test_bench.py": 61,
}


def unit_of(nodeid):
    """The unit of work a test is dealt out in: itself in a PER_TEST file, else its file."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in PER_TEST else path


def longest_first(queue):
    """Move the units of an OrderedDict that SECONDS lists to its front, longest first."""
    for unit in sorted((u for u in queue if u in SECONDS), key=SECONDS.get):
        queue.move_to_end(unit, last=False)
    return queue


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        ordered = False

        def _split_scope(self, nodeid):
            return unit_of(nodeid)

        def _assign_work_unit(self, node):
            # The first call comes once the whole queue is built, before any unit leaves it.
            if not self.ordered:
                longest_first(self.workqueue)
                self.ordered = True
            super()._assign_work_unit(node)

    return Scheduling(config, log)

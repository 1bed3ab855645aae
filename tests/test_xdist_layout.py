"""The repo's pytest-xdist layout (the root ``conftest.py``): units of work and their order."""

import collections
import importlib.util
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("xdist_layout", ROOT / "conftest.py")
layout = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(layout)


def test_unit_of():
    row = "tests/test_race_rowfast.py::test_fused_matches_unfused"
    assert layout.unit_of(row) == row
    assert layout.unit_of("tests/test_torch_slice.py::test_a[x-1]") == "tests/test_torch_slice.py"
    assert layout.unit_of("tests/test_rl.py::Cls::test_b") == "tests/test_rl.py"


def test_longest_first():
    queue = collections.OrderedDict(
        (u, {}) for u in ("tests/test_a.py", "tests/test_rl.py", "tests/test_b.py",
                          "tests/test_torch_race_rollout.py",
                          "tests/test_race_rowfast.py::test_fused_matches_unfused"))
    assert list(layout.longest_first(queue)) == [
        "tests/test_torch_race_rollout.py",
        "tests/test_race_rowfast.py::test_fused_matches_unfused",
        "tests/test_rl.py", "tests/test_a.py", "tests/test_b.py"]


def test_listed_units_exist():
    # A renamed file or test would drop out of the table without a word.
    for unit in list(layout.SECONDS) + list(layout.PER_TEST):
        path, _, name = unit.partition("::")
        assert (ROOT / path).is_file(), unit
        if name:
            assert path in layout.PER_TEST, unit
            assert re.search(rf"^def {name}\(", (ROOT / path).read_text(), re.M), unit

"""Port: scenario configs, race spec and track against the JAX package."""

from dataclasses import fields

import numpy as np
import pytest
import yaml

from gym_pybullet_adrp_tpu.envs import race as jrace
from gym_pybullet_adrp_tpu.utils.config import load_config as jload
from gym_pybullet_adrp_tpu.utils.enums import Physics as JPhysics
from gym_pybullet_adrp_tpu.utils.enums import RaceMode as JRaceMode
from gym_pybullet_adrp_tpu_torch.envs import race as prace
from gym_pybullet_adrp_tpu_torch.utils.config import (
    CONFIG_DIR, load_config, parse_yaml,
)
from gym_pybullet_adrp_tpu_torch.utils.enums import RaceMode

CONFIGS = sorted(p.stem for p in CONFIG_DIR.glob("*.yaml"))


def _same(a, b, path="cfg"):
    """Equal values of equal types, recursively (1 == 1.0 == True in a
    plain ``==``)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_all_bundled_configs_listed():
    assert len(CONFIGS) == 6, CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_subset_reader_matches_pyyaml(name):
    text = (CONFIG_DIR / f"{name}.yaml").read_text()
    _same(parse_yaml(text), yaml.safe_load(text))


def test_yaml_subset_reader_scalars():
    doc = ("a: -0.000001  # comment\n"
           "b: [1, 2.5, 'x', \"y # z\", True]\n"
           "c:\n  - [0, -1]\n  - [2, 3]\n"
           "d:\n  e: no\n  f: ~\n"
           "g: 1e-6\n")
    out = parse_yaml(doc)
    _same(out, yaml.safe_load(doc))
    assert out["g"] == "1e-6"   # YAML 1.1: a float needs a dot


@pytest.mark.parametrize("n_drones", [1, 2, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_race_spec_and_track_match_jax(name, n_drones):
    mode = RaceMode.COMPETE if n_drones > 1 else RaceMode.COMPARE
    jmode = JRaceMode.COMPETE if n_drones > 1 else JRaceMode.COMPARE
    spec = prace.RaceSpec.from_config(load_config(name), n_drones, mode)
    jspec = jrace.RaceSpec.from_config(jload(name), n_drones, jmode,
                                       JPhysics.PYB)
    for f in fields(jrace.RaceSpec):
        a, b = getattr(spec, f.name), getattr(jspec, f.name)
        if f.name in ("racemode", "physics", "drone_model"):
            assert a.name == b.name and a.value == b.value, f.name
        else:
            assert a == b, (f.name, a, b)
    assert spec.obs_size == jspec.obs_size
    assert spec.steps_per_ctrl == jspec.steps_per_ctrl
    track = prace.track_from_config(load_config(name), n_drones)
    jtrack = jrace.track_from_config(jload(name), n_drones)
    for k in jtrack._fields:
        a, b = getattr(track, k), np.asarray(getattr(jtrack, k))
        assert a.dtype == np.float32 and b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_model_scalars_match_jax():
    from gym_pybullet_adrp_tpu.envs.race_fast import _model_scalars

    spec = prace.RaceSpec.from_config(load_config("level1"), 1,
                                      RaceMode.COMPARE)
    jspec = jrace.RaceSpec.from_config(jload("level1"), 1,
                                       JRaceMode.COMPARE, JPhysics.PYB)
    assert prace.model_scalars(spec) == _model_scalars(jspec)

"""Port: drone URDF IO (models/urdf.py) against the JAX package's
(gym_pybullet_adrp_tpu/models/urdf.py), and tests/test_urdf.py's checks
on the port: parsing a reference-style URDF, the registry round trip for
every model (``torch.equal`` with ``drone_params``), a custom drone
stepping the hover env, the parse errors. Parsed values are Python floats
and compared for equality; the written XML is compared as text.
"""

import numpy as np
import pytest
import torch

from gym_pybullet_adrp_tpu.models import urdf as jurdf
from gym_pybullet_adrp_tpu_torch.envs import rl as rlenv
from gym_pybullet_adrp_tpu_torch.envs.core import AviaryConfig
from gym_pybullet_adrp_tpu_torch.models import urdf
from gym_pybullet_adrp_tpu_torch.models.drone import _REGISTRY, drone_params
from gym_pybullet_adrp_tpu_torch.utils.enums import DroneModel

from _torch_port import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# reference-style URDF: comments, visual before collision, a mesh visual,
# extra attributes in <properties>, several links (tests/test_urdf.py)
REFERENCE_STYLE_URDF = """<?xml version="1.0" ?>
<robot name="custom">
  <properties arm="0.05" kf="4.0e-10" km="8.0e-12" thrust2weight="2.5"
    max_speed_kmh="40" gnd_eff_coeff="11.0" prop_radius="2.5e-2"
    drag_coeff_xy="9.0e-7" drag_coeff_z="10.0e-7"
    dw_coeff_1="2000.0" dw_coeff_2=".15" dw_coeff_3="-.1"
    pwm2rpm_scale="0.2685" pwm2rpm_const="4070.3"
    pwm_min="20000.0" pwm_max="65535.0" />
  <link name="base_link">
    <inertial>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <!-- measured mass -->
      <mass value="0.04"/>
      <inertia ixx="1.5e-5" ixy="0.0" ixz="0.0" iyy="1.6e-5" iyz="0.0"
        izz="2.2e-5"/>
    </inertial>
    <visual>
      <origin rpy="0 0 55" xyz="0 0 0"/>
      <geometry><mesh filename="./cf2.dae" scale="1 1 1"/></geometry>
    </visual>
    <collision>
      <origin rpy="0 0 0" xyz="0 0 0.01"/>
      <geometry><cylinder length="0.03" radius="0.07"/></geometry>
    </collision>
  </link>
  <link name="prop0_link"><inertial>
    <mass value="0.0"/>
    <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
  </inertial></link>
</robot>
"""


def test_parse_reference_style_urdf():
    raw = urdf.parse_drone_urdf(REFERENCE_STYLE_URDF)
    assert raw["mass"] == 0.04
    assert raw["arm"] == 0.05
    assert raw["thrust2weight"] == 2.5
    assert raw["J"] == (1.5e-5, 1.6e-5, 2.2e-5)
    assert raw["kf"] == 4.0e-10 and raw["km"] == 8.0e-12
    assert raw["collision_h"] == 0.03
    assert raw["collision_r"] == 0.07
    assert raw["collision_z_offset"] == 0.01
    assert raw["drag_coeff"] == (9.0e-7, 9.0e-7, 10.0e-7)
    assert raw["dw_coeff_1"] == 2000.0
    assert raw["dw_coeff_2"] == 0.15 and raw["dw_coeff_3"] == -0.1
    assert raw["pwm2rpm_scale"] == 0.2685 and raw["pwm_max"] == 65535.0


@pytest.mark.parametrize("model", list(DroneModel))
def test_registry_roundtrip(model, tmp_path):
    """write(registry entry) -> parse == the entry, for every model; the
    parsed params equal the embedded registry's by ``torch.equal``."""
    raw = dict(_REGISTRY[model])
    path = tmp_path / f"{model.name.lower()}.urdf"
    urdf.write_drone_urdf(raw, path)
    parsed = urdf.parse_drone_urdf(path)
    for k, v in raw.items():
        assert parsed[k] == v, k
    via_urdf = urdf.drone_params_from_urdf(path, device="cpu")
    for a, b in zip(via_urdf, drone_params(model, device="cpu")):
        assert torch.equal(a, b)


def test_urdf_params_run_in_env():
    """A custom-URDF drone steps through the hover env."""
    params = urdf.drone_params_from_urdf(REFERENCE_STYLE_URDF, device="cpu")
    cfg = rlenv.RLConfig(aviary=AviaryConfig(ctrl_freq=30))
    state = rlenv.rl_reset(cfg, np.array([[0.0, 0.0, 0.1125]]),
                           np.zeros((1, 3)), 1, device="cpu")
    action = torch.zeros((1, 1, cfg.act_size))
    for _ in range(3):
        state, obs, reward, term, trunc = rlenv.rl_step(cfg, params, state,
                                                        action)
    assert torch.isfinite(obs).all()


def test_parse_errors():
    with pytest.raises(ValueError, match="properties"):
        urdf.parse_drone_urdf("<robot><link name='l'/></robot>")
    with pytest.raises(ValueError, match="missing attributes"):
        urdf.parse_drone_urdf("<robot><properties arm='0.1'/></robot>")
    props = REFERENCE_STYLE_URDF.split("<link")[0]
    with pytest.raises(ValueError, match="no <link>"):
        urdf.parse_drone_urdf(props + "</robot>")
    no_col = REFERENCE_STYLE_URDF.replace("<collision>", "<!--").replace(
        "</collision>", "-->")
    with pytest.raises(ValueError, match="no <collision>"):
        urdf.parse_drone_urdf(no_col)


@pytest.mark.parametrize("model", list(DroneModel))
def test_matches_jax(model):
    """The port and the JAX package parse one XML to the same values and
    write the same XML; their params hold the same float32 values."""
    raw = dict(_REGISTRY[model])
    text = urdf.write_drone_urdf(raw, name=model.value)
    assert text == jurdf.write_drone_urdf(raw, name=model.value)
    for src in (text, REFERENCE_STYLE_URDF):
        assert urdf.parse_drone_urdf(src) == jurdf.parse_drone_urdf(src)
        got = urdf.drone_params_from_urdf(src, device="cpu")
        ref = jurdf.drone_params_from_urdf(src)
        for field, a, b in zip(got._fields, got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)
            assert a.dtype == torch.float32

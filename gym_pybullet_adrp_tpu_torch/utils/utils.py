"""General utilities: wall-clock sync, CLI parsing, controller loading.

Counterpart of gym_pybullet_adrp_tpu/utils/utils.py (``get_quaternion_
from_euler`` :17, ``sync`` :31, ``str2bool`` :39, ``load_controller``
:49, ``map2pi`` :74). ``load_controller`` also takes the name of one of
the port's agents (``gym_pybullet_adrp_tpu_torch/agents/<name>.py``).
"""

import importlib
import importlib.util
import time
from pathlib import Path

import numpy as np

AGENTS = Path(__file__).resolve().parent.parent / "agents"


def get_quaternion_from_euler(roll, pitch, yaw):
    """Euler (extrinsic xyz) -> quat [x, y, z, w] (reference
    utils.py:20-43)."""
    qx = (np.sin(roll / 2) * np.cos(pitch / 2) * np.cos(yaw / 2)
          - np.cos(roll / 2) * np.sin(pitch / 2) * np.sin(yaw / 2))
    qy = (np.cos(roll / 2) * np.sin(pitch / 2) * np.cos(yaw / 2)
          + np.sin(roll / 2) * np.cos(pitch / 2) * np.sin(yaw / 2))
    qz = (np.cos(roll / 2) * np.cos(pitch / 2) * np.sin(yaw / 2)
          - np.sin(roll / 2) * np.sin(pitch / 2) * np.cos(yaw / 2))
    qw = (np.cos(roll / 2) * np.cos(pitch / 2) * np.cos(yaw / 2)
          + np.sin(roll / 2) * np.sin(pitch / 2) * np.sin(yaw / 2))
    return [qx, qy, qz, qw]


def sync(i, start_time, timestep):
    """Real-time pacing for GUI runs (reference utils.py:47-66)."""
    if timestep > 0.04 or i % (int(1 / (24 * timestep))) == 0:
        elapsed = time.time() - start_time
        if elapsed < (i * timestep):
            time.sleep(timestep * i - elapsed)


def str2bool(val):
    """Permissive CLI boolean (reference utils.py:70-91)."""
    if isinstance(val, bool):
        return val
    if val.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if val.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError("[ERROR] in str2bool(), a Boolean value is expected")


def load_controller(path):
    """The controller class of a module: a file path, or the name of one
    of the port's agents (``hardcoded``, ``rl_twogates``, ...). The module
    exposes it as ``Controller`` or defines exactly one subclass of the
    port's ``BaseController`` (reference utils.py:112-135)."""
    from ..agents.base import BaseController

    path = Path(path)
    if path.suffix != ".py" and (AGENTS / f"{path}.py").exists():
        path = AGENTS / f"{path}.py"
    if path.resolve().parent == AGENTS:
        module = importlib.import_module(
            f"gym_pybullet_adrp_tpu_torch.agents.{path.stem}")
    else:
        spec = importlib.util.spec_from_file_location(path.stem, path)
        if spec is None:
            raise FileNotFoundError(f"no controller module at {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    if hasattr(module, "Controller"):
        return module.Controller
    candidates = [v for v in vars(module).values()
                  if isinstance(v, type) and issubclass(v, BaseController)
                  and v is not BaseController
                  and v.__module__ == module.__name__]
    if len(candidates) != 1:
        raise RuntimeError(f"controller module {path} must define exactly "
                           f"one controller class (found {len(candidates)})")
    return candidates[0]


def map2pi(angle):
    """Wrap angle(s) to [-pi, pi) (reference utils.py:188-196)."""
    return (np.asarray(angle) + np.pi) % (2 * np.pi) - np.pi

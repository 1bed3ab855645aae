"""PyTorch/CUDA port of gym-pybullet-adrp-tpu.

The package mirrors the module paths of ``gym_pybullet_adrp_tpu`` so each
counterpart is easy to find, and keeps the JAX package's channel-major
``(C, T, 128)`` row blocks at its public functions. It imports ``torch``,
``numpy`` and, in its agents, ``scipy``: no JAX, flax, yaml or gymnasium.

The race and hover steps run as hand-written CUDA kernels on an NVIDIA
GPU (``ops/``, sources under ``csrc/``, built with ``nvcc`` at first use)
and as their plain PyTorch versions on CPU tensors.

The gym classes (envs/aviary.py, envs/race.py, envs/vector.py,
envs/race_vector.py) import gymnasium only when their spaces are read.
``register()`` registers them under the reference's five ids where
gymnasium is installed; unlike the JAX package, the port does not
register on import, which would import gymnasium.
"""

__version__ = "0.1.0"

ENV_IDS = {
    "ctrl-aviary-v0": ("aviary", "CtrlAviary"),
    "velocity-aviary-v0": ("aviary", "VelocityAviary"),
    "hover-aviary-v0": ("aviary", "HoverAviary"),
    "multihover-aviary-v0": ("aviary", "MultiHoverAviary"),
    "multi-race-aviary-v0": ("race", "MultiRaceAviary"),
}


def register():
    """Register the five env ids (reference gym_pybullet_adrp/__init__.py:
    5-28) on ``gymnasium.Env`` subclasses of the port's classes, so that
    ``gymnasium.make(id, device=...)`` builds them. Replaces an earlier
    registration of the ids (the JAX package registers the same ones)."""
    import importlib

    import gymnasium

    from .envs.aviary import gym_class

    for env_id, (module, name) in ENV_IDS.items():
        cls = getattr(importlib.import_module(f"{__name__}.envs.{module}"),
                      name)
        gymnasium.registry.pop(env_id, None)
        gymnasium.register(id=env_id, entry_point=gym_class(cls))

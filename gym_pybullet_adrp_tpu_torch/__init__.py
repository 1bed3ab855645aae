"""PyTorch/CUDA port of gym-pybullet-adrp-tpu's race path.

The package mirrors the module paths of ``gym_pybullet_adrp_tpu`` so each
counterpart is easy to find, and keeps the JAX package's channel-major
``(C, T, 128)`` row blocks at its public functions. It imports ``torch``
and ``numpy`` only: no JAX, flax, yaml or gymnasium.

The race step runs as hand-written CUDA kernels on an NVIDIA GPU
(``ops/race_window.py``, ``ops/race_step.py``, sources under ``csrc/``,
built with ``nvcc`` at first use) and as their plain PyTorch versions on
CPU tensors.
"""

__version__ = "0.1.0"

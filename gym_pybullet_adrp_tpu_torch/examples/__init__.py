"""The reference's example scripts on the port: each has ``run(...,
device=)`` like the JAX package's examples/ and runs as ``python -m
gym_pybullet_adrp_tpu_torch.examples.<name>`` with ``--device`` (the card
unless the caller asks for the CPU)."""

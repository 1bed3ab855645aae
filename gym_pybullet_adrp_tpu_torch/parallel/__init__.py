"""Multi-process training on ``torch.distributed``: process groups and
device meshes (``hosts``), data- and tensor-parallel PPO and the sharded
rollouts (``distributed``). Counterpart of ``gym_pybullet_adrp_tpu.
parallel``."""

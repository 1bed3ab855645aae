"""Joining a ``torch.distributed`` process group.

Counterpart of gym_pybullet_adrp_tpu/parallel/hosts.py
(``ensure_initialized`` :23, ``global_mesh`` :46, ``local_env_slice``
:52). JAX runs one controller per host over all its devices; here every
rank is a process of its own, started by ``torchrun`` (which sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``) or by a launcher that passes the address, world size and
rank to ``ensure_initialized``.

The backend: NCCL where every rank of the host has a card of its own
(the local world size at most ``torch.cuda.device_count()``), each rank
on ``cuda:{LOCAL_RANK}``; gloo otherwise, with CUDA tensors on the card
and CPU tensors on the CPU. NCCL refuses two ranks on one GPU, so ranks
that share one card run on gloo. A single-process run without a cluster
is a no-op pass-through, so scripts may call ``ensure_initialized()``
unconditionally.

Nothing here touches CUDA at import: a launcher may fork before it.
"""

import os

import torch
import torch.distributed as dist

AXIS = "dp"


def _local_world(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def choose_backend(world: int) -> str:
    """"nccl" when every local rank has a card of its own, else "gloo"."""
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and _local_world(world) <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` over the host's cards
    (ranks sharing one card all take it), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def ensure_initialized(coordinator_address=None, num_processes=None,
                       process_id=None, backend=None) -> bool:
    """Join the process group given by the arguments or by the standard
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://host:port``). Returns False, joining nothing, when neither
    names a cluster (a single process); True once joined, and True again
    on later calls. ``backend`` None picks one by ``choose_backend``."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = "127.0.0.1:29500"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    backend = backend or choose_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    print(f"[hosts] rank {rank} of {world}: backend {backend}", flush=True)
    return True


def mesh_device_type() -> str:
    """The device type of this group's meshes: "cuda" on NCCL; "cpu"
    on gloo, whose meshes only name ranks (the tensors may still live on
    the card)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh():
    """The data-parallel ``DeviceMesh`` ("dp") over every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_env_slice(n_envs_global: int):
    """(start, count) of this rank's slice of a globally sharded env
    batch."""
    per = n_envs_global // process_count()
    return process_index() * per, per

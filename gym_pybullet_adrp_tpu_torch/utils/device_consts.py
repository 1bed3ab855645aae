"""Small constant tensors, made once per value, dtype and device.

A step function that builds ``torch.tensor([...], device=dev)`` on every
call copies it from the host each time, and on the card such a copy
waits for the stream: the host then keeps step with the device. The
general race env's eager step (envs/race.py) takes its constants from
here instead. The tensors are shared: never write into one.
"""

import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values, dtype, device):
    """``values`` (a number, or a tuple of numbers or of tuples) as a
    tensor of ``dtype`` on ``device``, made at the first call."""
    return torch.tensor(values, dtype=dtype, device=device)

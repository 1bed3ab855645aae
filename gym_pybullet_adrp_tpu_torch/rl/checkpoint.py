"""Whole-train-state checkpoints, and the flax-msgpack policy artifacts
read and written without flax or msgpack.

Counterpart of gym_pybullet_adrp_tpu.rl.checkpoint (``save_checkpoint``
:19, ``restore_checkpoint`` :33, ``save_policy`` :47, ``load_policy``
:58), for the MLP and the pixel actor-critic alike.

``save_checkpoint`` writes a ``rl.ppo.TrainState`` with ``torch.save``
into ``<path>/<step>/train_state.pt`` (the JAX package writes orbax
step directories): the policy's ``state_dict``, every tensor of the
optimizer and env state and the episode bookkeeping, and the states of
both generators that draw, ``TrainState.rng`` (the learner's) and
``TrainState.env_rng`` (the env's, which the JAX package threads as a
key through its env state). ``restore_checkpoint`` rebuilds a train
state of the template's structure from them, so a resumed run draws the
numbers an unbroken one draws.

The shipped artifacts (``agents/*.msgpack``, ``results/*.msgpack``) are
``flax.serialization.to_bytes`` of a params tree: msgpack maps with str
keys whose leaves are the ext type 1 (ndarray) payload
``(shape, dtype name, C-order bytes)``, itself msgpack. The machine the
port runs on has neither flax nor msgpack, so ``msgpack_restore`` reads
that subset in pure Python: maps, arrays, str/bin, nil/bool/int/float,
and ext types 1 (ndarray) and 3 (numpy scalar). ``tests/test_torch_policy``
holds it equal to ``flax.serialization.msgpack_restore`` on every
artifact. ``msgpack_pack`` writes the same subset (maps with their keys
sorted, as in the shipped artifacts, and ndarrays), so a shipped
artifact read and written back gives its own bytes, and the JAX
package's ``load_policy`` reads what ``save_policy`` writes.
"""

import os
import shutil
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def sint(self, n):
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: self.bin(self.uint(1)),
            0xC5: lambda: self.bin(self.uint(2)),
            0xC6: lambda: self.bin(self.uint(4)),
            0xC7: lambda: self.ext(self.uint(1)),
            0xC8: lambda: self.ext(self.uint(2)),
            0xC9: lambda: self.ext(self.uint(4)),
            0xCA: lambda: struct.unpack(">f", self.take(4))[0],
            0xCB: lambda: struct.unpack(">d", self.take(8))[0],
            0xCC: lambda: self.uint(1), 0xCD: lambda: self.uint(2),
            0xCE: lambda: self.uint(4), 0xCF: lambda: self.uint(8),
            0xD0: lambda: self.sint(1), 0xD1: lambda: self.sint(2),
            0xD2: lambda: self.sint(4), 0xD3: lambda: self.sint(8),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.uint(1)),
            0xDA: lambda: self.str(self.uint(2)),
            0xDB: lambda: self.str(self.uint(4)),
            0xDC: lambda: self.array(self.uint(2)),
            0xDD: lambda: self.array(self.uint(4)),
            0xDE: lambda: self.map(self.uint(2)),
            0xDF: lambda: self.map(self.uint(4)),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n):
        return bytes(self.take(n))

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n):
        code = self.sint(1)
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        shape, dtype, buf = inner.obj()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode a flax ``to_bytes`` payload into nested dicts of numpy."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _pack_len(n, small, codes):
    """The header of an object of length ``n``: a fix-type byte below
    ``small``, else the shortest of the 1-, 2- or 4-byte length codes."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"msgpack object too long ({n})")


def msgpack_pack(obj) -> bytes:
    """Encode nested dicts (str keys, sorted), tuples/lists of ints and
    str, bytes and numpy arrays (ext type 1) as flax's msgpack does."""
    if isinstance(obj, dict):
        head = _pack_len(len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        return head + b"".join(msgpack_pack(k) + msgpack_pack(obj[k])
                               for k in sorted(obj))
    if isinstance(obj, (tuple, list)):
        head = _pack_len(len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        return head + b"".join(msgpack_pack(x) for x in obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _pack_len(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b
    if isinstance(obj, bytes):
        return _pack_len(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, int) and not isinstance(obj, bool):
        if 0 <= obj < 0x80:
            return bytes([obj])
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if 0 <= obj < 1 << (8 * width):
                return bytes([code]) + obj.to_bytes(width, "big")
        raise ValueError(f"msgpack_pack: unsupported int {obj}")
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        payload = msgpack_pack((tuple(arr.shape), arr.dtype.name,
                                arr.tobytes("C")))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = (bytes([fixext[n]]) if n in fixext
                else _pack_len(n, None, (0xC7, 0xC8, 0xC9)))
        return head + bytes([_EXT_NDARRAY]) + payload
    raise TypeError(f"msgpack_pack: unsupported type {type(obj)}")


def save_policy(path, net):
    """Write ``net`` (the port's ``ActorCritic`` or ``CnnActorCritic``)
    as a flax-msgpack policy artifact at ``path`` (creating its
    directory), which the JAX package's ``load_policy`` reads; returns
    the path."""
    from ..convert import flax_from_actor_critic, flax_from_cnn_actor_critic
    from ..models.policy import CnnActorCritic

    tree = (flax_from_cnn_actor_critic(net) if isinstance(net, CnnActorCritic)
            else flax_from_actor_critic(net))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_pack(tree))
    return path


def load_params(path):
    """The params tree of a flax-msgpack artifact, as numpy arrays."""
    return msgpack_restore(Path(path).read_bytes())


def load_policy(path, device="cuda", img=None):
    """The policy of a flax artifact on ``device`` (the card unless the
    caller asks for the CPU): an ``ActorCritic`` (tower widths taken from
    the artifact), or, where the tree has convolutions, a
    ``CnnActorCritic`` for frames of ``img`` = (height, width), which the
    caller must then give (the weights do not fix the frame size)."""
    from ..convert import actor_critic_from_flax, cnn_actor_critic_from_flax

    params = load_params(path)
    if "Conv_0" in params.get("params", params):
        if img is None:
            raise ValueError(f"{path}: a pixel policy; give its frame size "
                             "as img=(height, width)")
        return cnn_actor_critic_from_flax(params, *img).to(device)
    return actor_critic_from_flax(params).to(device)


# ---------------------------------------------------------------------------
# whole-train-state checkpoints

_STATE_FILE = "train_state.pt"


def _flatten(tree, out):
    """The leaves of ``tree`` in order: tensors, ints, floats and None as
    they are, an ``nn.Module`` as its ``state_dict``, a
    ``torch.Generator`` as its state."""
    if isinstance(tree, torch.nn.Module):
        out.append(tree.state_dict())
    elif isinstance(tree, torch.Generator):
        out.append(tree.get_state())
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flatten(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif tree is None or isinstance(tree, (torch.Tensor, int, float)):
        out.append(tree)
    else:
        raise TypeError(f"checkpoint: unsupported leaf {type(tree)}")
    return out


def _unflatten(template, leaves, device, name="train_state"):
    """A tree of ``template``'s structure from ``leaves`` (consumed from
    the front); modules and generators of the template are loaded in
    place and returned."""
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(leaves.pop(0))
        return template.to(device)
    if isinstance(template, torch.Generator):
        template.set_state(leaves.pop(0))
        return template
    if isinstance(template, (tuple, list)):
        items = [_unflatten(x, leaves, device, f"{name}[{i}]")
                 for i, x in enumerate(template)]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, device, f"{name}.{k}")
                for k in sorted(template)}
    leaf = leaves.pop(0)
    if isinstance(template, torch.Tensor):
        if (not isinstance(leaf, torch.Tensor) or leaf.shape != template.shape
                or leaf.dtype != template.dtype):
            raise ValueError(f"checkpoint: {name} does not fit the template "
                             f"({template.dtype} {tuple(template.shape)})")
        return leaf.to(device)
    return leaf


def _steps(path: Path):
    return sorted(int(p.name) for p in path.iterdir()
                  if p.name.isdigit() and (p / _STATE_FILE).exists())


def save_checkpoint(path, train_state, step: int, keep: int = 3):
    """Write checkpoint ``step`` of ``train_state`` (a ``rl.ppo.
    TrainState``) under ``path``, creating directories, and delete all
    but the ``keep`` newest; returns the step's directory."""
    path = Path(path).resolve()
    out = path / str(int(step))
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / (_STATE_FILE + ".tmp")
    torch.save({"step": int(step), "leaves": _flatten(train_state, [])},
               tmp)
    os.replace(tmp, out / _STATE_FILE)
    for old in _steps(path)[:-keep] if keep > 0 else []:
        shutil.rmtree(path / str(old))
    return out


def restore_checkpoint(path, template, step: Optional[int] = None,
                       device="cuda"):
    """(train_state, step): checkpoint ``step`` (the newest when None)
    under ``path``, in the structure of ``template`` (a fresh
    ``init_fn`` output, whose policy and generators are loaded in place),
    with its tensors on ``device``, the card unless the caller asks for
    the CPU. Raises ``FileNotFoundError`` when there is no checkpoint."""
    path = Path(path).resolve()
    steps = _steps(path) if path.is_dir() else []
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    f = path / str(int(step)) / _STATE_FILE
    if not f.exists():
        raise FileNotFoundError(f"no checkpoint {step} under {path}")
    data = torch.load(f, map_location="cpu", weights_only=True)
    leaves = list(data["leaves"])
    state = _unflatten(template, leaves, torch.device(device))
    if leaves:
        raise ValueError(f"{f}: {len(leaves)} leaves more than the "
                         "template holds")
    return state, data["step"]

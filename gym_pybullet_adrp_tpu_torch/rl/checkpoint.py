"""Read the flax-msgpack policy artifacts without flax or msgpack.

Counterpart of gym_pybullet_adrp_tpu.rl.checkpoint.load_policy (:58).
The shipped artifacts (``agents/*.msgpack``, ``results/*.msgpack``) are
``flax.serialization.to_bytes`` of a params tree: msgpack maps with str
keys whose leaves are the ext type 1 (ndarray) payload
``(shape, dtype name, C-order bytes)``, itself msgpack. The machine the
port runs on has neither flax nor msgpack, so ``msgpack_restore`` reads
that subset in pure Python: maps, arrays, str/bin, nil/bool/int/float,
and ext types 1 (ndarray) and 3 (numpy scalar). ``tests/test_torch_policy``
holds it equal to ``flax.serialization.msgpack_restore`` on every
artifact.
"""

import struct
from pathlib import Path

import numpy as np

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


def load_params(path):
    """The params tree of a flax-msgpack artifact, as numpy arrays."""
    return msgpack_restore(Path(path).read_bytes())


def load_policy(path, device="cpu"):
    """An ``ActorCritic`` with the weights of a flax ActorCritic artifact
    (tower widths taken from the artifact)."""
    from ..convert import actor_critic_from_flax

    return actor_critic_from_flax(load_params(path)).to(device)

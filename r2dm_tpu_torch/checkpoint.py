"""Read the JAX package's single-file msgpack checkpoints without flax.

``r2dm_tpu/checkpoint.py::save_checkpoint`` writes ``{cfg: JSON str, step,
weights, ema_weights, opt_state}`` through ``flax.serialization`` (msgpack).
This module decodes that format in pure Python, so a machine without flax or
``msgpack`` loads it. It handles the subset flax writes:

- nil, bool, ints of every width, float32/64, str, bin, array and map;
- ext type 1, an ndarray: a nested msgpack ``(shape, dtype name, C bytes)``;
- ext type 3, a numpy scalar (the same encoding, unpacked to a scalar);
- flax's ``__msgpack_chunked_array__`` dicts (arrays over 2^30 bytes).

Arrays come back as numpy arrays, except ``bfloat16`` ones, which numpy has
no dtype for: they come back as ``torch.bfloat16`` tensors, read through a
``uint16`` view. Anything else (ext type 2, the complex number; a timestamp)
raises.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self.ext(self.unpack(">b"), n)
        if t == 0xCA:
            return self.unpack(">f")
        if t == 0xCB:
            return self.unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[t - 0xCC])
        if 0xD4 <= t <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes):
    """Decode one msgpack object (the subset above)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _ndarray(payload: bytes):
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = unpackb(payload)
    if name == "bfloat16":
        u16 = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(u16.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    """Join a ``__msgpack_chunked_array__`` dict's flat chunks."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns for ``data``."""
    return _unchunk_tree(unpackb(data))


def load_checkpoint(path: str) -> dict[str, Any]:
    """A checkpoint of ``r2dm_tpu.checkpoint.save_checkpoint`` as
    ``{cfg: dict, weights, ema_weights, opt_state, global_step}``
    (r2dm_tpu/checkpoint.py:54-68). ``opt_state`` is decoded and returned
    as it is."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return {
        "cfg": json.loads(payload["cfg"]),
        "weights": payload["weights"],
        "ema_weights": payload["ema_weights"] or None,
        "opt_state": payload["opt_state"] or None,
        "global_step": int(payload["step"]),
    }

"""Read and write the JAX package's single-file msgpack checkpoints without
flax.

``r2dm_tpu/checkpoint.py::save_checkpoint`` writes ``{cfg: JSON str, step,
weights, ema_weights, opt_state}`` through ``flax.serialization`` (msgpack).
This module decodes that format in pure Python, so a machine without flax or
``msgpack`` loads it, and ``save_checkpoint`` writes it from a port's
``TrainState`` (``packb`` encodes the same subset: maps with str keys, ints,
floats, str, bytes, and ndarrays/tensors as ext 1). The decoder handles the
subset flax writes:

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
import os
import struct
from typing import Any

import numpy as np
import torch

from .utils.weights import from_jax, to_jax

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


# ----------------------------------------------------------------- writer
def _header(out: bytearray, n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form (``codes``; None where the type has no 8-bit form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
    elif n <= 0xFF and codes[0] is not None:
        out += bytes([codes[0], n])
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _array_payload(a) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes);
    a bfloat16 tensor through a uint16 view."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return packb([list(a.shape), "bfloat16", a.view(torch.uint16).numpy().tobytes()])
        a = a.numpy()
    a = np.asarray(a)
    return packb([list(a.shape), a.dtype.name, a.tobytes(order="C")])


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"msgpack: {obj} does not fit 64 bits")
        else:
            for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise OverflowError(f"msgpack: {obj} does not fit 64 bits")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys are str here, got {type(k).__name__}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` as msgpack (the subset above; ``unpackb`` and
    ``flax.serialization.msgpack_restore`` read it back)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def optax_opt_state(state) -> dict:
    """The state of AdamW in the layout optax gives ``make_optimizer``'s
    chain (clip, then adamw: scale_by_adam, add_decayed_weights,
    scale_by_schedule): ``{'0': {}, '1': {'0': {count, mu, nu}, '1': {},
    '2': {count}}}``, mu and nu in the flax params tree, the counts int32
    and equal to the updates done. Before the first update the moments are
    zeros. With ``state.accumulation_steps`` > 1 that state sits inside
    optax ``MultiSteps``' ``{mini_step, gradient_step, inner_opt_state,
    acc_grads, skip_state: {}}``, the running mean in the params tree."""
    mu, nu = {}, {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
    count = np.asarray(state.updates, np.int32)
    arch = state.model.architecture
    adam = {"0": {}, "1": {
        "0": {"count": count, "mu": to_jax(mu, arch)["params"], "nu": to_jax(nu, arch)["params"]},
        "1": {},
        "2": {"count": count},
    }}
    if state.accumulation_steps == 1:
        return adam
    acc = dict(zip((n for n, _ in state.model.named_parameters()), state.acc_grads))
    return {
        "mini_step": np.asarray(state.mini_step, np.int32),
        "gradient_step": count,
        "inner_opt_state": adam,
        "acc_grads": to_jax(acc, arch)["params"],
        "skip_state": {},
    }


def load_opt_state(state, stored: dict) -> None:
    """Put an optax-layout AdamW state (``optax_opt_state``'s, or the JAX
    package's ``make_optimizer`` state as a checkpoint holds it) into
    ``state.optimizer``, and set ``state.updates`` to its count; a
    ``MultiSteps`` state also sets ``state.mini_step`` and the running mean.
    A layout that does not match ``state.accumulation_steps`` raises, as
    flax's ``from_state_dict`` does in the JAX trainer."""
    multi = "inner_opt_state" in stored
    if multi != (state.accumulation_steps > 1):
        raise ValueError(
            f"the checkpoint's optimizer state is {'an optax MultiSteps' if multi else 'a plain AdamW'} state, "
            f"but this run accumulates over gradient_accumulation_steps={state.accumulation_steps}: "
            "resume with the setting the checkpoint was written with"
        )
    adam = (stored["inner_opt_state"] if multi else stored)["1"]["0"]
    count = int(np.asarray(adam["count"]))
    arch = state.model.architecture
    mu = from_jax({"params": adam["mu"]}, arch)
    nu = from_jax({"params": adam["nu"]}, arch)
    acc = from_jax({"params": stored["acc_grads"]}, arch) if multi else None
    for i, (name, p) in enumerate(state.model.named_parameters()):
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype),
        }
        if multi:
            state.acc_grads[i].copy_(acc[name])
    state.updates = count
    if multi:
        state.mini_step = int(np.asarray(stored["mini_step"]))


def write_checkpoint(path: str, cfg: dict, weights: dict, ema_weights=None, opt_state=None, step: int = 0) -> str:
    """Write the JAX package's checkpoint (r2dm_tpu/checkpoint.py:29-51):
    ``{cfg: JSON, step, weights, ema_weights, opt_state}``, the weights as
    flax ``{'params', 'buffers'}`` trees of arrays; a missing part is an
    empty map, as there. Atomic: the bytes go to ``path.tmp``, which then
    replaces ``path``."""
    payload = {
        "cfg": json.dumps(cfg),
        "step": int(step),
        "weights": weights,
        "ema_weights": ema_weights if ema_weights is not None else {},
        "opt_state": opt_state if opt_state is not None else {},
    }
    data = packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, cfg: dict, state) -> str:
    """Write ``state`` (a ``training.TrainState``) with ``write_checkpoint``:
    the weights and EMA weights of its (unwrapped) modules in the flax
    ``{'params', 'buffers': {'coords'}}`` layout, the optimizer state in
    optax's (``optax_opt_state``)."""
    arch = state.model.architecture
    return write_checkpoint(
        path, cfg, to_jax(state.model.state_dict(), arch),
        ema_weights=to_jax(state.ema_model.state_dict(), arch),
        opt_state=optax_opt_state(state), step=state.step,
    )

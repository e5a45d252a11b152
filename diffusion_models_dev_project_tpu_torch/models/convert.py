"""Flax msgpack checkpoints -> the port's `UNetModel.state_dict()`.

`load_flax_msgpack` reads a file written by `flax.serialization.msgpack_serialize`
(the shipped `checkpoints/*.msgpack.npz`) with a small msgpack decoder in
pure Python and numpy, so neither flax nor the `msgpack` package is needed.
Arrays arrive as msgpack extension type 1 whose payload is itself msgpack:
`(shape, dtype name, raw bytes)`.

`params_from_flax` maps the nested parameter tree onto the port's module
names, which follow the flax tree: fp16/bf16 storage becomes fp32 masters,
dense kernels (I, O) and 1x1 conv kernels (1, 1, I, O) become `nn.Linear`
weights (O, I), 3x3 conv kernels stay HWIO, and GroupNorm `scale` becomes
`weight`.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_flax_msgpack", "unpack_msgpack", "params_from_flax"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf: bytes, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw              # str payloads stay bytes (flax packs arrays so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def str_(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.sint(1)
        return _ext(code, bytes(self.take(n)))

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):                       # ext 8/16/32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:                             # uint 8..64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                             # int 8..64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:                             # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                       # str 8/16/32
            return self.str_(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                             # array 16/32
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):                             # map 16/32
            return self.map_(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def unpack_msgpack(buf: bytes, raw: bool = False) -> Any:
    reader = _Reader(buf, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, data = unpack_msgpack(payload, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":        # numpy has no bfloat16: widen the bits to fp32
        bits = np.frombuffer(data, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = unpack_msgpack(payload)
        return complex(re, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree):
    """Undo flax's chunking of arrays above 1 GiB (never hit at our sizes)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays, as `flax.serialization.msgpack_restore`."""
    with open(path, "rb") as f:
        return _unchunk(unpack_msgpack(f.read()))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state_dict (fp32 tensors on the CPU) from a flax `params`
    tree of the JAX `UNetModel`."""
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        if a.dtype.kind == "f":                           # fp16 storage -> fp32 masters
            a = a.astype(np.float32)
        *mods, name = path
        if name == "kernel":
            if a.ndim == 2:                                # Dense (I, O)
                a = a.T
            elif a.ndim == 4 and a.shape[:2] == (1, 1):    # 1x1 conv (1, 1, I, O)
                a = a.reshape(a.shape[2:]).T
            elif a.ndim != 4 or a.shape[:2] != (3, 3):
                raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[".".join([*mods, name])] = torch.from_numpy(np.array(a))   # a writable copy
    return out

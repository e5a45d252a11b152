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
`weight`.  `lora_from_flax` maps the JAX `lora` collection (LoRA `down` and
`up` leaves) onto the port's `<layer>_lora` modules the same way.

The way back, for the trainer's exports: `flax_from_params` is the inverse
of `params_from_flax`, and `save_flax_msgpack` writes a tree as
`flax.serialization.msgpack_serialize` does (keys sorted at every level, as
`jax.tree_util` leaves them; arrays as extension type 1), with a small
msgpack encoder in pure Python.  The result is a file that the JAX
package's `factory._load_params` and `msgpack_restore` read.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["flax_from_params", "load_flax_msgpack", "lora_from_flax", "pack_msgpack",
           "params_from_flax", "save_flax_msgpack", "unpack_msgpack"]

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


def lora_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's LoRA parameters (fp32 tensors on the CPU) from the JAX
    `lora` collection: 3x3 `down` kernels stay HWIO, 1x1 kernels (1, 1, I, O)
    and dense (I, O) leaves become (O, I)."""
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name not in ("down", "up") or not mods or not mods[-1].endswith("_lora"):
            raise ValueError(f"unexpected LoRA leaf {'/'.join(path)}")
        if a.ndim == 4 and a.shape[:2] == (1, 1):
            a = a.reshape(a.shape[2:]).T
        elif a.ndim == 2:
            a = a.T
        elif a.ndim != 4 or a.shape[:2] != (3, 3):
            raise ValueError(f"unexpected LoRA leaf {'/'.join(path)} {a.shape}")
        out[".".join([*mods, name])] = torch.from_numpy(np.array(a))
    return out


def flax_from_params(state: Dict[str, Any], dtype=None) -> Dict[str, Any]:
    """The flax `params` tree (nested dict of numpy arrays, in `dtype` or as
    given) of the port's UNet state_dict `state`: the inverse of
    `params_from_flax`.  1-D weights are GroupNorm `scale`s, 4-D weights 3x3
    kernels (HWIO as they are), 2-D weights dense kernels (O, I) -> (I, O),
    and for a ResBlock's `skip` the 1x1 conv kernel (1, 1, I, O)."""
    out: Dict[str, Any] = {}
    for name, value in state.items():
        *mods, leaf = name.split(".")
        if not mods or any(m.endswith("_lora") for m in mods):
            raise ValueError(f"not a parameter of the flax params tree: {name}")
        a = value.detach().float().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif a.ndim == 2:
                a = a.T
                if mods[-1] == "skip":
                    a = a.reshape(1, 1, *a.shape)
                leaf = "kernel"
            elif a.ndim == 4 and a.shape[:2] == (3, 3):
                leaf = "kernel"
            else:
                raise ValueError(f"unexpected weight {name} {a.shape}")
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {name}")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
    return out


def _pack_header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(codes[0])
        out += n.to_bytes(2, "big")
    else:
        out.append(codes[1])
        out += n.to_bytes(4, "big")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += v.to_bytes(1, "big", signed=True)
        return
    for size, code in ((1, 0xCC), (2, 0xCD), (4, 0xCE), (8, 0xCF)) if v > 0 else (
            (1, 0xD0), (2, 0xD1), (4, 0xD2), (8, 0xD3)):
        try:
            body = v.to_bytes(size, "big", signed=v < 0)
        except OverflowError:
            continue
        out.append(code)
        out += body
        return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_blob(out: bytearray, data: bytes, codes) -> None:
    n = len(data)
    for limit, code, size in zip((0xFF, 0xFFFF, 0xFFFFFFFF), codes, (1, 2, 4)):
        if n <= limit:
            out.append(code)
            out += n.to_bytes(size, "big")
            out += data
            return
    raise ValueError("msgpack: blob too long")


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        if len(data) < 32:
            out.append(0xA0 | len(data))
            out += data
        else:
            _pack_blob(out, data, (0xD9, 0xDA, 0xDB))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _pack_blob(out, bytes(v), (0xC4, 0xC5, 0xC6))
    elif isinstance(v, dict):
        _pack_header(out, len(v), 0x80, 15, (0xDE, 0xDF))
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    elif isinstance(v, (list, tuple)):
        _pack_header(out, len(v), 0x90, 15, (0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        if a.dtype.hasobject:
            raise ValueError("msgpack: object arrays are not supported")
        payload = bytearray()
        _pack(payload, (tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            for limit, head, size in ((0xFF, 0xC7, 1), (0xFFFF, 0xC8, 2), (0xFFFFFFFF, 0xC9, 4)):
                if n <= limit:
                    out.append(head)
                    out += n.to_bytes(size, "big")
                    break
            else:
                raise ValueError("msgpack: array too large for one extension")
        out += code.to_bytes(1, "big", signed=True)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def pack_msgpack(tree) -> bytes:
    """msgpack bytes of nested dicts, lists, numbers, strings and numpy
    arrays, as `msgpack.packb(..., use_bin_type=True)` with flax's array
    extension gives them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_flax_msgpack(tree: Dict[str, Any], path: str) -> str:
    """Write the nested dict of numpy arrays `tree` to `path` in
    `flax.serialization.msgpack_serialize`'s format, keys sorted as the JAX
    package's exports have them; returns `path`."""
    data = pack_msgpack(_sorted_tree(tree))
    with open(path, "wb") as f:
        f.write(data)
    return path

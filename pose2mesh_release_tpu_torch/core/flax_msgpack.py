"""A reader of flax's msgpack checkpoints (`flax.serialization.msgpack_serialize`),
in plain Python: the JAX package's `.ckpt` files, read without JAX, flax or
the msgpack package.

The MessagePack format (https://github.com/msgpack/msgpack/blob/master/spec.md):
nil, bool, the int and float families, str, bin, array, map and ext.  flax
writes its leaves as ext types (`flax.serialization._MsgpackExtType`):

  1 ndarray         msgpack of (shape, dtype name, C-order bytes)
  2 native_complex  msgpack of (real, imag)
  3 npscalar        an ndarray of shape (), returned as its numpy scalar

and splits an array above its `MAX_CHUNK_SIZE` (2**30 bytes) into a dict
{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0": ...}}
(`_chunk_array_leaves_in_place`), which is joined back here as flax's
`msgpack_restore` joins it.  `restore(blob)` returns what `msgpack_restore`
returns: dicts, lists, str, bytes, int, float, bool, None, complex, numpy
arrays and numpy scalars; a `bfloat16` array (which numpy cannot hold) is a
torch bfloat16 tensor.  Any other ext code, a malformed byte and a
truncated input raise ValueError.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["restore"]

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: first byte -> (struct format, size)
_SCALARS = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# lengths of str / bin / array / map / ext: first byte -> (kind, length format)
_SIZED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
# fixext 1 / 2 / 4 / 8 / 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes, ext_hook, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return self.take(n) if self.raw else bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        raise ValueError(f"malformed msgpack: byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int):
        return bytes(self.take(n)) if self.raw else str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(key).__name__}: flax "
                                 "writes str keys")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        return self.ext_hook(code, self.take(n))


def _unpackb(data, ext_hook=None, raw: bool = False) -> Any:
    """One msgpack object of `data` (bytes or a memoryview), which it must
    fill exactly; raw: str objects as bytes, bin objects as memoryviews
    into `data` (an ndarray's buffer, copied once into its array)."""
    def refuse(code, _payload):
        raise ValueError(f"msgpack ext type {code} inside an ext payload")

    reader = _Reader(data, ext_hook or refuse, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


def _ndarray(payload: memoryview):
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C-order bytes)."""
    header = _unpackb(payload, raw=True)
    if not (isinstance(header, list) and len(header) == 3):
        raise ValueError("malformed ndarray ext: not (shape, dtype, buffer)")
    shape, name, buf = header
    shape, name = tuple(int(s) for s in shape), name.decode()
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.int16).copy()
        if flat.size != int(np.prod(shape)):
            raise ValueError(f"bfloat16 ndarray of shape {shape} with {flat.size} elements")
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr.reshape(shape, order="C").copy()


def _ext_hook(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_COMPLEX:
        pair = _unpackb(payload)
        if not (isinstance(pair, list) and len(pair) == 2):
            raise ValueError("malformed complex ext: not (real, imag)")
        return complex(pair[0], pair[1])
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack ext type {code}: flax writes 1 (ndarray), 2 (complex) "
                     "and 3 (numpy scalar)")


def _dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d: dict):
    """flax's `_unchunk`: the chunks of one array, joined and reshaped."""
    shape = _dict_to_tuple(d["shape"])
    chunks = _dict_to_tuple(d["chunks"])
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's `_unchunk_array_leaves_in_place`: chunked arrays in nested
    dicts (not inside lists, as flax writes them only there)."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def restore(blob: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore(blob)` returns."""
    return _unchunk_leaves(_unpackb(blob, _ext_hook))

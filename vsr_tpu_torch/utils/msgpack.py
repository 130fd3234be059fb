"""A msgpack decoder for the checkpoints of ``vsr_tpu``: the port's
counterpart of ``flax.serialization.msgpack_restore``, in plain Python.

It decodes every msgpack type that flax writes: maps, arrays, strings, bin,
ints, floats, nil and bool, and flax's ext types ``ndarray = 1`` (a packed
``(shape, dtype name, bytes)``), ``native_complex = 2`` (a packed ``(real,
imag)``) and ``npscalar = 3`` (an ndarray payload of shape ``()``). Arrays
come back as numpy arrays, except a ``bfloat16`` one, which numpy has no type
for: that one comes back as a ``torch.bfloat16`` tensor. Flax splits an
array of more than ``MAX_CHUNK_SIZE`` bytes into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dict;
:func:`restore` joins such dicts back into one array.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# Fixed-width types: first byte -> (struct format, size).
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# Length-prefixed types: first byte -> (kind, struct format of the length).
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """One pass over a msgpack buffer. ``raw``: strings stay ``bytes`` (as
    flax reads the inner ndarray payload)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

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
            return self.string(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.string(n)
            if kind == "ext":
                return self.ext(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def string(self, n: int):
        s = bytes(self.take(n))
        return s if self.raw else s.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_NATIVE_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code}")


def _ndarray(payload: bytes):
    """flax's ndarray payload -> a numpy array (a bfloat16 one: a
    ``torch.bfloat16`` tensor), writable, C order."""
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        flat = (torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
                if buffer else torch.empty(0, dtype=torch.bfloat16))
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        shape).copy()


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object; trailing bytes are an error."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked-array dicts back into arrays, anywhere in the
    tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts, lists and
    leaves that ``msgpack_serialize`` wrote, chunked arrays joined."""
    return _unchunk(unpackb(data))

"""A msgpack decoder and encoder for the checkpoints of ``vsr_tpu``: the
port's counterparts of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize``, in plain Python.

It decodes every msgpack type that flax writes: maps, arrays, strings, bin,
ints, floats, nil and bool, and flax's ext types ``ndarray = 1`` (a packed
``(shape, dtype name, bytes)``), ``native_complex = 2`` (a packed ``(real,
imag)``) and ``npscalar = 3`` (an ndarray payload of shape ``()``). Arrays
come back as numpy arrays, except a ``bfloat16`` one, which numpy has no type
for: that one comes back as a ``torch.bfloat16`` tensor. Flax splits an
array of more than ``MAX_CHUNK_SIZE`` bytes into a
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dict;
:func:`restore` joins such dicts back into one array.

:func:`serialize` writes the bytes that flax's ``msgpack_serialize`` writes
for the same tree (msgpack-python's ``packb(..., strict_types=True)``: the
smallest encoding of each int, floats as doubles, every map's keys sorted,
as flax's copy of the tree through ``jax.tree_util`` sorts them;
numpy arrays and ``torch.bfloat16`` tensors as the ndarray ext, numpy
scalars as the npscalar ext, arrays over ``MAX_CHUNK_SIZE`` bytes chunked
inside dicts), so a file the port writes can be byte-equal to flax's.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE

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


# ------------------------------------------------------------------ encoder


def _header(n: int, fix: tuple[int, int] | None, sized: tuple) -> bytes:
    """The length header of a str / bin / array / map of ``n`` items:
    the fix form ``(base, limit)`` below its limit, else the first sized
    form ``(byte, struct format, limit)`` that holds ``n``."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for byte, fmt, limit in sized:
        if n < limit:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


_STR = ((0xa0, 32), ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16),
                     (0xdb, ">I", 1 << 32)))
_BIN = (None, ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
               (0xc6, ">I", 1 << 32)))
_ARRAY = ((0x90, 16), ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)))
_MAP = ((0x80, 16), ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)))
_INTS = ((0, 0x80, None, None), (-0x20, 0, None, None),
         (0x80, 0x100, 0xcc, ">B"), (-0x80, 0, 0xd0, ">b"),
         (0x100, 0x10000, 0xcd, ">H"), (-0x8000, 0, 0xd1, ">h"),
         (0x10000, 1 << 32, 0xce, ">I"), (-(1 << 31), 0, 0xd2, ">i"),
         (1 << 32, 1 << 64, 0xcf, ">Q"), (-(1 << 63), 0, 0xd3, ">q"))


def _int(v: int) -> bytes:
    for low, high, byte, fmt in _INTS:  # msgpack-python's order of checks
        if low <= v < high:
            return (struct.pack(">b", v) if byte is None
                    else bytes([byte]) + struct.pack(fmt, v))
    raise OverflowError("Integer value out of range")


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xff:
        head = bytes([0xc7, n])
    elif n <= 0xffff:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, C-order
    bytes))``."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError(f"only bfloat16 tensors are written as flax "
                            f"arrays, got {arr.dtype}")
        shape, name = list(arr.shape), "bfloat16"
        data = arr.detach().cpu().contiguous().view(torch.int16).numpy(
            ).tobytes()
    else:
        shape, name, data = list(arr.shape), arr.dtype.name, arr.tobytes("C")
    return (_header(3, *_ARRAY) + _header(len(shape), *_ARRAY)
            + b"".join(_int(int(d)) for d in shape) + _pack(name)
            + _header(len(data), *_BIN) + data)


def _pack(obj: Any) -> bytes:
    kind = type(obj)
    if obj is None:
        return b"\xc0"
    if kind is bool:
        return b"\xc3" if obj else b"\xc2"
    if kind is int:
        return _int(obj)
    if kind is float:
        return b"\xcb" + struct.pack(">d", obj)
    if kind in (bytes, bytearray):
        return _header(len(obj), *_BIN) + bytes(obj)
    if kind is str:
        data = obj.encode("utf-8")
        return _header(len(data), *_STR) + data
    if kind is list:
        return _header(len(obj), *_ARRAY) + b"".join(map(_pack, obj))
    if kind is dict:
        return _header(len(obj), *_MAP) + b"".join(
            _pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray) or isinstance(obj, torch.Tensor):
        return _ext(EXT_NDARRAY, _ndarray_bytes(obj))
    if isinstance(obj, np.generic):
        return _ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    if kind is complex:
        return _ext(EXT_NATIVE_COMPLEX,
                    _header(2, *_ARRAY) + _pack(obj.real) + _pack(obj.imag))
    raise TypeError(f"Cannot serialize {obj!r}")


def _nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size() if isinstance(
        leaf, torch.Tensor) else leaf.size * leaf.dtype.itemsize


def _chunked(arr) -> dict:
    """flax's ``_chunk``: ``{"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": ...}}``."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _sorted(tree: Any) -> Any:
    """A copy with every dict's keys sorted, in lists too (flax copies the
    tree with ``jax.tree_util.tree_map``, which sorts them)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _chunk_leaves(tree: Any) -> Any:
    """Chunk the oversized arrays that are dict values (flax looks only
    there)."""
    if isinstance(tree, dict):
        return {k: (_chunked(v) if isinstance(v, (np.ndarray, torch.Tensor))
                    and _nbytes(v) > MAX_CHUNK_SIZE else _chunk_leaves(v))
                for k, v in tree.items()}
    return tree


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return _pack(_chunk_leaves(_sorted(tree)))

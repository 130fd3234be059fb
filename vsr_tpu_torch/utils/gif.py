"""A GIF89a writer for greyscale frame sequences (the predictors' per-slice
animations), in pure Python: the port imports neither ``imageio`` nor
``PIL``.

The file holds a global palette of the 256 greys, the looping extension and
one LZW-compressed image per frame, so a decoder gives back the frames' grey
values exactly.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Sequence

import numpy as np

_MIN_CODE_SIZE = 8
_CLEAR, _END = 1 << _MIN_CODE_SIZE, (1 << _MIN_CODE_SIZE) + 1
_MAX_CODES = 4096  # codes are at most 12 bits wide


def lzw_encode(pixels: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit ``pixels``: a clear code first, the
    table reset by another clear code when it is full, the end code last;
    codes packed least significant bit first."""
    out = bytearray()
    acc = bits = 0
    size = _MIN_CODE_SIZE + 1
    next_code = _END + 1
    table: dict[int, int] = {}

    def emit(code: int) -> None:
        nonlocal acc, bits
        acc |= code << bits
        bits += size
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8

    emit(_CLEAR)
    if pixels:
        prefix = pixels[0]
        for k in pixels[1:]:
            key = (prefix << 8) | k
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            emit(prefix)
            prefix = k
            if next_code < _MAX_CODES:
                table[key] = next_code
                # The decoder, one entry behind, widens after this code.
                if next_code == 1 << size and size < 12:
                    size += 1
                next_code += 1
            else:
                emit(_CLEAR)
                table = {}
                size = _MIN_CODE_SIZE + 1
                next_code = _END + 1
        emit(prefix)
    emit(_END)
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """``data`` cut into GIF data sub-blocks (a length byte, at most 255
    bytes), closed by the empty block."""
    parts = []
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        parts.append(bytes([len(chunk)]) + chunk)
    parts.append(b"\x00")
    return b"".join(parts)


def write_gif(path: str | Path, frames: Sequence[np.ndarray],
              duration: float = 0.1) -> None:
    """Write ``frames`` (equal-sized ``(H, W)`` uint8 arrays) as a looping
    greyscale GIF89a with ``duration`` seconds per frame."""
    frames = [np.ascontiguousarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w):
            raise ValueError(f"write_gif takes equal-sized (H, W) uint8 "
                             f"frames, got {f.dtype} {f.shape}")
    palette = bytes(v for grey in range(256) for v in (grey, grey, grey))
    delay = max(int(round(duration * 100)), 0)  # hundredths of a second
    parts = [
        b"GIF89a",
        # Logical screen: a global colour table of 2^(7+1) entries.
        struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette,
        b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00",
    ]
    for f in frames:
        parts += [
            b"\x21\xF9\x04" + struct.pack("<BHB", 0, delay, 0) + b"\x00",
            b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0),
            bytes([_MIN_CODE_SIZE]), _sub_blocks(lzw_encode(f.tobytes())),
        ]
    parts.append(b"\x3B")
    Path(path).write_bytes(b"".join(parts))

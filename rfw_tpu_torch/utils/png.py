"""A PNG encoder on the standard library (zlib + struct).

Frames leave the renderer as (H, W, 4) uint8 RGBA arrays; this writes them
as 8-bit PNGs with no filter, so the port needs no imaging package to save
or stream a frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type by channel count: grey, grey + alpha, RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(frame, level: int = 6) -> bytes:
    """(H, W), (H, W, 1-4) uint8 array -> PNG bytes."""
    a = np.asarray(frame)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG frames are uint8, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"{c} channels: expected 1-4")
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type None on every scanline
    rows[:, 1:] = a.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path, frame, level: int = 6) -> None:
    """Write `frame` (see `encode_png`) to `path`."""
    data = encode_png(frame, level)
    with open(path, "wb") as f:
        f.write(data)

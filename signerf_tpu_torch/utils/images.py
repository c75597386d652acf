"""PNG output and PNG header reads with the standard library only.

The render path writes its images here, so it needs neither Pillow nor a
compiled codec. The [0, 1] -> uint8 rule (NaN -> 0, +inf -> 1, clip,
x 255, truncate) is the one of `signerf_tpu/utils/images.py`, so both
packages write the same bytes of pixel data for the same array.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def to_uint8(arr) -> np.ndarray:
    """float/bool [H, W, C] in [0, 1] -> uint8."""
    a = np.asarray(arr)
    if a.dtype == bool:
        a = a.astype(np.float32)
    a = np.nan_to_num(a, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_array_png(arr, path, compress_level: int = 1) -> None:
    """Write a float [H, W], [H, W, 1] (gray) or [H, W, 3] (RGB) array in
    [0, 1] as an 8-bit PNG."""
    a = to_uint8(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.ndim == 2:
        color_type, channels = 0, 1
    elif a.ndim == 3 and a.shape[-1] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"cannot write an array of shape {a.shape} as PNG")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = a.reshape(h, w * channels)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(
        _PNG_MAGIC
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
        + _chunk(b"IEND", b"")
    )


def png_dims(path) -> Optional[Tuple[int, int]]:
    """(width, height) from a PNG's IHDR without decoding; None if the file
    is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_MAGIC or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", head[16:24])

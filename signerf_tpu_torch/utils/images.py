"""PNG writing and reading with the standard library only.

The render path writes its images here and the training path reads its
dataset here, so neither needs Pillow nor a compiled codec (the decoder
takes 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA with all five row
filters). Other image formats go through Pillow when it is installed. The [0, 1] -> uint8 rule (NaN -> 0, +inf -> 1, clip,
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


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> channels


def _unfilter_sequential(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows, which depend on the byte to the left."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] with C = 1 (gray), 2 (gray + alpha),
    3 (RGB) or 4 (RGBA). Raises for bit depths other than 8, palettes and
    interlacing."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, interlace {interlace}): "
            "the reader takes 8-bit non-interlaced gray, gray+alpha, RGB and RGBA"
        )
    ch = _CHANNELS[color]
    stride = w * ch
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (stride + 1)]
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along the row, mod 256
            cur = line.reshape(w, ch).cumsum(0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _unfilter_sequential(ftype, line, prev, ch)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, ch)


def _read_pixels(path) -> np.ndarray:
    """uint8 [H, W, C] of a PNG (own decoder) or, through Pillow when it is
    installed, of any other image format (RGB)."""
    path = Path(path)
    data = path.read_bytes()
    if data[:8] == _PNG_MAGIC:
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"{path}: not a PNG, and Pillow is not installed to read it"
        ) from exc
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def load_rgb(path) -> np.ndarray:
    """uint8 [H, W, 3]; gray is replicated and alpha dropped, as Pillow's
    `convert("RGB")` does."""
    a = _read_pixels(path)
    if a.shape[-1] in (1, 2):
        return np.repeat(a[..., :1], 3, axis=-1)
    return np.ascontiguousarray(a[..., :3])


def load_gray(path) -> np.ndarray:
    """uint8 [H, W] luminance with Pillow's `convert("L")` integer formula."""
    a = _read_pixels(path)
    if a.shape[-1] in (1, 2):
        return a[..., 0]
    rgb = a[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


# Pillow <-> array <-> base64, for the remote SD Web UI client only; Pillow
# is imported inside each call (the port does not need it otherwise). The
# same conversions as `signerf_tpu/utils/images.py`.


def array_to_image(arr):
    """float/bool [H, W, 1|3] in [0, 1] -> PIL image ('L' for one channel)."""
    from PIL import Image

    a = to_uint8(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        return Image.fromarray(a[..., 0], mode="L")
    if a.ndim == 2:
        return Image.fromarray(a, mode="L")
    return Image.fromarray(a, mode="RGB")


def image_to_array(img) -> np.ndarray:
    """PIL image -> float32 [H, W, C] in [0, 1]; 'L' gets a channel axis, alpha is dropped."""
    a = np.asarray(img, dtype=np.float32) / 255.0
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] == 4:
        a = a[..., :3]
    return a


def image_to_base64(img, fmt: str = "PNG") -> str:
    import base64
    import io

    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def base64_to_image(data: str):
    import base64
    import io

    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(data)))

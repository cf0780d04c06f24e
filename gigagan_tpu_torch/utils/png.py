"""PNG files with the standard library alone (``zlib``, ``struct``): the
card's machine has no PIL.

``encode_png`` writes an 8-bit grey, RGB or RGBA image (no filter, one
zlib stream); ``decode_png`` reads 8-bit grey, grey + alpha, RGB and RGBA
images, non-interlaced, with every filter type (None, Sub, Up, Average,
Paeth), from any number of IDAT chunks.  ``read_image`` reads such a PNG,
and any other image file through PIL, imported there and only there.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels (8-bit samples)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def encode_png(array) -> bytes:
    """An 8-bit PNG of a (h, w) grey, (h, w, 3) RGB or (h, w, 4) RGBA uint8
    array."""
    h, w = array.shape[:2]
    channels = 1 if array.ndim == 2 else array.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.ascontiguousarray(array).reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


class UnsupportedPNG(ValueError):
    """A PNG this reader does not decode (another bit depth, a palette,
    interlacing)."""


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, w·bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1)
            cur &= 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: left to right
            cur = np.empty(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b = prev[x]
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} on row {y}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG → uint8 (h, w, c), c = 1 (grey), 2
    (grey + alpha), 3 (RGB) or 4 (RGBA).  Raises ``UnsupportedPNG`` for
    other PNGs and ``ValueError`` for a damaged one."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:
                                          pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise UnsupportedPNG(f"bit depth {depth}, colour type {color}, "
                             f"interlace {interlace}")
    c = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return pixels.reshape(h, w, c)


def read_image(path) -> np.ndarray:
    """An image file → float32 (h, w, 3) RGB in [0, 1]: grey repeated,
    alpha dropped (as PIL's ``convert("RGB")``).  8-bit PNGs are decoded
    here; other files need PIL."""
    data = Path(path).read_bytes()
    try:
        pixels = decode_png(data)
    except (UnsupportedPNG, ValueError) as e:
        if data.startswith(SIGNATURE) and not isinstance(e, UnsupportedPNG):
            raise
        try:
            from PIL import Image
        except ImportError as err:
            raise ImportError(
                f"PIL is required to read {path} (only 8-bit PNGs are read "
                "without it)") from err
        with Image.open(path) as img:
            pixels = np.asarray(img.convert("RGB"))
    if pixels.shape[-1] in (1, 2):
        pixels = np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., :3].astype(np.float32) / 255.0

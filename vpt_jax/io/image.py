"""Image I/O: PNG read/write for rendered frames and environment maps.

The codec is numpy + stdlib ``zlib``: it writes 8-bit RGB/RGBA with filter
0 and reads 8-bit grayscale/RGB/RGBA (with or without alpha) under any of
the five PNG row filters, which covers what this program writes and what
image editors save by default.  Palette, 16-bit and interlaced files are
rejected with a clear error.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> channels, for the 8-bit non-palette types
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def to_uint8(image, flip: bool = True) -> np.ndarray:
    """HDR/display float image (H, W, 3|4) → uint8 RGB, top-down rows.

    Render images are bottom-up (OpenGL convention, row 0 = bottom); PNG rows
    are top-down, hence the default flip."""
    arr = np.asarray(image)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    if flip:
        arr = arr[::-1]
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels) -> bytes:
    """(H, W, 3|4) uint8 top-down rows → PNG bytes (filter 0 on every
    row)."""
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 top-down rows, C = the file's channel
    count (1 grey, 2 grey+alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit "
                         "non-palette, non-interlaced only)")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            # average and Paeth depend on the decoded left neighbour, so
            # they run one pixel at a time along the row
            cur = np.empty(stride, np.int32)
            left = np.zeros(c, np.int32)
            up_left = np.zeros(c, np.int32)
            for x in range(0, stride, c):
                up = prev[x:x + c]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, up_left)
                left = (line[x:x + c] + pred) & 0xFF
                cur[x:x + c] = left
                up_left = up
        else:
            raise ValueError(f"bad PNG filter type {ftype} on row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def write_png(path, image, flip: bool = True):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(to_uint8(image, flip=flip)))


def read_image(path, flip: bool = True) -> np.ndarray:
    """Read a PNG file → float32 (H, W, 4) RGBA in [0, 1], bottom-up."""
    px = decode_png(Path(path).read_bytes()).astype(np.float32) / 255.0
    c = px.shape[-1]
    if c <= 2:                       # grey (+ alpha) → RGB (+ alpha)
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=-1),
                             px[..., 1:]], axis=-1)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.ones_like(px[..., :1])], axis=-1)
    if flip:
        px = px[::-1]
    return np.ascontiguousarray(px)

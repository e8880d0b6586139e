"""Image files. The reference draws to a window only; a PNG (or PPM) is the
headless equivalent of MRT_DrawToWindow. Row 0 of the frame is the bottom
scanline (the reference's layout, main.cpp:156-157), so files are written
flipped, as `miniraytracer_tpu/utils/image.py` writes them.

The PNG is encoded here with zlib (one IDAT of filter-0 rows), so that the
command line needs no imaging library; `read_png` decodes what `save_png`
writes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_u8(frame, flip: bool) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> uint8, flipped for the file."""
    arr = np.asarray(frame)
    if flip:
        arr = arr[::-1]
    return (np.clip(arr, 0.0, 1.0) * 255.99).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, frame, flip: bool = True):
    """frame (H, W, 3) float in [0, 1] -> 8-bit RGB PNG."""
    arr8 = _to_u8(frame, flip)
    h, w = arr8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr8.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 rows of an 8-bit RGB, non-interlaced PNG whose rows
    all use filter 0 (what `save_png` writes), top row first as in the file.
    Raises ValueError for anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG ({header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_ppm(path: str, frame, flip: bool = True):
    """Binary PPM (P6) of frame (H, W, 3) float in [0, 1]."""
    arr8 = _to_u8(frame, flip)
    h, w = arr8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr8.tobytes())

# Frozen copy of handwritten_math_ocr_api_torch/data/png.py at commit e13765f3a37352e31b622845f2ae26a6960b06e8:
# the benchmark decodes the test split's PNGs with its own reader.
"""A PNG reader on numpy and ``zlib`` for 8-bit grayscale images.

The corpora's images are 8-bit grayscale PNGs without interlacing, which is
all this reader takes: any other bit depth, colour type, interlace method or
a palette raises ``ValueError``. The IDAT chunks are joined and inflated,
then each row is unfiltered by its filter type (PNG specification, section
9): None, Sub (a uint8 running sum along the row), Up (the row above added),
Average and Paeth (a loop over columns). ``decode_png_batch`` unfilters the
same row of every image of a batch at once, so the column loops of Average
and Paeth run once per row of the batch, not once per image.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_KNOWN_CRITICAL = {b"IHDR", b"IDAT", b"IEND"}


def _parse(data: bytes) -> Tuple[int, int, np.ndarray]:
    """(height, width, filtered rows (H, W + 1) uint8) of one PNG."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("PNG truncated before IEND")
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} truncated")
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            raise ValueError("PNG with a palette is not implemented")
        elif kind[0:1].isupper() and kind not in _KNOWN_CRITICAL:
            raise ValueError(f"PNG critical chunk {kind!r} not implemented")
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} not implemented (8 only)")
    if colour != 0:
        raise ValueError(f"PNG colour type {colour} not implemented "
                         "(0, grayscale, only)")
    if interlace != 0:
        raise ValueError(f"PNG interlace method {interlace} not implemented")
    if compression != 0 or filtering != 0:
        raise ValueError("PNG compression or filter method not 0")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w + 1):
        raise ValueError(f"PNG image data is {len(raw)} bytes, expected "
                         f"{h * (w + 1)}")
    return h, w, np.frombuffer(raw, np.uint8).reshape(h, w + 1)


def _unfilter_row(kind: int, x: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """One row of each image (N, W): filtered bytes ``x`` to pixels, given
    the row above ``prev`` (zeros for the first row)."""
    if kind == 0:
        return x.copy()
    if kind == 1:  # Sub: a running sum mod 256
        return np.cumsum(x, axis=1, dtype=np.uint8)
    if kind == 2:  # Up
        return x + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not one of 0-4")
    out = np.empty_like(x)
    left = np.zeros(x.shape[0], np.int16)
    up_left = np.zeros(x.shape[0], np.int16)
    for c in range(x.shape[1]):
        up = prev[:, c].astype(np.int16)
        if kind == 3:  # Average
            pred = (left + up) >> 1
        else:  # Paeth
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        out[:, c] = x[:, c] + pred.astype(np.uint8)
        left, up_left = out[:, c].astype(np.int16), up
    return out


def decode_png_batch(blobs: Sequence[bytes]) -> np.ndarray:
    """PNG files of one size -> uint8 (N, H, W)."""
    parsed = [_parse(b) for b in blobs]
    if not parsed:
        raise ValueError("no PNG to decode")
    h, w = parsed[0][:2]
    if any(p[:2] != (h, w) for p in parsed):
        raise ValueError("PNG batch with images of different sizes")
    rows = np.stack([p[2] for p in parsed])  # (N, H, W + 1)
    out = np.empty((len(parsed), h, w), np.uint8)
    prev = np.zeros((len(parsed), w), np.uint8)
    for r in range(h):
        kinds = rows[:, r, 0]
        for kind in np.unique(kinds):
            sel = kinds == kind
            out[sel, r] = _unfilter_row(int(kind), rows[sel, r, 1:],
                                        prev[sel])
        prev = out[:, r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """One PNG file's bytes -> uint8 (H, W)."""
    return decode_png_batch([data])[0]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_png_batch(paths: Sequence[str]) -> np.ndarray:
    blobs: List[bytes] = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return decode_png_batch(blobs)

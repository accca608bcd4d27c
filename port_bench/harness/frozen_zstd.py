# Frozen copy of handwritten_math_ocr_api_torch/utils/zstd.py at commit e13765f3a37352e31b622845f2ae26a6960b06e8.
# The benchmark's own checkpoint reader: later changes to the port's reader
# do not change what the reference is given.
"""zstd decompression through the system's ``libzstd`` (``ctypes``).

The orbax checkpoint compresses its B-tree nodes and its array chunks with
zstd. Python 3.12 has no zstd module, so the port binds three functions of
``libzstd.so.1`` (``ZSTD_decompress``, ``ZSTD_isError``,
``ZSTD_getErrorName``). A missing library raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded ``libzstd`` with its argument and result types declared."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise RuntimeError(
            "libzstd not found (ctypes.util.find_library('zstd') is None): "
            "the checkpoint's zstd frames cannot be decompressed")
    lib = ctypes.CDLL(name)
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    return lib


def decompress(src: bytes, size: int | None = None,
               limit: int | None = None) -> bytes:
    """Decompress the zstd frame(s) in ``src`` in one ``ZSTD_decompress``
    call: to exactly ``size`` bytes, or to at most ``limit`` bytes where
    the size is not known. Raises ``ValueError`` with libzstd's error name
    on a corrupt frame or one that does not fit, and when the output is
    not ``size`` bytes."""
    lib = library()
    cap = size if size is not None else limit
    if cap is None:
        raise ValueError("zstd: neither the output's size nor a limit "
                         "was given")
    dst = bytearray(cap)
    buf = (ctypes.c_char * cap).from_buffer(dst) if cap else None
    n = lib.ZSTD_decompress(buf, cap, src, len(src))
    if lib.ZSTD_isError(n):
        raise ValueError(
            f"zstd: {lib.ZSTD_getErrorName(n).decode()} "
            f"({len(src)} compressed bytes, {cap}-byte output)")
    if size is not None and n != size:
        raise ValueError(f"zstd: decompressed {n} bytes, expected {size}")
    return bytes(dst[:n])

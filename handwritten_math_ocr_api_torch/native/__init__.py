"""ctypes bindings for the port's host C++ library (``libmathocr_native.so``).

The port of ``handwritten_math_ocr_api_tpu/native/``: the same two sources
(``src/mathocr_native.cpp``: the LaTeX token scanner, Levenshtein edit
distance, single and batched on a thread pool, and batch assembly;
``src/stroke_render.cpp``: the stroke renderer's per-point work), copied
into this package and bound with the same entries.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``.kernel_build/native-<hash of the sources and flags>/``
inside the package (a directory that ``.gitignore`` lists), as
``ops/_build.py`` builds the kernels; a finished library is reused, and no
``.so`` is committed. ``available()`` says whether it builds and loads
(``g++`` present); the callers that have a Python version
(``core/tokenizer``, ``eval/metrics``, ``data/dataset``) take the library
when it is available, with the same results either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = ("mathocr_native.cpp", "stroke_render.cpp")
BUILD_ROOT = os.path.join(_PKG, ".kernel_build")
LIB_NAME = "libmathocr_native.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_SEP = "\x1f"

_LIB = None
_LIB_ERROR = None
_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where the library built from these sources lives."""
    return os.path.join(BUILD_ROOT, f"native-{_digest()}", LIB_NAME)


def build() -> str:
    """Compile the library if none for these sources exists yet; return
    its path. Raises ``RuntimeError`` when ``g++`` is missing or fails."""
    lib_path = library_path()
    out_dir = os.path.dirname(lib_path)
    if os.path.exists(lib_path):
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot build")
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="native-", dir=BUILD_ROOT)
    try:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, *(os.path.join(SRC_DIR, s) for s in SOURCES),
             "-o", tmp_lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stdout}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def _bind(lib) -> None:
    P, S, I64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
    lib.mathocr_edit_distance.argtypes = [ctypes.c_char_p, S,
                                          ctypes.c_char_p, S]
    lib.mathocr_edit_distance.restype = I64
    lib.mathocr_tokenize.argtypes = [ctypes.c_char_p, S, ctypes.c_char_p, S]
    lib.mathocr_tokenize.restype = I64
    lib.mathocr_assemble_batch.argtypes = [ctypes.POINTER(P), S, S, P,
                                           ctypes.c_int]
    lib.mathocr_assemble_batch.restype = None
    lib.mathocr_edit_distance_batch.argtypes = [P, P, P, P, S, P,
                                                ctypes.c_int]
    lib.mathocr_edit_distance_batch.restype = None
    lib.mathocr_version.restype = ctypes.c_char_p
    lib.mathocr_register_glyphs.argtypes = [P, P, P, I64, I64]
    lib.mathocr_register_glyphs.restype = ctypes.c_int
    lib.mathocr_num_glyphs.restype = I64
    lib.mathocr_render_formula.argtypes = [
        P, P, P, P, I64, P, P, I64, P, I64, P, ctypes.c_uint64, P, I64, I64]
    lib.mathocr_render_formula.restype = ctypes.c_int


def library():
    """The loaded library (built at first use). Raises ``RuntimeError``
    when it cannot be built or loaded."""
    global _LIB, _LIB_ERROR
    if _LIB is not None:
        return _LIB
    with _lock:
        if _LIB is None:
            if _LIB_ERROR is not None:
                raise RuntimeError(_LIB_ERROR)
            try:
                lib = ctypes.CDLL(build())
                _bind(lib)
            except (OSError, RuntimeError) as e:
                _LIB_ERROR = str(e)
                raise RuntimeError(_LIB_ERROR) from e
            _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    try:
        library()
        return True
    except RuntimeError:
        return False


def version() -> str:
    return library().mathocr_version().decode()


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance over unicode code points."""
    lib = library()
    return int(lib.mathocr_edit_distance(a.encode("utf-32-le"), len(a),
                                         b.encode("utf-32-le"), len(b)))


def _pack(strs: Sequence[str]):
    n = len(strs)
    offs = np.zeros(n + 1, np.int64)
    for i, s in enumerate(strs):
        offs[i + 1] = offs[i] + len(s)
    buf = (np.frombuffer("".join(strs).encode("utf-32-le"),
                         dtype=np.uint32).copy()
           if n else np.zeros(0, np.uint32))
    return buf, offs


def edit_distance_batch(preds: Sequence[str], targets: Sequence[str],
                        num_threads: int = 4) -> np.ndarray:
    """Each pair's Levenshtein distance, on ``num_threads`` threads."""
    lib = library()
    n = len(preds)
    if len(targets) != n:
        raise ValueError(f"{n} predictions, {len(targets)} targets")
    a_buf, a_off = _pack(list(preds))
    b_buf, b_off = _pack(list(targets))
    out = np.zeros(n, np.int64)
    lib.mathocr_edit_distance_batch(
        a_buf.ctypes.data, a_off.ctypes.data, b_buf.ctypes.data,
        b_off.ctypes.data, n, out.ctypes.data, num_threads)
    return out


def tokenize(formula: str, max_bytes: int = 1 << 16) -> List[str]:
    """LaTeX tokens, with ``core/tokenizer.tokenize_latex``'s regex
    semantics."""
    lib = library()
    raw = formula.encode("utf-8")
    buf = ctypes.create_string_buffer(max(max_bytes, 2 * len(raw) + 16))
    n = lib.mathocr_tokenize(raw, len(raw), buf, len(buf))
    if n < 0:
        raise ValueError("tokenize output buffer too small")
    if n == 0:
        return []
    return buf.value.decode("utf-8").split(_SEP)


def register_glyphs(pts: np.ndarray, stroke_off: np.ndarray,
                    glyph_off: np.ndarray) -> int:
    """Register the flattened glyph templates (once a process): ``pts``
    float32 (P, 2), ``stroke_off`` int64 (S + 1,) point offsets,
    ``glyph_off`` int64 (G + 1,) stroke offsets. Returns the glyph count."""
    lib = library()
    pts = np.ascontiguousarray(pts, np.float32)
    stroke_off = np.ascontiguousarray(stroke_off, np.int64)
    glyph_off = np.ascontiguousarray(glyph_off, np.int64)
    rc = lib.mathocr_register_glyphs(
        pts.ctypes.data, stroke_off.ctypes.data, glyph_off.ctypes.data,
        len(stroke_off) - 1, len(glyph_off) - 1)
    if rc != 0:
        raise RuntimeError("mathocr_register_glyphs failed")
    return int(lib.mathocr_num_glyphs())


def render_formula(g_ids: np.ndarray, g_aff: np.ndarray, g_seed: np.ndarray,
                   g_width: np.ndarray, in_pts: np.ndarray,
                   in_off: np.ndarray, drop_idx: np.ndarray,
                   params: np.ndarray, noise_seed: int, img_h: int,
                   img_w: int) -> np.ndarray:
    """Render one display list to a uint8 (img_h, img_w) image (the
    argument contract is in ``src/stroke_render.cpp``)."""
    lib = library()
    g_ids = np.ascontiguousarray(g_ids, np.int32)
    g_aff = np.ascontiguousarray(g_aff, np.float64)
    g_seed = np.ascontiguousarray(g_seed, np.uint64)
    g_width = np.ascontiguousarray(g_width, np.float64)
    in_pts = np.ascontiguousarray(in_pts, np.float32)
    in_off = np.ascontiguousarray(in_off, np.int64)
    drop_idx = np.ascontiguousarray(drop_idx, np.int64)
    params = np.ascontiguousarray(params, np.float64)
    out = np.empty((img_h, img_w), np.uint8)
    rc = lib.mathocr_render_formula(
        g_ids.ctypes.data, g_aff.ctypes.data, g_seed.ctypes.data,
        g_width.ctypes.data, len(g_ids), in_pts.ctypes.data,
        in_off.ctypes.data, len(in_off) - 1, drop_idx.ctypes.data,
        len(drop_idx), params.ctypes.data,
        ctypes.c_uint64(noise_seed & (2 ** 64 - 1)), out.ctypes.data,
        img_h, img_w)
    if rc != 0:
        raise RuntimeError(f"mathocr_render_formula rc={rc}")
    return out


def assemble_batch(images: Sequence[np.ndarray],
                   num_threads: int = 4) -> np.ndarray:
    """Stack N uint8 (H, W) images of one shape into (N, H, W, 1) on a
    thread pool."""
    lib = library()
    n = len(images)
    h, w = images[0].shape
    out = np.empty((n, h, w, 1), np.uint8)
    contig = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in contig:
        if im.shape != (h, w):
            raise ValueError(f"image of shape {im.shape}, expected {(h, w)}")
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in contig])
    lib.mathocr_assemble_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), n, h * w,
        out.ctypes.data, num_threads)
    return out

"""Stroke-based synthetic handwriting renderer for math formulas.

The port of ``handwritten_math_ocr_api_tpu/data/strokes.py``, a copy of its
Python render path: the glyph templates (``GLYPHS``, the rich inventory),
the structural parser with its environments and delimiters,
``formula_strokes``, ``_handwrite``, ``render_stroke_image`` with
``degrade``, the stream (``StrokeStreamDataset``) and the corpus
(``make_stroke_corpus``). Every draw comes from ``random.Random`` and numpy
generators seeded as in JAX, and the strokes are drawn by the same cv2
rasterizer (``data/inkml.py``), so the geometry and the uint8 images equal
the JAX package's for the same seeds. ``render_stroke_image_native`` is the
display-list path on the port's host C++ library (``native/``).

What it renders, as in JAX: the font-rendered corpus
(``synthetic.render_corpus_image``) draws the LaTeX source literally; this
renderer is the stand-in for real handwriting (MathWriting InkML):

- **Glyphs are polyline strokes**, not font rasters: every symbol is a
  hand-authored stroke skeleton that gets per-sample jitter (point noise,
  per-glyph affine wobble, random slant, baseline wander, varying pen
  thickness) through the same rasterization path as real InkML
  (``data/inkml.py``: ``Ink`` + ``rasterize``).
- **Layout is structural, not literal**: ``x ^ { 2 }`` renders as a small
  raised 2 after the x; ``\\frac { a } { b }`` as a over a bar over b;
  ``\\sqrt`` draws a radical with an overline; ``\\sum``/``\\int`` are
  large operators with under/over scripts.

It consumes the token inventory of ``synthetic.structured_formula`` /
``grammar_vocab()``, so streaming training, vocab building and eval reuse
the existing plumbing.

One deliberate difference: JAX's ``render_stroke_image_native`` falls back
to the Python renderer when its library is missing; the port's raises
``RuntimeError`` (a stream that asked for the native renderer gets it, or
fails).
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .inkml import Ink, rasterize

Stroke = List[Tuple[float, float]]   # polyline in glyph-local coords

# ---------------------------------------------------------------------------
# Glyph templates
#
# Coordinate convention: y grows DOWN. Baseline at y = 1.0; x-height band
# is y in [0.45, 1.0]; ascenders reach toward 0.0; descenders toward 1.45.
# Each template lists (width, strokes); stroke points live in [0, width] x
# [-0.1, 1.5].
# ---------------------------------------------------------------------------


def _arc(cx: float, cy: float, rx: float, ry: float, a0: float, a1: float,
         n: int = 12) -> Stroke:
    """Elliptic arc, angles in degrees, y-down screen coords (90 deg points
    down the page)."""
    ts = np.linspace(math.radians(a0), math.radians(a1), n)
    return [(cx + rx * math.cos(t), cy + ry * math.sin(t)) for t in ts]


def _line(x0, y0, x1, y1, n: int = 6) -> Stroke:
    return [(x0 + (x1 - x0) * t, y0 + (y1 - y0) * t)
            for t in np.linspace(0.0, 1.0, n)]


def _dot(cx, cy, r: float = 0.03) -> Stroke:
    return _arc(cx, cy, r, r, 0, 360, 8)


_XH = 0.45          # top of the lowercase body
_MID = (_XH + 1.0) / 2.0   # 0.725, vertical middle of the body


def _bowl(cx, cy=_MID, r=0.27) -> Stroke:
    """Closed-ish oval, the lowercase bowl."""
    return _arc(cx, cy, r, (1.0 - _XH) / 2.0, -80, 262, 16)


def _glyphs() -> Dict[str, Tuple[float, List[Stroke]]]:
    g: Dict[str, Tuple[float, List[Stroke]]] = {}
    # --- lowercase latin ---------------------------------------------------
    g["a"] = (0.62, [_bowl(0.27), _line(0.55, _XH, 0.55, 1.0)
                     + _arc(0.58, 0.95, 0.06, 0.06, 180, 60, 5)])
    g["b"] = (0.62, [_line(0.10, 0.0, 0.10, 1.0),
                     _arc(0.33, _MID, 0.25, (1.0 - _XH) / 2, 115, -115, 14)])
    g["c"] = (0.58, [_arc(0.32, _MID, 0.26, (1.0 - _XH) / 2, 45, 315, 14)])
    g["d"] = (0.62, [_bowl(0.27), _line(0.55, 0.0, 0.55, 1.0)])
    g["e"] = (0.58, [_line(0.06, _MID, 0.52, _MID)
                     + _arc(0.29, _MID, 0.24, (1.0 - _XH) / 2, 0, -255, 14)])
    g["f"] = (0.52, [_arc(0.42, 0.16, 0.14, 0.14, -20, -175, 7)
                     + _line(0.24, 0.16, 0.24, 1.0, 4),
                     _line(0.06, _XH, 0.46, _XH, 3)])
    g["g"] = (0.62, [_bowl(0.27),
                     _line(0.55, _XH, 0.55, 1.25, 4)
                     + _arc(0.33, 1.25, 0.22, 0.18, 0, 140, 7)])
    g["h"] = (0.60, [_line(0.10, 0.0, 0.10, 1.0),
                     _arc(0.31, 0.70, 0.21, 0.25, 180, 0, 9)
                     + _line(0.52, 0.70, 0.52, 1.0, 3)])
    g["i"] = (0.28, [_line(0.14, _XH, 0.14, 1.0), _dot(0.14, 0.26)])
    g["j"] = (0.36, [_line(0.24, _XH, 0.24, 1.25, 4)
                     + _arc(0.10, 1.25, 0.14, 0.16, 0, 120, 6),
                     _dot(0.24, 0.26)])
    g["k"] = (0.58, [_line(0.10, 0.0, 0.10, 1.0),
                     _line(0.48, _XH, 0.10, 0.76, 4),
                     _line(0.22, 0.66, 0.52, 1.0, 4)])
    g["l"] = (0.28, [_line(0.14, 0.0, 0.14, 0.92, 5)
                     + _arc(0.22, 0.92, 0.08, 0.08, 180, 90, 4)])
    g["m"] = (0.92, [_line(0.08, _XH, 0.08, 1.0),
                     _arc(0.26, 0.68, 0.18, 0.23, 180, 0, 8)
                     + _line(0.44, 0.68, 0.44, 1.0, 3),
                     _arc(0.62, 0.68, 0.18, 0.23, 180, 0, 8)
                     + _line(0.80, 0.68, 0.80, 1.0, 3)])
    g["n"] = (0.60, [_line(0.10, _XH, 0.10, 1.0),
                     _arc(0.30, 0.70, 0.20, 0.25, 180, 0, 9)
                     + _line(0.50, 0.70, 0.50, 1.0, 3)])
    g["o"] = (0.60, [_arc(0.30, _MID, 0.25, (1.0 - _XH) / 2, -90, 270, 16)])
    g["p"] = (0.62, [_line(0.10, _XH, 0.10, 1.45),
                     _arc(0.33, _MID, 0.25, (1.0 - _XH) / 2, 115, -115, 14)])
    g["q"] = (0.62, [_bowl(0.27), _line(0.55, _XH, 0.55, 1.45)])
    g["r"] = (0.46, [_line(0.10, _XH, 0.10, 1.0),
                     _arc(0.28, 0.66, 0.18, 0.21, 180, -30, 7)])
    g["s"] = (0.50, [_arc(0.28, 0.58, 0.17, 0.13, 40, 240, 9)
                     + _arc(0.24, 0.86, 0.19, 0.15, -120, 70, 9)])
    g["t"] = (0.46, [_line(0.20, 0.12, 0.20, 0.90, 5)
                     + _arc(0.30, 0.90, 0.10, 0.10, 180, 80, 5),
                     _line(0.04, _XH, 0.42, _XH, 3)])
    g["u"] = (0.60, [_line(0.10, _XH, 0.10, 0.78, 3)
                     + _arc(0.30, 0.78, 0.20, 0.22, 180, 360, 9)
                     + _line(0.50, 0.78, 0.50, 1.0, 3)])
    g["v"] = (0.56, [_line(0.06, _XH, 0.28, 1.0, 5),
                     _line(0.28, 1.0, 0.50, _XH, 5)])
    g["w"] = (0.84, [_line(0.05, _XH, 0.22, 1.0, 4),
                     _line(0.22, 1.0, 0.40, 0.56, 4),
                     _line(0.40, 0.56, 0.58, 1.0, 4),
                     _line(0.58, 1.0, 0.76, _XH, 4)])
    g["x"] = (0.56, [_line(0.06, _XH, 0.50, 1.0, 5),
                     _line(0.50, _XH, 0.06, 1.0, 5)])
    g["y"] = (0.58, [_line(0.08, _XH, 0.30, 1.0, 5),
                     _line(0.52, _XH, 0.18, 1.42, 6)])
    g["z"] = (0.54, [_line(0.06, _XH, 0.48, _XH, 3)
                     + _line(0.48, _XH, 0.06, 1.0, 5)
                     + _line(0.06, 1.0, 0.50, 1.0, 3)])
    # --- greek -------------------------------------------------------------
    g["\\alpha"] = (0.66, [
        _arc(0.28, _MID, 0.24, (1.0 - _XH) / 2, -40, 220, 13)
        + _line(0.46, _XH + 0.05, 0.60, 1.0, 5)])
    g["\\beta"] = (0.60, [
        _line(0.12, 0.10, 0.12, 1.45, 7),
        _arc(0.30, 0.30, 0.20, 0.20, 160, -60, 9)
        + _arc(0.32, 0.74, 0.24, 0.25, -90, 120, 10)])
    g["\\gamma"] = (0.58, [_line(0.06, _XH, 0.32, 1.0, 5)
                           + _line(0.32, 1.0, 0.30, 1.40, 4),
                           _line(0.52, _XH, 0.32, 1.0, 5)])
    g["\\theta"] = (0.58, [_arc(0.29, 0.55, 0.23, 0.47, -90, 270, 16),
                           _line(0.10, 0.55, 0.48, 0.55, 3)])
    g["\\lambda"] = (0.60, [_line(0.08, 0.08, 0.52, 1.0, 6),
                            _line(0.30, 0.54, 0.06, 1.0, 5)])
    g["\\mu"] = (0.64, [_line(0.10, _XH, 0.10, 1.42, 6),
                        _line(0.10, 0.80, 0.12, 0.80, 2)
                        + _arc(0.32, 0.76, 0.20, 0.24, 180, 360, 9)
                        + _line(0.52, 0.76, 0.56, 1.0, 3)])
    g["\\pi"] = (0.66, [_line(0.04, _XH + 0.04, 0.62, _XH + 0.04, 4),
                        _line(0.18, _XH + 0.04, 0.16, 1.0, 4),
                        _line(0.48, _XH + 0.04, 0.50, 1.0, 4)])
    g["\\sigma"] = (0.62, [
        _arc(0.28, _MID, 0.23, (1.0 - _XH) / 2, -90, 270, 14)
        + _line(0.28 + 0.10, _XH, 0.58, _XH - 0.02, 3)])
    g["\\phi"] = (0.62, [_arc(0.30, _MID, 0.24, (1.0 - _XH) / 2, -90, 270, 14),
                         _line(0.30, 0.30, 0.30, 1.42, 6)])
    g["\\omega"] = (0.74, [_arc(0.20, 0.70, 0.14, 0.28, 180, 0, 10)
                           + _arc(0.50, 0.70, 0.14, 0.28, 180, 0, 10)])
    # --- digits (full height band y in [0.08, 1.0]) -------------------------
    g["0"] = (0.58, [_arc(0.29, 0.54, 0.23, 0.46, -90, 270, 16)])
    g["1"] = (0.40, [_line(0.08, 0.30, 0.24, 0.08, 4) + _line(0.24, 0.08, 0.24, 1.0, 6)])
    g["2"] = (0.56, [_arc(0.28, 0.30, 0.21, 0.22, 180, 340, 9)
                     + _line(0.47, 0.42, 0.08, 1.0, 6)
                     + _line(0.08, 1.0, 0.52, 1.0, 3)])
    g["3"] = (0.54, [_arc(0.26, 0.30, 0.20, 0.21, 170, 370, 9)
                     + _arc(0.27, 0.76, 0.22, 0.25, -80, 160, 10)])
    g["4"] = (0.58, [_line(0.36, 0.08, 0.08, 0.66, 5)
                     + _line(0.08, 0.66, 0.54, 0.66, 3),
                     _line(0.40, 0.08, 0.40, 1.0, 6)])
    g["5"] = (0.56, [_line(0.46, 0.08, 0.12, 0.08, 3)
                     + _line(0.12, 0.08, 0.10, 0.48, 3)
                     + _arc(0.28, 0.72, 0.22, 0.26, -110, 150, 11)])
    g["6"] = (0.56, [_arc(0.50, 0.12, 0.45, 0.50, 150, 230, 8)
                     + _arc(0.28, 0.74, 0.20, 0.24, -180, 180, 13)])
    g["7"] = (0.54, [_line(0.06, 0.10, 0.50, 0.10, 3)
                     + _line(0.50, 0.10, 0.20, 1.0, 6)])
    g["8"] = (0.56, [_arc(0.28, 0.32, 0.18, 0.22, -90, 270, 12)
                     + _arc(0.28, 0.78, 0.21, 0.24, -90, 270, 12)])
    g["9"] = (0.56, [_arc(0.28, 0.34, 0.20, 0.24, -90, 270, 13),
                     _line(0.47, 0.36, 0.40, 1.0, 5)])
    # --- operators / punctuation -------------------------------------------
    g["+"] = (0.60, [_line(0.06, 0.62, 0.54, 0.62, 3),
                     _line(0.30, 0.38, 0.30, 0.88, 3)])
    g["-"] = (0.54, [_line(0.06, 0.62, 0.48, 0.62, 3)])
    g["="] = (0.60, [_line(0.06, 0.52, 0.54, 0.52, 3),
                     _line(0.06, 0.72, 0.54, 0.72, 3)])
    g["\\cdot"] = (0.24, [_dot(0.12, 0.62, 0.035)])
    g["\\times"] = (0.54, [_line(0.07, 0.40, 0.47, 0.84, 4),
                           _line(0.47, 0.40, 0.07, 0.84, 4)])
    g["\\pm"] = (0.60, [_line(0.06, 0.52, 0.54, 0.52, 3),
                        _line(0.30, 0.28, 0.30, 0.76, 3),
                        _line(0.06, 0.94, 0.54, 0.94, 3)])
    g["\\leq"] = (0.60, [_line(0.52, 0.30, 0.08, 0.54, 4)
                         + _line(0.08, 0.54, 0.52, 0.78, 4),
                         _line(0.08, 0.96, 0.52, 0.96, 3)])
    g["\\geq"] = (0.60, [_line(0.08, 0.30, 0.52, 0.54, 4)
                         + _line(0.52, 0.54, 0.08, 0.78, 4),
                         _line(0.08, 0.96, 0.52, 0.96, 3)])
    g["\\neq"] = (0.60, [_line(0.06, 0.52, 0.54, 0.52, 3),
                         _line(0.06, 0.72, 0.54, 0.72, 3),
                         _line(0.44, 0.30, 0.16, 0.94, 4)])
    g["\\to"] = (0.78, [_line(0.06, 0.62, 0.70, 0.62, 4),
                        _line(0.54, 0.46, 0.70, 0.62, 3),
                        _line(0.54, 0.78, 0.70, 0.62, 3)])
    g["("] = (0.34, [_arc(0.52, 0.54, 0.34, 0.56, 110, 250, 10)])
    g[")"] = (0.34, [_arc(-0.18, 0.54, 0.34, 0.56, -70, 70, 10)])
    # --- large operators (drawn big by the layout) ---------------------------
    g["\\sum"] = (0.70, [_line(0.62, 0.10, 0.08, 0.10, 3)
                         + _line(0.08, 0.10, 0.40, 0.54, 4)
                         + _line(0.40, 0.54, 0.08, 1.0, 4)
                         + _line(0.08, 1.0, 0.64, 1.0, 3)])
    g["\\int"] = (0.44, [_arc(0.34, 0.10, 0.10, 0.10, -90, -200, 6)
                         + _line(0.24, 0.12, 0.20, 0.98, 7)
                         + _arc(0.10, 1.00, 0.10, 0.10, -20, 90, 6)])
    return g


def _glyphs_rich() -> Dict[str, Tuple[float, List[Stroke]]]:
    """Extended inventory for the MathWriting-difficulty regime
    (synthetic._VARS_RICH & co.): uppercase latin, the remaining greek
    alphabet + capitals, set/relation operators, brackets, primes.
    Same coordinate convention as :func:`_glyphs`; capitals occupy the
    digit band y in [0.08, 1.0]."""
    g: Dict[str, Tuple[float, List[Stroke]]] = {}
    # --- uppercase latin (no I/O: confusable with 1/0) ---------------------
    g["A"] = (0.60, [_line(0.04, 1.0, 0.30, 0.08, 6),
                     _line(0.30, 0.08, 0.56, 1.0, 6),
                     _line(0.14, 0.65, 0.46, 0.65, 3)])
    g["B"] = (0.58, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _arc(0.28, 0.31, 0.20, 0.23, -90, 90, 9)
                     + _arc(0.30, 0.77, 0.23, 0.23, -90, 90, 9)])
    g["C"] = (0.62, [_arc(0.34, 0.54, 0.28, 0.46, 40, 320, 13)])
    g["D"] = (0.58, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _arc(0.10, 0.54, 0.42, 0.46, -90, 90, 11)])
    g["E"] = (0.54, [_line(0.48, 0.08, 0.10, 0.08, 3)
                     + _line(0.10, 0.08, 0.10, 1.0, 6)
                     + _line(0.10, 1.0, 0.50, 1.0, 3),
                     _line(0.10, 0.54, 0.40, 0.54, 3)])
    g["F"] = (0.52, [_line(0.48, 0.08, 0.10, 0.08, 3)
                     + _line(0.10, 0.08, 0.10, 1.0, 6),
                     _line(0.10, 0.54, 0.40, 0.54, 3)])
    g["G"] = (0.64, [_arc(0.34, 0.54, 0.28, 0.46, 30, 330, 13)
                     + _line(0.62, 0.62, 0.38, 0.62, 3)])
    g["H"] = (0.60, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _line(0.50, 0.08, 0.50, 1.0, 6),
                     _line(0.10, 0.56, 0.50, 0.56, 3)])
    g["J"] = (0.56, [_line(0.44, 0.08, 0.44, 0.82, 5)
                     + _arc(0.28, 0.82, 0.16, 0.18, 0, 150, 7)])
    g["K"] = (0.58, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _line(0.52, 0.08, 0.10, 0.60, 5),
                     _line(0.24, 0.46, 0.54, 1.0, 5)])
    g["L"] = (0.50, [_line(0.10, 0.08, 0.10, 1.0, 6)
                     + _line(0.10, 1.0, 0.48, 1.0, 3)])
    g["M"] = (0.68, [_line(0.08, 1.0, 0.08, 0.08, 6),
                     _line(0.08, 0.08, 0.34, 0.72, 5),
                     _line(0.34, 0.72, 0.60, 0.08, 5),
                     _line(0.60, 0.08, 0.60, 1.0, 6)])
    g["N"] = (0.60, [_line(0.08, 1.0, 0.08, 0.08, 6),
                     _line(0.08, 0.08, 0.52, 1.0, 6),
                     _line(0.52, 1.0, 0.52, 0.08, 6)])
    g["P"] = (0.56, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _arc(0.28, 0.33, 0.22, 0.25, -90, 90, 9)])
    g["Q"] = (0.62, [_arc(0.30, 0.54, 0.25, 0.46, -90, 270, 16),
                     _line(0.38, 0.76, 0.58, 1.04, 4)])
    g["R"] = (0.58, [_line(0.10, 0.08, 0.10, 1.0, 6),
                     _arc(0.28, 0.33, 0.22, 0.25, -90, 90, 9),
                     _line(0.30, 0.58, 0.54, 1.0, 5)])
    g["S"] = (0.56, [_arc(0.30, 0.31, 0.20, 0.21, 40, 235, 9)
                     + _arc(0.28, 0.77, 0.22, 0.25, -125, 70, 10)])
    g["T"] = (0.56, [_line(0.04, 0.08, 0.52, 0.08, 3),
                     _line(0.28, 0.08, 0.28, 1.0, 6)])
    g["U"] = (0.60, [_line(0.08, 0.08, 0.08, 0.68, 4)
                     + _arc(0.30, 0.68, 0.22, 0.31, 180, 360, 10)
                     + _line(0.52, 0.68, 0.52, 0.08, 4)])
    g["V"] = (0.58, [_line(0.04, 0.08, 0.29, 1.0, 6),
                     _line(0.29, 1.0, 0.54, 0.08, 6)])
    g["W"] = (0.84, [_line(0.04, 0.08, 0.22, 1.0, 5),
                     _line(0.22, 1.0, 0.41, 0.40, 5),
                     _line(0.41, 0.40, 0.60, 1.0, 5),
                     _line(0.60, 1.0, 0.78, 0.08, 5)])
    g["X"] = (0.58, [_line(0.04, 0.08, 0.54, 1.0, 6),
                     _line(0.54, 0.08, 0.04, 1.0, 6)])
    g["Y"] = (0.56, [_line(0.04, 0.08, 0.28, 0.54, 4),
                     _line(0.52, 0.08, 0.28, 0.54, 4),
                     _line(0.28, 0.54, 0.28, 1.0, 4)])
    g["Z"] = (0.56, [_line(0.06, 0.08, 0.50, 0.08, 3)
                     + _line(0.50, 0.08, 0.06, 1.0, 6)
                     + _line(0.06, 1.0, 0.52, 1.0, 3)])
    # --- remaining greek lowercase ----------------------------------------
    g["\\delta"] = (0.58, [_line(0.46, 0.10, 0.26, 0.50, 4)
                           + _arc(0.28, 0.74, 0.22, 0.24, -90, 270, 14)])
    g["\\epsilon"] = (0.52, [_arc(0.30, 0.58, 0.20, 0.14, 60, 300, 9),
                             _arc(0.30, 0.86, 0.20, 0.14, 60, 300, 9)])
    g["\\eta"] = (0.60, [_line(0.10, _XH, 0.10, 1.0, 4),
                         _arc(0.30, 0.70, 0.20, 0.25, 180, 0, 9)
                         + _line(0.50, 0.70, 0.50, 1.42, 5)])
    g["\\kappa"] = (0.54, [_line(0.10, _XH, 0.10, 1.0, 4),
                           _line(0.46, _XH, 0.10, 0.74, 4),
                           _line(0.20, 0.66, 0.48, 1.0, 4)])
    g["\\nu"] = (0.54, [_line(0.08, _XH, 0.24, 1.0, 5),
                        _arc(0.24, 0.80, 0.24, 0.22, 120, 10, 7)])
    g["\\rho"] = (0.58, [_line(0.105, 0.72, 0.105, 1.45, 5),
                         _arc(0.32, _MID, 0.22, (1.0 - _XH) / 2,
                              115, -115, 13)])
    g["\\tau"] = (0.50, [_line(0.04, _XH, 0.44, _XH, 3),
                         _line(0.24, _XH, 0.24, 0.92, 4)
                         + _arc(0.33, 0.92, 0.09, 0.08, 180, 90, 4)])
    g["\\chi"] = (0.56, [_line(0.04, _XH, 0.52, 1.42, 6),
                         _line(0.52, _XH, 0.04, 1.42, 6)])
    g["\\psi"] = (0.62, [_line(0.31, 0.30, 0.31, 1.42, 6),
                         _line(0.10, _XH, 0.10, 0.72, 3)
                         + _arc(0.31, 0.72, 0.21, 0.26, 180, 360, 9)
                         + _line(0.52, 0.72, 0.52, _XH, 3)])
    g["\\xi"] = (0.50, [_arc(0.28, 0.28, 0.16, 0.17, -80, 160, 8)
                        + _arc(0.26, 0.62, 0.17, 0.16, -100, 140, 8)
                        + _arc(0.28, 0.98, 0.18, 0.18, -120, 90, 8)])
    g["\\zeta"] = (0.50, [_arc(0.28, 0.24, 0.15, 0.15, -90, 150, 7)
                          + _line(0.20, 0.34, 0.42, 0.92, 5)
                          + _arc(0.28, 1.02, 0.16, 0.14, -30, 120, 6)])
    # --- greek capitals ----------------------------------------------------
    g["\\Delta"] = (0.62, [_line(0.31, 0.08, 0.04, 1.0, 6),
                           _line(0.31, 0.08, 0.58, 1.0, 6),
                           _line(0.04, 1.0, 0.58, 1.0, 3)])
    g["\\Gamma"] = (0.50, [_line(0.48, 0.08, 0.10, 0.08, 3)
                           + _line(0.10, 0.08, 0.10, 1.0, 6)])
    g["\\Omega"] = (0.64, [_line(0.06, 1.0, 0.20, 1.0, 2)
                           + _line(0.20, 1.0, 0.14, 0.78, 2)
                           + _arc(0.32, 0.48, 0.24, 0.40, 140, -320, 14)
                           + _line(0.50, 0.78, 0.44, 1.0, 2)
                           + _line(0.44, 1.0, 0.58, 1.0, 2)])
    g["\\Phi"] = (0.60, [_arc(0.30, 0.54, 0.24, 0.32, -90, 270, 13),
                         _line(0.30, 0.08, 0.30, 1.0, 6)])
    g["\\Psi"] = (0.62, [_line(0.31, 0.08, 0.31, 1.0, 6),
                         _line(0.08, 0.14, 0.08, 0.44, 3)
                         + _arc(0.31, 0.44, 0.23, 0.26, 180, 360, 9)
                         + _line(0.54, 0.44, 0.54, 0.14, 3)])
    g["\\Theta"] = (0.60, [_arc(0.30, 0.54, 0.24, 0.46, -90, 270, 16),
                           _line(0.16, 0.54, 0.44, 0.54, 3)])
    g["\\Lambda"] = (0.60, [_line(0.30, 0.08, 0.04, 1.0, 6),
                            _line(0.30, 0.08, 0.56, 1.0, 6)])
    g["\\Sigma"] = (0.56, [_line(0.50, 0.08, 0.08, 0.08, 3)
                           + _line(0.08, 0.08, 0.34, 0.54, 4)
                           + _line(0.34, 0.54, 0.08, 1.0, 4)
                           + _line(0.08, 1.0, 0.52, 1.0, 3)])
    g["\\Pi"] = (0.58, [_line(0.06, 0.08, 0.52, 0.08, 3),
                        _line(0.12, 0.08, 0.12, 1.0, 6),
                        _line(0.46, 0.08, 0.46, 1.0, 6)])
    # --- misc symbols ------------------------------------------------------
    g["\\infty"] = (0.62, [_arc(0.18, 0.62, 0.14, 0.12, -90, 270, 10)
                           + _arc(0.44, 0.62, 0.14, 0.12, 90, 450, 10)])
    g["\\partial"] = (0.58, [_arc(0.28, 0.74, 0.22, 0.24, -60, 270, 13)
                             + _arc(0.32, 0.32, 0.18, 0.18, 160, 10, 8)])
    g["\\ell"] = (0.48, [_line(0.10, 1.0, 0.30, 0.40, 4)
                         + _arc(0.26, 0.30, 0.10, 0.12, 30, 300, 8)
                         + _line(0.20, 0.42, 0.38, 0.96, 4)])
    # --- operators (op band around the math axis y ~ 0.62) -----------------
    g["\\div"] = (0.56, [_line(0.06, 0.62, 0.50, 0.62, 3),
                         _dot(0.28, 0.42), _dot(0.28, 0.82)])
    _tilde = lambda y: (_arc(0.17, y + 0.05, 0.12, 0.08, 180, 300, 6)
                        + _arc(0.41, y - 0.05, 0.12, 0.08, 120, 0, 6))
    g["\\sim"] = (0.58, [_tilde(0.62)])
    g["\\approx"] = (0.58, [_tilde(0.50), _tilde(0.74)])
    g["\\propto"] = (0.60, [_arc(0.24, 0.62, 0.18, 0.17, -40, 220, 11)
                            + _line(0.38, 0.50, 0.56, 0.44, 3),
                            _line(0.38, 0.74, 0.56, 0.80, 3)])
    g["\\in"] = (0.58, [_arc(0.32, 0.62, 0.24, 0.26, 90, 270, 9),
                        _line(0.32, 0.62, 0.54, 0.62, 3),
                        _line(0.32, 0.36, 0.54, 0.36, 3),
                        _line(0.32, 0.88, 0.54, 0.88, 3)])
    g["\\subset"] = (0.58, [_arc(0.34, 0.62, 0.24, 0.24, 90, 270, 10)])
    g["\\cup"] = (0.56, [_line(0.08, 0.36, 0.08, 0.68, 3)
                         + _arc(0.28, 0.68, 0.20, 0.22, 180, 360, 9)
                         + _line(0.48, 0.68, 0.48, 0.36, 3)])
    g["\\cap"] = (0.56, [_line(0.08, 0.88, 0.08, 0.56, 3)
                         + _arc(0.28, 0.56, 0.20, 0.22, 180, 0, 9)
                         + _line(0.48, 0.56, 0.48, 0.88, 3)])
    g["<"] = (0.52, [_line(0.46, 0.36, 0.08, 0.62, 4)
                     + _line(0.08, 0.62, 0.46, 0.88, 4)])
    g[">"] = (0.52, [_line(0.06, 0.36, 0.44, 0.62, 4)
                     + _line(0.44, 0.62, 0.06, 0.88, 4)])
    g["\\equiv"] = (0.60, [_line(0.06, 0.42, 0.54, 0.42, 3),
                           _line(0.06, 0.62, 0.54, 0.62, 3),
                           _line(0.06, 0.82, 0.54, 0.82, 3)])
    g["\\circ"] = (0.50, [_arc(0.25, 0.58, 0.13, 0.13, -90, 270, 10)])
    # --- brackets / punctuation -------------------------------------------
    g["|"] = (0.24, [_line(0.12, 0.06, 0.12, 1.06, 6)])
    g["["] = (0.30, [_line(0.26, 0.06, 0.12, 0.06, 2)
                     + _line(0.12, 0.06, 0.12, 1.06, 6)
                     + _line(0.12, 1.06, 0.26, 1.06, 2)])
    g["]"] = (0.30, [_line(0.04, 0.06, 0.18, 0.06, 2)
                     + _line(0.18, 0.06, 0.18, 1.06, 6)
                     + _line(0.18, 1.06, 0.04, 1.06, 2)])
    g["'"] = (0.22, [_line(0.14, 0.16, 0.08, 0.40, 3)])
    # --- \prod: large operator, Pi-shaped (drawn big by the layout) --------
    g["\\prod"] = (0.66, [_line(0.04, 0.10, 0.62, 0.10, 3),
                          _line(0.12, 0.10, 0.12, 1.0, 6),
                          _line(0.54, 0.10, 0.54, 1.0, 6)])
    return g


GLYPHS = _glyphs()
GLYPHS.update(_glyphs_rich())

# tokens rendered as letter sequences (handwritten function names)
_WORD_TOKENS = {"\\sin": "sin", "\\cos": "cos", "\\tan": "tan",
                "\\log": "log", "\\ln": "ln", "\\exp": "exp",
                "\\max": "max", "\\min": "min"}
# glyphs whose ink spans the full height band (digits, operators drawn in
# the template's own band) — everything else is lowercase-body metrics
DESCENDERS = {"g", "j", "p", "q", "y", "\\beta", "\\gamma", "\\mu",
              "\\phi", "\\eta", "\\rho", "\\chi", "\\psi", "\\zeta"}


# ---------------------------------------------------------------------------
# Structural layout
# ---------------------------------------------------------------------------


class _Box:
    """Laid-out ink: strokes in local coords (baseline y=0, x from 0),
    plus metrics. y grows down, so ``asc`` <= 0 <= ``desc``."""

    __slots__ = ("strokes", "w", "asc", "desc")

    def __init__(self, strokes: List[np.ndarray], w: float, asc: float,
                 desc: float):
        self.strokes = strokes
        self.w = w
        self.asc = asc
        self.desc = desc


class _GlyphEntry:
    """Display-list placement of one glyph template: the native renderer
    (native/src/stroke_render.cpp) expands it to wobbled strokes. Layout
    code treats it like a stroke (only ``_shift`` touches it)."""

    __slots__ = ("tok", "dx", "dy", "size", "rot", "sx", "sy", "noise",
                 "seed")

    def __init__(self, tok, dx, dy, size, rot, sx, sy, noise, seed):
        self.tok = tok
        self.dx = dx
        self.dy = dy
        self.size = size
        self.rot = rot
        self.sx = sx
        self.sy = sy
        self.noise = noise
        self.seed = seed

    def shifted(self, dx: float, dy: float) -> "_GlyphEntry":
        return _GlyphEntry(self.tok, self.dx + dx, self.dy + dy, self.size,
                           self.rot, self.sx, self.sy, self.noise,
                           self.seed)


def _glyph_box(tok: str, size: float, rng: random.Random,
               jitter: float, native: bool = False) -> _Box:
    """One glyph at ``size`` (em height), with per-glyph affine wobble.

    ``native``: emit a ``_GlyphEntry`` display-list item (same wobble
    parameters, per-point math deferred to C++) instead of materialized
    point arrays; metrics are identical either way."""
    w, strokes = GLYPHS[tok]
    if native:
        rot = rng.gauss(0.0, jitter * 0.09)
        sx = 1.0 + rng.gauss(0.0, jitter * 0.08)
        sy = 1.0 + rng.gauss(0.0, jitter * 0.08)
        entry = _GlyphEntry(tok, 0.0, 0.0, size, rot, sx, sy,
                            jitter * 0.012 if jitter > 0 else 0.0,
                            rng.getrandbits(63))
        asc = -1.05 * size
        desc = 0.48 * size if tok in DESCENDERS else 0.06 * size
        return _Box([entry], w * size, asc, desc)
    out = []
    # per-glyph wobble: rotation + anisotropic scale + point noise
    rot = rng.gauss(0.0, jitter * 0.09)
    sx = 1.0 + rng.gauss(0.0, jitter * 0.08)
    sy = 1.0 + rng.gauss(0.0, jitter * 0.08)
    cr, sr = math.cos(rot), math.sin(rot)
    cx, cy = w / 2.0, 0.7
    for st in strokes:
        pts = np.asarray(st, np.float64)
        if jitter > 0 and len(pts) > 2:
            # vectorized random-walk wobble (a per-point Python
            # rng.gauss loop made the render the training loop's bound)
            nrng = np.random.default_rng(rng.getrandbits(32))
            noise = np.cumsum(nrng.standard_normal((len(pts), 2)), axis=0)
            noise -= noise.mean(axis=0)
            scale = jitter * 0.012
            pts = pts + noise * scale
        x = (pts[:, 0] - cx) * sx
        y = (pts[:, 1] - cy) * sy
        xr = x * cr - y * sr + cx
        yr = x * sr + y * cr + cy
        # template baseline (y=1.0) -> local baseline (y=0)
        out.append(np.stack([xr * size, (yr - 1.0) * size],
                            axis=1).astype(np.float32))
    asc = -1.05 * size
    desc = 0.48 * size if tok in DESCENDERS else 0.06 * size
    return _Box(out, w * size, asc, desc)


def _shift(box: _Box, dx: float, dy: float) -> List[np.ndarray]:
    off = np.asarray([[dx, dy]], np.float32)
    return [s.shifted(dx, dy) if isinstance(s, _GlyphEntry) else s + off
            for s in box.strokes]


def _hcat(boxes: Sequence[_Box], gap: float) -> _Box:
    strokes: List[np.ndarray] = []
    x = 0.0
    asc, desc = 0.0, 0.0
    for b in boxes:
        strokes += _shift(b, x, 0.0)
        x += b.w + gap
        asc = min(asc, b.asc)
        desc = max(desc, b.desc)
    return _Box(strokes, max(x - gap, 0.0), asc, desc)


class _Parser:
    """Tokens -> layout boxes, for the structured_formula grammar."""

    def __init__(self, tokens: List[str], rng: random.Random,
                 jitter: float, gap_scale: float = 1.0,
                 native: bool = False):
        self.toks = tokens
        self.i = 0
        self.rng = rng
        self.jitter = jitter
        # native: glyphs become _GlyphEntry display-list items for the
        # C++ renderer; layout math and random draws are unchanged
        self.native = native
        # < 1.0: denser, possibly touching/overlapping glyphs (the
        # MathWriting-difficulty regime's crowded-handwriting knob)
        self.gap_scale = gap_scale

    def _peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _group(self, size: float) -> _Box:
        """Parse ``{ ... }`` (or a single token) as a sub-layout."""
        if self._peek() == "{":
            self._next()
            boxes = []
            while self._peek() not in ("}", None):
                boxes.append(self._item(size))
            if self._peek() == "}":
                self._next()
            return (_hcat(boxes, 0.12 * size * self.gap_scale)
                    if boxes else _Box([], 0, 0, 0))
        return self._item(size)

    def _scripts(self, base: _Box, size: float, over_under: bool) -> _Box:
        """Attach any ^ / _ groups to ``base``. ``over_under``: scripts go
        above/below (large operators) instead of up/down-right."""
        sup = sub = None
        while self._peek() in ("^", "_"):
            op = self._next()
            grp = self._group(0.62 * size)
            if op == "^":
                sup = grp
            else:
                sub = grp
        if sup is None and sub is None:
            return base
        rng = self.rng
        if over_under:
            strokes = list(base.strokes)
            w = base.w
            asc, desc = base.asc, base.desc
            if sup is not None:
                dy = base.asc - sup.desc - 0.12 * size
                dx = (w - sup.w) / 2 + rng.gauss(0, 0.03 * size)
                strokes += _shift(sup, dx, dy)
                asc = min(asc, dy + sup.asc)
                w = max(w, sup.w)
            if sub is not None:
                dy = base.desc - sub.asc + 0.12 * size
                dx = (w - sub.w) / 2 + rng.gauss(0, 0.03 * size)
                strokes += _shift(sub, dx, dy)
                desc = max(desc, dy + sub.desc)
                w = max(w, sub.w)
            return _Box(strokes, w, asc, desc)
        strokes = list(base.strokes)
        w, asc, desc = base.w, base.asc, base.desc
        pad = 0.06 * size
        if sup is not None:
            dy = -0.52 * size + self.rng.gauss(0, 0.04 * size)
            strokes += _shift(sup, w + pad, dy)
            asc = min(asc, dy + sup.asc)
            w = max(w, w + pad + sup.w)
        if sub is not None:
            dy = 0.34 * size + self.rng.gauss(0, 0.04 * size)
            strokes += _shift(sub, base.w + pad, dy)
            desc = max(desc, dy + sub.desc)
            w = max(w, base.w + pad + sub.w)
        return _Box(strokes, w, asc, desc)

    def _read_env_name(self) -> str:
        """Consume ``{ name }`` after a ``\\begin``/``\\end`` (tolerant of
        malformed input: missing braces/name render as empty)."""
        name = ""
        if self._peek() == "{":
            self._next()
            if self._peek() not in ("}", None):
                name = self._next()
            if self._peek() == "}":
                self._next()
        return name

    def _environment(self, size: float) -> _Box:
        """``\\begin{name} cells… \\end{name}`` -> 2-D grid layout.

        Cells are split on ``&`` (columns) and on the two-token ``\\ \\``
        row break the grammar emits for a LaTeX ``\\\\``; each cell is an
        independent sub-layout at 0.82 em. Columns are centred in their
        max width, rows stacked baseline-to-baseline, the whole block
        centred on the math axis, and the environment name picks the
        surrounding delimiters (pmatrix parens, bmatrix brackets,
        vmatrix bars, cases a left curly brace)."""
        name = self._read_env_name()
        inner = 0.82 * size
        rows: List[List[_Box]] = []
        cells: List[_Box] = []
        cur: List[_Box] = []

        def flush_cell() -> None:
            cells.append(_hcat(cur, 0.12 * inner * self.gap_scale)
                         if cur else _Box([], 0.3 * inner, 0, 0))
            cur.clear()

        def flush_row() -> None:
            flush_cell()
            rows.append(list(cells))
            cells.clear()

        while True:
            t = self._peek()
            if t is None:
                break
            if t == "\\end":
                self._next()
                self._read_env_name()
                break
            if t == "&":
                self._next()
                flush_cell()
                continue
            if (t == "\\" and self.i + 1 < len(self.toks)
                    and self.toks[self.i + 1] == "\\"):
                self._next()
                self._next()
                flush_row()
                continue
            cur.append(self._item(inner))
        flush_row()

        ncol = max(len(r) for r in rows)
        colw = [max((r[c].w if c < len(r) else 0.0) for r in rows)
                for c in range(ncol)]
        row_asc = [min([b.asc for b in r] + [-0.70 * inner]) for r in rows]
        row_desc = [max([b.desc for b in r] + [0.15 * inner]) for r in rows]
        rgap = 0.40 * inner * self.gap_scale
        cgap = 0.60 * inner * self.gap_scale
        total_h = (sum(d - a for a, d in zip(row_asc, row_desc))
                   + rgap * (len(rows) - 1))
        width = sum(colw) + cgap * (ncol - 1)
        top = -0.35 * size - total_h / 2  # centre on the math axis
        strokes: List[np.ndarray] = []
        y = top
        rng = self.rng
        for r, asc, desc in zip(rows, row_asc, row_desc):
            base_y = y - asc
            x = 0.0
            for c in range(ncol):
                if c < len(r):
                    b = r[c]
                    dx = x + (colw[c] - b.w) / 2 + rng.gauss(
                        0, 0.03 * inner)
                    strokes += _shift(b, dx, base_y
                                      + rng.gauss(0, 0.04 * inner))
                x += colw[c] + cgap
            y = base_y + desc + rgap
        body = _Box(strokes, width, top, top + total_h)
        return self._delimit(body, name, size)

    def _delimit(self, body: _Box, name: str, size: float) -> _Box:
        """Wrap an environment body in its delimiters (hand-drawn tall
        strokes scaled to the block height)."""
        if name not in ("pmatrix", "bmatrix", "vmatrix", "cases"):
            return body
        pad = 0.15 * size
        top = body.asc - 0.10 * size
        bot = body.desc + 0.10 * size
        h = bot - top
        cy = (top + bot) / 2.0

        def paren(x0: float, sign: float) -> List[Stroke]:
            # tall arc; sign +1 bulges left of x0 ("("), -1 right (")")
            return [_arc(x0, cy, sign * 0.11 * h, h / 2, 90, 270, 10)]

        def bracket(x0: float, sign: float) -> List[Stroke]:
            tick = sign * 0.14 * size
            return [_line(x0 + tick, top, x0, top, 3)
                    + _line(x0, top, x0, bot, 8)
                    + _line(x0, bot, x0 + tick, bot, 3)]

        def bar(x0: float) -> List[Stroke]:
            return [_line(x0, top, x0, bot, 8)]

        def brace(x0: float) -> List[Stroke]:
            # left curly brace: two shallow arcs meeting at a centre nub
            w = 0.16 * size
            return [_line(x0 + w, top, x0 + w * 0.3, top + h * 0.12, 4)
                    + _line(x0 + w * 0.3, top + h * 0.12, x0 + w * 0.3,
                            cy - h * 0.10, 5)
                    + _line(x0 + w * 0.3, cy - h * 0.10, x0, cy, 3)
                    + _line(x0, cy, x0 + w * 0.3, cy + h * 0.10, 3)
                    + _line(x0 + w * 0.3, cy + h * 0.10, x0 + w * 0.3,
                            bot - h * 0.12, 5)
                    + _line(x0 + w * 0.3, bot - h * 0.12, x0 + w, bot, 4)]

        dw = 0.22 * size
        strokes: List[np.ndarray] = []
        if name == "pmatrix":
            left = paren(dw * 0.7, 1.0)
            right = paren(dw * 0.3, -1.0)
        elif name == "bmatrix":
            left = bracket(dw * 0.5, 1.0)
            right = bracket(dw * 0.5, -1.0)
        elif name == "vmatrix":
            left, right = bar(dw * 0.5), bar(dw * 0.5)
        else:  # cases: left brace only
            left, right = brace(dw * 0.2), None
        jrng = np.random.default_rng(self.rng.getrandbits(32))

        def ink(segs: List[Stroke], dx: float) -> List[np.ndarray]:
            out = []
            for seg in segs:
                pts = np.asarray(seg, np.float32)
                pts = pts + jrng.normal(0, 0.01 * size,
                                        pts.shape).astype(np.float32)
                pts[:, 0] += dx
                out.append(pts)
            return out

        strokes += ink(left, 0.0)
        strokes += _shift(body, dw + pad, 0.0)
        w = dw + pad + body.w
        if right is not None:
            w += pad
            strokes += ink(right, w)
            w += dw
        return _Box(strokes, w, top, bot)

    def _item(self, size: float) -> _Box:
        tok = self._next()
        rng, jit = self.rng, self.jitter
        if tok == "\\begin":
            return self._scripts(self._environment(size), size, False)
        if tok == "\\frac":
            num = self._group(0.82 * size)
            den = self._group(0.82 * size)
            wbar = max(num.w, den.w) + 0.25 * size
            gap = 0.14 * size
            strokes = []
            # numerator above the bar, denominator below (bar at y=-0.35,
            # roughly math-axis height)
            bar_y = -0.35 * size
            strokes += _shift(num, (wbar - num.w) / 2,
                              bar_y - gap - num.desc)
            bar = np.asarray(_line(0.0, bar_y, wbar,
                                   bar_y + rng.gauss(0, 0.02 * size), 5),
                             np.float32)
            strokes.append(bar)
            strokes += _shift(den, (wbar - den.w) / 2,
                              bar_y + gap - den.asc)
            asc = bar_y - gap - num.desc + num.asc
            desc = bar_y + gap - den.asc + den.desc
            return self._scripts(_Box(strokes, wbar, asc, desc), size, False)
        if tok == "\\sqrt":
            body = self._group(0.9 * size)
            tick_w = 0.42 * size
            top = body.asc - 0.18 * size
            strokes = _shift(body, tick_w + 0.08 * size, 0.0)
            radical = (_line(0.0, -0.42 * size, 0.14 * size,
                             -0.32 * size, 3)
                       + _line(0.14 * size, -0.32 * size, 0.30 * size,
                               body.desc + 0.05 * size, 4)
                       + _line(0.30 * size, body.desc + 0.05 * size,
                               tick_w, top, 4)
                       + _line(tick_w, top,
                               tick_w + body.w + 0.16 * size, top, 4))
            strokes.append(np.asarray(radical, np.float32))
            return self._scripts(
                _Box(strokes, tick_w + body.w + 0.16 * size,
                     top, body.desc + 0.05 * size), size, False)
        if tok in ("\\sum", "\\int", "\\prod"):
            big = 1.75 if tok == "\\int" else 1.55
            base = _glyph_box(tok, big * size, rng, jit,
                              self.native)
            # recenter the tall glyph on the math axis
            shift_y = 0.28 * size
            base = _Box(_shift(base, 0.0, shift_y), base.w,
                        base.asc + shift_y, base.desc + shift_y)
            return self._scripts(base, size, over_under=(tok != "\\int"))
        if tok == "\\lim":  # word glyphs with under-script limits
            boxes = [_glyph_box(c, size, rng, jit, self.native)
                     for c in "lim"]
            return self._scripts(_hcat(boxes, 0.05 * size), size,
                                 over_under=True)
        if tok in _WORD_TOKENS:
            boxes = [_glyph_box(c, size, rng, jit, self.native)
                     for c in _WORD_TOKENS[tok]]
            return self._scripts(_hcat(boxes, 0.05 * size), size, False)
        if tok in GLYPHS:
            return self._scripts(
                _glyph_box(tok, size, rng, jit, self.native), size, False)
        # unknown token (e.g. a brace outside a group): render nothing
        return _Box([], 0.0, 0.0, 0.0)

    def parse(self, size: float) -> _Box:
        boxes = []
        while self._peek() is not None:
            if self._peek() == "}":  # stray close (malformed input)
                self._next()
                continue
            boxes.append(self._item(size))
        gap = 0.16 * size * self.gap_scale
        return _hcat(boxes, gap)


def formula_strokes(formula: str, rng: random.Random,
                    jitter: float = 1.0,
                    gap_scale: float = 1.0,
                    native: bool = False) -> List[np.ndarray]:
    """Lay out ``formula`` (space-separated LaTeX tokens) structurally and
    return jittered strokes in layout coordinates. ``native``: glyph
    strokes come back as ``_GlyphEntry`` display-list items (mixed with
    materialized polylines for bars/radicals/delimiters)."""
    box = _Parser(formula.split(), rng, jitter, gap_scale,
                  native=native).parse(1.0)
    return box.strokes


def _handwrite(strokes: List[np.ndarray], rng: random.Random,
               jitter: float = 1.0) -> List[np.ndarray]:
    """Global handwriting distortions: slant, rotation, baseline wander."""
    if not strokes:
        return strokes
    allpts = np.concatenate(strokes, axis=0)
    x0, x1 = float(allpts[:, 0].min()), float(allpts[:, 0].max())
    span = max(x1 - x0, 1e-6)
    shear = rng.gauss(0.0, 0.16 * jitter)
    rot = rng.gauss(0.0, 0.03 * jitter)
    amp = abs(rng.gauss(0.0, 0.10 * jitter))
    lam = rng.uniform(0.8, 3.0) * span
    phase = rng.uniform(0, 2 * math.pi)
    drift = rng.gauss(0.0, 0.06 * jitter) / span
    cr, sr = math.cos(rot), math.sin(rot)
    out = []
    for st in strokes:
        x = st[:, 0].astype(np.float64)
        y = st[:, 1].astype(np.float64)
        y = y + amp * np.sin(2 * math.pi * (x - x0) / lam + phase) \
            + drift * (x - x0) ** 2 / span
        x = x - shear * y
        xr = x * cr - y * sr
        yr = x * sr + y * cr
        out.append(np.stack([xr, yr], axis=1).astype(np.float32))
    return out


def render_stroke_image(formula: str, rng: np.random.Generator,
                        img_h: int = 96, img_w: int = 320,
                        jitter: float = 1.0,
                        degrade: float = 0.0) -> np.ndarray:
    """Handwriting-style render of ``formula``: structural layout, jittered
    polyline glyphs, InkML rasterization path, paper/ink contrast noise.
    Returns uint8 (img_h, img_w), dark ink on light paper.

    ``degrade`` in [0, 1]: the MathWriting-difficulty ink-degradation
    knob — denser layout (random gap shrink down to touching glyphs),
    occasional dropped strokes (pen skips), box blur (scanner/camera
    softness), and stronger sensor noise / contrast collapse."""
    prng = random.Random(int(rng.integers(0, 2 ** 63)))
    gap_scale = 1.0
    if degrade > 0:
        gap_scale = 1.0 - degrade * prng.uniform(0.2, 0.7)
    strokes = formula_strokes(formula, prng, jitter, gap_scale=gap_scale)
    if degrade > 0 and len(strokes) > 6 and prng.random() < 0.5 * degrade:
        # pen skips: drop 1-2 random strokes
        for _ in range(prng.randint(1, 2)):
            strokes.pop(prng.randrange(len(strokes)))
    strokes = _handwrite(strokes, prng, jitter)
    ink = Ink(strokes=strokes, label=formula)
    thickness = int(rng.integers(1, 4))
    margin = int(rng.integers(3, 14))
    img = rasterize(ink, img_h=img_h, img_w=img_w, margin=margin,
                    thickness=thickness)
    # paper/ink contrast + sensor noise (same regime as the typeset
    # corpus renderer, synthetic.render_corpus_image)
    bg = int(rng.integers(228, 256))
    ink_level = int(rng.integers(0, 50))
    arr = np.asarray(img, np.float32) / 255.0
    arr = ink_level + arr * (bg - ink_level)
    if degrade > 0:
        if rng.random() < 0.7 * degrade:  # contrast collapse (faint ink)
            mid = arr.mean()
            arr = mid + (arr - mid) * float(rng.uniform(0.45, 0.9))
        if rng.random() < 0.6 * degrade:  # camera/scanner softness
            k = 3
            pad = np.pad(arr, k // 2, mode="edge")
            sl = sum(pad[i:i + arr.shape[0], j:j + arr.shape[1]]
                     for i in range(k) for j in range(k))
            arr = sl / (k * k)
    noise_hi = 6.0 + 8.0 * degrade
    arr += rng.normal(0.0, float(rng.uniform(1.0, noise_hi)), arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Native (C++) render path
# ---------------------------------------------------------------------------

_NATIVE_GLYPH_IDS: Optional[Dict[str, int]] = None
_NATIVE_GLYPH_LOCK = threading.Lock()


def _ensure_native_glyphs() -> Dict[str, int]:
    """Register the GLYPHS templates with the native renderer (once per
    process, under a lock: a loader's threads render at once) and return
    the token->glyph-id map."""
    global _NATIVE_GLYPH_IDS
    if _NATIVE_GLYPH_IDS is not None:
        return _NATIVE_GLYPH_IDS
    with _NATIVE_GLYPH_LOCK:
        if _NATIVE_GLYPH_IDS is None:
            _NATIVE_GLYPH_IDS = _register_native_glyphs()
    return _NATIVE_GLYPH_IDS


def _register_native_glyphs() -> Dict[str, int]:
    from .. import native

    toks = sorted(GLYPHS)
    pts: List[np.ndarray] = []
    s_off = [0]
    g_off = [0]
    for t in toks:
        _w, strokes = GLYPHS[t]
        for st in strokes:
            a = np.asarray(st, np.float32)
            pts.append(a)
            s_off.append(s_off[-1] + len(a))
        g_off.append(g_off[-1] + len(strokes))
    native.register_glyphs(np.concatenate(pts, axis=0),
                           np.asarray(s_off, np.int64),
                           np.asarray(g_off, np.int64))
    return {t: i for i, t in enumerate(toks)}


def render_stroke_image_native(formula: str, rng: np.random.Generator,
                               img_h: int = 96, img_w: int = 320,
                               jitter: float = 1.0,
                               degrade: float = 0.0) -> np.ndarray:
    """C++ path of :func:`render_stroke_image` (same distribution,
    different RNG stream): Python keeps every layout decision and every
    distribution-shaping draw; the per-point work (template expansion
    with wobble, the handwriting field, AA rasterization, degradations)
    runs in ``native/src/stroke_render.cpp``. Raises ``RuntimeError`` when
    the library cannot be built (JAX falls back to Python there)."""
    from .. import native

    native.library()  # builds it at first use, or raises
    ids = _ensure_native_glyphs()
    prng = random.Random(int(rng.integers(0, 2 ** 63)))
    gap_scale = 1.0
    if degrade > 0:
        gap_scale = 1.0 - degrade * prng.uniform(0.2, 0.7)
    entries = formula_strokes(formula, prng, jitter, gap_scale=gap_scale,
                              native=True)
    g_items = [e for e in entries if isinstance(e, _GlyphEntry)]
    inline = [np.asarray(e, np.float32) for e in entries
              if not isinstance(e, _GlyphEntry)]

    # pen skips, mirroring render_stroke_image's pop loop over the
    # combined stroke list (glyph template strokes first, then inline)
    n_total = (sum(len(GLYPHS[e.tok][1]) for e in g_items) + len(inline))
    drops: List[int] = []
    if degrade > 0 and n_total > 6 and prng.random() < 0.5 * degrade:
        cur = n_total
        for _ in range(prng.randint(1, 2)):
            drops.append(prng.randrange(cur))
            cur -= 1

    # global handwriting field (the _handwrite draws, same order);
    # span-dependent factors (lam, drift) are resolved in C++
    shear = prng.gauss(0.0, 0.16 * jitter)
    rot = prng.gauss(0.0, 0.03 * jitter)
    amp = abs(prng.gauss(0.0, 0.10 * jitter))
    lam_u = prng.uniform(0.8, 3.0)
    phase = prng.uniform(0, 2 * math.pi)
    drift_g = prng.gauss(0.0, 0.06 * jitter)

    thickness = int(rng.integers(1, 4))
    margin = int(rng.integers(3, 14))
    bg = int(rng.integers(228, 256))
    ink_level = int(rng.integers(0, 50))
    contrast = -1.0
    blur = 0.0
    if degrade > 0:
        if rng.random() < 0.7 * degrade:
            contrast = float(rng.uniform(0.45, 0.9))
        if rng.random() < 0.6 * degrade:
            blur = 1.0
    noise_hi = 6.0 + 8.0 * degrade
    sigma = float(rng.uniform(1.0, noise_hi))
    noise_seed = int(rng.integers(0, 2 ** 63))

    params = np.array([shear, rot, amp, lam_u, phase, drift_g,
                       margin, thickness, bg, ink_level, contrast, blur,
                       sigma, 0.0], np.float64)
    g_ids = np.asarray([ids[e.tok] for e in g_items], np.int32)
    g_aff = np.asarray([[e.dx, e.dy, e.size, e.rot, e.sx, e.sy, e.noise]
                        for e in g_items], np.float64).reshape(-1, 7)
    g_seed = np.asarray([e.seed for e in g_items], np.uint64)
    g_width = np.asarray([GLYPHS[e.tok][0] for e in g_items], np.float64)
    in_off = np.zeros(len(inline) + 1, np.int64)
    for i, st in enumerate(inline):
        in_off[i + 1] = in_off[i] + len(st)
    in_pts = (np.concatenate(inline, axis=0)
              if inline else np.zeros((0, 2), np.float32))
    return native.render_formula(g_ids, g_aff, g_seed, g_width, in_pts,
                                 in_off, np.asarray(drops, np.int64),
                                 params, noise_seed, img_h, img_w)


# ---------------------------------------------------------------------------
# Dataset plumbing (mirrors synthetic.SyntheticStreamDataset / make_corpus)
# ---------------------------------------------------------------------------


def stroke_vocab(rich: bool = False, envs: bool = False) -> dict:
    """Token inventory (identical to synthetic.grammar_vocab: the stroke
    renderer consumes the same structured_formula grammar)."""
    from .synthetic import grammar_vocab

    return grammar_vocab(rich=rich, envs=envs)


class StrokeStreamDataset:
    """Infinite-variety streaming corpus of handwriting-style renders.

    Same interface as SyntheticStreamDataset (len/getitem/set_epoch +
    img_h/img_w/max_seq_len attrs), same formula distribution, different
    pixels: structural stroke layout instead of literal typeset source."""

    def __init__(self, tokenizer, samples_per_epoch: int, img_h: int = 96,
                 img_w: int = 320, max_seq_len: int = 150, seed: int = 0,
                 max_tokens: int = 28, freeze: bool = False,
                 jitter: float = 1.0, rich: bool = False,
                 max_terms: int = 5, depth: int = 2,
                 degrade: float = 0.0, envs: bool = False,
                 native: bool = False):
        from .synthetic import SyntheticStreamDataset

        self._inner = SyntheticStreamDataset(
            tokenizer, samples_per_epoch, img_h, img_w, max_seq_len,
            seed=seed, max_tokens=max_tokens, freeze=freeze, rich=rich,
            max_terms=max_terms, depth=depth, envs=envs)
        self.tokenizer = tokenizer
        self.img_h, self.img_w = img_h, img_w
        self.max_seq_len = max_seq_len
        self.jitter = jitter
        self.degrade = degrade
        self.native = native

    def set_epoch(self, epoch: int) -> None:
        self._inner.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self._inner)

    def formula_at(self, idx: int) -> str:
        return self._inner.formula_at(idx)

    def __getitem__(self, idx: int):
        formula = self._inner.formula_at(idx)
        nrng = np.random.default_rng(
            self._inner._sample_key(idx) ^ 0x33CC33CC)
        render = (render_stroke_image_native if self.native
                  else render_stroke_image)
        img = render(formula, nrng, self.img_h, self.img_w,
                     jitter=self.jitter, degrade=self.degrade)
        ids = self.tokenizer.encode(formula, max_len=self.max_seq_len)
        length = min(len(self.tokenizer.encode(formula)), self.max_seq_len)
        return img, np.asarray(ids, np.int32), length


def make_stroke_corpus(root: str, n_train: int = 20000, n_val: int = 1000,
                       n_test: int = 1000, img_h: int = 96,
                       img_w: int = 320, seed: int = 0,
                       jitter: float = 1.0, rich: bool = False,
                       max_tokens: int = 28, max_terms: int = 5,
                       depth: int = 2, degrade: float = 0.0,
                       envs: bool = False) -> str:
    """Materialized handwriting-style corpus in the reference data contract
    ({split}_formulas/*.png + {split}_labels.csv; data/README.md), written
    with PIL and the ``csv`` module: the same pixels and rows as JAX's.

    ``rich``/``max_tokens``/``max_terms``/``depth``/``degrade``: the
    MathWriting-difficulty regime (see structured_formula and
    render_stroke_image)."""
    import os

    from .synthetic import _write_labels, _write_png, structured_formula

    prng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    seen = set()

    def fresh_formula() -> str:
        while True:
            f = structured_formula(prng, max_terms=max_terms, depth=depth,
                                   rich=rich, envs=envs)
            if len(f.split()) > max_tokens or f in seen:
                continue
            seen.add(f)
            return f

    for split, count in (("train", n_train), ("validate", n_val),
                         ("test", n_test)):
        img_dir = os.path.join(root, f"{split}_formulas")
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(count):
            formula = fresh_formula()
            name = f"{split}_{i:06d}.png"
            _write_png(os.path.join(img_dir, name),
                       render_stroke_image(formula, nrng, img_h, img_w,
                                           jitter=jitter, degrade=degrade))
            rows.append((name, formula))
        _write_labels(os.path.join(root, f"{split}_labels.csv"), rows)
    return root

"""InkML stroke parsing and rasterization to training PNGs.

The port of ``handwritten_math_ocr_api_tpu/data/inkml.py``: parse
MathWriting InkML (trace points ``x y [t]``, annotations ``label`` /
``normalizedLabel``), fit the strokes to the target canvas keeping their
aspect ratio, and draw them as cv2's anti-aliased polylines and circles
(black ink on white), so that the pixels equal the JAX package's.
``render_inkml_dir`` writes the PNGs with cv2 and the labels CSV with the
``csv`` module (the rows of JAX's pandas CSV).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_NS = "{http://www.w3.org/2003/InkML}"


@dataclass
class Ink:
    strokes: List[np.ndarray]  # each (N, 2) float32 x,y
    label: str = ""
    normalized_label: str = ""

    @property
    def best_label(self) -> str:
        return self.normalized_label or self.label


def parse_inkml(path_or_string: str) -> Ink:
    """Parse an InkML file (or XML string) into strokes + labels."""
    if os.path.exists(path_or_string):
        root = ET.parse(path_or_string).getroot()
    else:
        root = ET.fromstring(path_or_string)

    label = normalized = ""
    for ann in root.iter(f"{_NS}annotation"):
        kind = ann.get("type", "")
        if kind == "normalizedLabel":
            normalized = (ann.text or "").strip()
        elif kind == "label":
            label = (ann.text or "").strip()

    strokes = []
    for trace in root.iter(f"{_NS}trace"):
        pts = []
        for token in (trace.text or "").split(","):
            token = token.strip()
            if not token:
                continue
            coords = token.split()
            if len(coords) >= 2:
                pts.append((float(coords[0]), float(coords[1])))
        if pts:
            strokes.append(np.asarray(pts, np.float32))
    return Ink(strokes=strokes, label=label, normalized_label=normalized)


def rasterize(ink: Ink, img_h: int = 96, img_w: int = 320,
              margin: int = 4, thickness: int = 2) -> np.ndarray:
    """Render strokes to a uint8 grayscale image: black ink on white.

    Aspect-preserving fit into (img_w - 2*margin, img_h - 2*margin),
    centered. Degenerate inks (no points / zero extent) render blank.
    """
    import cv2

    canvas = np.full((img_h, img_w), 255, np.uint8)
    if not ink.strokes:
        return canvas
    allpts = np.concatenate(ink.strokes, axis=0)
    mn = allpts.min(axis=0)
    mx = allpts.max(axis=0)
    extent = np.maximum(mx - mn, 1e-6)
    avail_w = img_w - 2 * margin
    avail_h = img_h - 2 * margin
    s = min(avail_w / extent[0], avail_h / extent[1])
    # center the drawing
    off_x = (img_w - extent[0] * s) / 2.0
    off_y = (img_h - extent[1] * s) / 2.0
    for stroke in ink.strokes:
        pts = (stroke - mn) * s + np.array([off_x, off_y])
        pts_i = np.round(pts).astype(np.int32)
        if len(pts_i) == 1:
            cv2.circle(canvas, tuple(pts_i[0]), max(thickness // 2, 1), 0, -1,
                       lineType=cv2.LINE_AA)
        else:
            cv2.polylines(canvas, [pts_i.reshape(-1, 1, 2)], False, 0,
                          thickness=thickness, lineType=cv2.LINE_AA)
    return canvas


def render_inkml_dir(inkml_dir: str, out_img_dir: str, out_csv: str,
                     img_h: int = 96, img_w: int = 320,
                     limit: Optional[int] = None) -> int:
    """Batch-render a directory of .inkml files into PNGs + labels CSV in
    the reference data contract (image_filename, latex_label)."""
    import cv2

    from .synthetic import _write_labels

    os.makedirs(out_img_dir, exist_ok=True)
    rows = []
    files = sorted(f for f in os.listdir(inkml_dir) if f.endswith(".inkml"))
    if limit:
        files = files[:limit]
    for fname in files:
        ink = parse_inkml(os.path.join(inkml_dir, fname))
        img = rasterize(ink, img_h, img_w)
        out_name = fname[:-len(".inkml")] + ".png"
        cv2.imwrite(os.path.join(out_img_dir, out_name), img)
        rows.append((out_name, ink.best_label))
    _write_labels(out_csv, rows)
    return len(rows)

"""The test split's images, preprocessed once into a cache in the checkout.

The preprocessing is a frozen copy of the port's
(``handwritten_math_ocr_api_torch/data/preprocess.py`` at commit
e13765f3a37352e31b622845f2ae26a6960b06e8): grayscale uint8, stretch-resized
to the model's size with cv2's bilinear resize, the identity where an image
is at that size already (every image of ``data_eval_hard``'s test split is
96 x 320). The uint8 images are handed to the program and to the reference
alike; the reference normalizes them itself (``x / 255 * 2 - 1``).
"""

from __future__ import annotations

import csv
import os
from typing import List

import numpy as np

from . import frozen_png
from .manifest import REPO_ROOT

CACHE_DIR = os.path.join(REPO_ROOT, ".port_bench_cache")


def stretch(img: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    if img.shape == (img_h, img_w):
        return img
    import cv2

    return cv2.resize(img, (img_w, img_h))


def split_files(split_dir: str, split: str = "test") -> List[str]:
    """The split's image paths in the label file's order."""
    with open(os.path.join(split_dir, f"{split}_labels.csv"),
              newline="") as f:
        names = [row["image_filename"] for row in csv.DictReader(f)]
    return [os.path.join(split_dir, f"{split}_formulas", n) for n in names]


def load_u8(split_dir: str, img_h: int, img_w: int) -> np.ndarray:
    """(N, H, W) uint8 images of the split, from the cache when it holds
    them (a fixed file in the checkout: only a checkout's first run decodes
    the PNGs)."""
    rel = os.path.relpath(os.path.abspath(split_dir), REPO_ROOT)
    tag = rel.replace(os.sep, "_").replace(".", "_")
    path = os.path.join(CACHE_DIR, f"{tag}_{img_h}x{img_w}.npy")
    files = split_files(split_dir)
    if os.path.exists(path):
        arr = np.load(path)
        if arr.shape == (len(files), img_h, img_w):
            return arr
    arr = np.stack([stretch(frozen_png.read_png(p), img_h, img_w)
                    for p in files])
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.partial"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)
    return arr
